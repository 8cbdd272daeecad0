"""gen_rows_per_s: rows returned to the host as numpy arrays in the
window, over the window's wall time."""


def read(record):
    rows = sum(w.get("rows", 0) for w in record["work"])
    return rows / record["window_s"] if rows else None
