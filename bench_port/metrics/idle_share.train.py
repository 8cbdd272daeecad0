"""idle_share.train: the percentage of the traced window in which no
kernel, copy or set runs on the device (the union of the device's
intervals; `harness/trace.py`)."""


def read(record):
    trace = record["trace"]
    if trace is None or not trace["busy_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
