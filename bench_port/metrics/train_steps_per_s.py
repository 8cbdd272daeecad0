"""train_steps_per_s: optimizer steps completed in the window, summed over
every replica, over the window's wall time (whole fit calls, each with
its own host work, the window ending in a device synchronise)."""


def read(record):
    steps = sum(w.get("steps", 0) for w in record["work"])
    return steps / record["window_s"] if steps else None
