"""device_ops_per_step: kernels on the device in the traced window (copies
and sets left out) over the optimizer steps of the traced calls."""


def read(record):
    trace = record["trace"]
    steps = sum(w.get("steps", 0) for w in record["work"])
    if trace is None or not steps or not trace["kernels"]:
        return None
    return trace["kernels"] / steps
