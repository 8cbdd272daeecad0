"""mfu.train: the matmul FLOPs of the traced calls' epochs
(`counts/<config>.py`, counted once) over the traced window's wall time,
as a percentage of the H100's dense TF32 rate."""

from bench_port.harness import peaks


def read(record):
    trace = record["trace"]
    epochs = sum(w.get("epochs", 0) for w in record["work"])
    if trace is None or not epochs or not trace["busy_s"]:
        return None
    flops = epochs * record["counts"].epoch_flops(record["cfg"])
    return 100.0 * flops / trace["window_s"] / peaks.TF32_FLOPS
