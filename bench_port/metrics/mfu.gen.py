"""mfu.gen: the generator forward's matmul FLOPs at the traced calls' rows
(`counts/<config>.py`, counted once) over the traced window's wall time,
as a percentage of the H100's dense TF32 rate."""

from bench_port.harness import peaks


def read(record):
    trace = record["trace"]
    rows = [w["rows"] for w in record["work"] if w.get("rows")]
    if trace is None or not rows or not trace["busy_s"]:
        return None
    flops = sum(record["counts"].generator_forward(record["cfg"], n)[0] for n in rows)
    return 100.0 * flops / trace["window_s"] / peaks.TF32_FLOPS
