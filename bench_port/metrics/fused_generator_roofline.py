"""fused_generator_roofline: the generator forward's least time over the
device time that computes it, as a percentage.

The least time of a call is the larger of its FLOPs over the dense TF32
rate and its bytes over HBM's (`counts/<config>.py`: latents, labels and
weights read once, rows written once). The time is that of every kernel
of the traced calls but the latent draw (torch's normal-distribution
kernel) and the copies and sets: whatever kernel computes the forward
is read the same way."""

from bench_port.harness import peaks

DRAW_MARKS = ("normal", "distribution_elementwise")


def read(record):
    trace = record["trace"]
    rows = [w["rows"] for w in record["work"] if w.get("rows")]
    if trace is None or not rows:
        return None
    busy = sum(t for name, t in trace["time_by_name"].items()
               if not name.startswith(("Memcpy", "Memset"))
               and not any(m in name for m in DRAW_MARKS))
    if not busy:
        return None
    bound = 0.0
    for n in rows:
        flops, nbytes = record["counts"].generator_forward(record["cfg"], n)
        bound += max(flops / peaks.TF32_FLOPS, nbytes / peaks.HBM_BYTES)
    return 100.0 * bound / busy
