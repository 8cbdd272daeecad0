#!/usr/bin/env python3
"""The readings that the RAIN-GAN cell's limits are set from
(`bench_port/limits/raingan.fit.strict.json`), beside the TF32 control's
and the half-batch fault's.

    python3 experiments/torch_port_rain_check_readings.py --seeds 16 \\
        --first 2601001003 [--calls 2] [--frames N] [--device cuda]

For each seed it runs the cell's driver (`bench_port/drivers/rain_fit.py`)
as a run does, with `--calls` window calls in place of a timed window,
and prints one JSON line: the program's numbers as the check reads them
(`check`: each the worst checked class's), then, for each class's round
from the seed's weights, the program's (`program_<c>`), the reference's
with every product in TF32 (`control_<c>`) and the reference's with each
loss over half of its rows (`half_batch_<c>`), each against the plain
reference. `bench_port/control.py` prints the last class's alone.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from bench_port.harness import spec  # noqa: E402
from bench_port.reference import nets  # noqa: E402

CELL = "raingan.fit.strict"


def _values(numbers: dict) -> dict:
    """Each number's value, and its worst and median leaf by network
    where it has them."""
    return {k: [v["value"], v["by_net"]] if "by_net" in v else v["value"]
            for k, v in numbers.items()}


def readings(driver, calls: int) -> dict:
    driver.setup()
    for _ in range(calls):
        driver.call()
    driver.release()
    out = {"check": _values(driver.check())}
    for c, got in driver.prog.items():
        ref = driver.reference(c=c)
        with nets.tf32_products():
            ctl = driver.reference(c=c)
        half = driver.reference(half_batch=True, c=c)
        out[f"program_{c}"] = _values(driver.compare(got, ref))
        out[f"control_{c}"] = _values(driver.compare(ctl, ref))
        out[f"half_batch_{c}"] = _values(driver.compare(half, ref))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seeds", type=int, default=16)
    p.add_argument("--first", type=int, default=2601001003)
    p.add_argument("--calls", type=int, default=2, help="window calls before the check")
    p.add_argument("--frames", type=int, default=None, help="fewer frames, for the CPU")
    p.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = spec.cell(CELL)
    module = spec.load_module(c["driver_path"], "bench_driver")
    traffic = dict(c["traffic"])
    if args.frames:
        traffic.update(frames=args.frames, epochs_per_call=1)
    for i in range(args.seeds):
        seed = args.first + 7919 * i
        t0 = time.time()
        driver = module.Driver({"cfg": c["cfg"], "traffic": traffic, "seed": seed,
                                "device": torch.device(args.device), "cell": CELL,
                                "limits": c["limits"]})
        out = readings(driver, args.calls)
        print(json.dumps({"seed": seed, "seconds": round(time.time() - t0, 1), **out}),
              flush=True)
        del driver
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
