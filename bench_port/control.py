#!/usr/bin/env python3
"""The controls of a cell's comparison, on the card at the cell's own size.

    python3 bench_port/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the cell's inputs as a run does, computes the
plain reference in float32 with TF32 off, and prints one JSON line with
the cell's numbers (`drivers/<driver>.py::compare`, and a training
cell's `compare_window` from the state the reference reaches in set-up)
for each stand-in put in the program's place:

- `control`: the reference with every product in TF32, the precision one
  step below the configuration's float32: both operands of each product,
  forward and backward, rounded to TF32's 10-bit mantissa, the sums in
  float32 (`reference/nets.py::tf32_products`), every product alike
  whatever cuBLAS would choose under its own TF32 mode (`allow_tf32`);
- training cells, `half_batch`: the reference with each loss the mean
  over the first half of its rows (a planted fault);
- generation cells, `altered`: one kept call's rows made for another
  class (a planted fault).

A state left unchanged reads 1 on every gap of a norm, and moves no step
count, and needs no run. The limits in `limits/<cell>.json` lie above
the program's own readings (from the cell's runs) and below the
control's or the faults' readings, which every cell's fail in at least
one number (`PERF.md` §2).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from bench_port.harness import spec  # noqa: E402
from bench_port.reference import nets  # noqa: E402


def _values(numbers: dict) -> dict:
    return {k: v["value"] for k, v in numbers.items()}


def fit_controls(driver) -> dict:
    """Set-up's numbers of each stand-in from the seed's weights, and the
    window's loss number from the state the reference reaches in set-up
    (a window starts from the program's state after more epochs)."""
    driver.make_inputs()
    ref = driver.reference()
    with nets.tf32_products():
        ctl = driver.reference()
    half = driver.reference(half_batch=True)
    start = ref["end"]
    w_ref = driver.window_reference(start)
    with nets.tf32_products():
        w_ctl = driver.window_reference(start)
    w_half = driver.window_reference(start, half_batch=True)
    return {name: {**_values(driver.compare(got, ref)),
                   **_values(driver.compare_window(w_got["losses"], w_ref))}
            for name, got, w_got in (("control", ctl, w_ctl), ("half_batch", half, w_half))}


def generate_controls(driver, window_calls: int) -> dict:
    from bench_port.reference import generate

    driver.make_inputs()
    plan = driver.plan
    warm = len(plan)
    driver.calls = [plan[i % len(plan)] for i in range(warm + window_calls)]
    driver.failed = 0
    kept = sorted({warm + i for i in driver.keep} | {warm + window_calls - 1})
    ref = generate.replay(driver.cfg, driver.leaves0["generator"], driver.seed, driver.calls,
                          kept, driver.device)
    with nets.tf32_products():
        ctl = generate.replay(driver.cfg, driver.leaves0["generator"], driver.seed,
                              driver.calls, kept, driver.device)
    wrong = {kept[0]: (driver.calls[kept[0]][0] % (driver.cfg["label_num"] - 1)) + 1}
    alt = generate.replay(driver.cfg, driver.leaves0["generator"], driver.seed, driver.calls,
                          kept, driver.device, relabel=wrong)

    def host(rows):
        return {i: t.cpu().numpy() for i, t in rows.items()}

    return {"control": _values(driver.compare(host(ctl), ref)),
            "altered": _values(driver.compare(host(alt), ref))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--window-calls", type=int, default=800,
                   help="generation cells: the window calls whose draws precede the last")
    p.add_argument("--device", default="cuda",
                   help="cuda (the controls' readings), or cpu for a rehearsal")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("the controls run on a CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = spec.cell(args.workload)
    module = spec.load_module(c["driver_path"], "bench_driver")
    for seed in args.seeds:
        ctx = {"cfg": c["cfg"], "traffic": c["traffic"], "seed": seed,
               "device": torch.device(args.device), "cell": c["name"], "limits": c["limits"]}
        driver = module.Driver(ctx)
        if c["traffic"]["driver"] == "generate_fast":
            out = generate_controls(driver, args.window_calls)
        else:
            out = fit_controls(driver)
        print(json.dumps({"cell": c["name"], "seed": seed, **out}), flush=True)
        del driver
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
