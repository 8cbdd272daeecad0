"""One run of one cell, in the worker process that `run.py` starts under a
deadline: set-up, the timed window (or, with `--trace 1`, the traced
calls), the program freed, the comparison with the plain reference, and
the result as the last line of standard output.

Everything the program or this process prints goes to standard error;
the numbers compared, each beside its limit, are its last lines there.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
import traceback

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_port.harness import spec  # noqa: E402

#: exit codes of a run that prints no result
NO_CARD, FORBIDDEN_MODULES = 3, 4
#: top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "cvaegan_tpu")


def forbidden_modules():
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args, out, device=None) -> int:
    """One run; `device` is given only by the harness's own tests, which
    drive a run on the CPU past the look for a card."""
    import torch

    c = spec.cell(args.workload)
    chips = int(c["workload"]["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"no result: this cell needs {chips} CUDA device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return NO_CARD
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        kind = torch.cuda.get_device_name(device)
    else:
        device = torch.device(device)
        kind = str(device)
    # the configuration's float32: products in float32, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one host thread: no pool of the process's own spins beside the
    # thread that feeds the card
    torch.set_num_threads(1)
    state = {"attempted": 0, "failed": 0,
             "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                        "kind": kind, "count": chips}}
    ctx = {"cfg": c["cfg"], "traffic": c["traffic"], "seed": args.seed, "device": device,
           "cell": c["name"], "limits": c["limits"]}
    driver = spec.load_module(c["driver_path"], f"bench_driver_{c['traffic']['driver']}")
    driver = driver.Driver(ctx)
    counts = spec.load_module(c["counts_path"], "bench_counts")
    driver.setup()
    _sync(device)
    record = {"cell": c["name"], "cfg": c["cfg"], "traffic": c["traffic"], "counts": counts,
              "setup_s": time.time() - args.t0, "work": [], "call_s": [], "trace": None}
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from bench_port.harness import trace

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(int(c["traffic"]["trace_calls"])):
                with record_function(driver.span):
                    t1 = time.perf_counter()
                    record["work"].append(driver.call())
                    record["call_s"].append(time.perf_counter() - t1)
            _sync(device)
        record["trace"] = trace.summarize(prof, [driver.span])
        record["window_s"] = record["trace"]["window_s"]
        del prof
    else:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            t1 = time.perf_counter()
            record["work"].append(driver.call())
            record["call_s"].append(time.perf_counter() - t1)
        _sync(device)
        record["window_s"] = time.perf_counter() - t0
    calls = sorted(record["call_s"])
    if calls:
        print(f"calls: {len(calls)}, seconds each: first {record['call_s'][0]!r}, "
              f"min {calls[0]!r}, median {calls[len(calls) // 2]!r}, max {calls[-1]!r}",
              file=sys.stderr)
    state["attempted"] = len(record["work"])
    state["failed"] = int(sum(w.get("failed", 0) for w in record["work"]))
    bad = forbidden_modules()
    if bad:
        print(f"no result: loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return FORBIDDEN_MODULES
    state["device"]["memory_peak_bytes"] = (
        int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0)
    if record["trace"] is not None:
        state["device"]["busy_s"] = record["trace"]["busy_s"]
        state["device"]["window_s"] = record["trace"]["window_s"]
    driver.release()
    gc.collect()
    checks = driver.check()
    metrics = {}
    for m in spec.metrics(c["name"], bool(args.trace)):
        reader = spec.load_module(spec.metric_path(m["name"]), "bench_metric")
        value = reader.read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    limits = c["limits"].get("limits", {})
    compared = {}
    correct = state["failed"] == 0 and bool(limits)
    for name, got in checks.items():
        detail = {k: v for k, v in got.items() if k != "value"}
        print(f"reading {name}: {got['value']!r} {detail}", file=sys.stderr)
    for name, limit in limits.items():
        value = checks[name]["value"]
        compared[name] = {"value": value, "limit": limit}
        correct = correct and value <= limit
    result = {"correct": bool(correct), "attempted": state["attempted"],
              "failed": state["failed"], "metrics": metrics, "device": state["device"]}
    if record["trace"] is not None:
        result["breakdown"] = record["trace"]["breakdown"]
    result["compared"] = compared
    for name, v in compared.items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--t0", type=float, default=None,
                   help="host time at which the run started (run.py's start)")
    args = p.parse_args(argv)
    if args.t0 is None:
        args.t0 = time.time()
    out = sys.stdout
    sys.stdout = sys.stderr  # what the program prints stays off the result's stream
    try:
        return run(args, out)
    except Exception:  # the run's boundary: report the failure as a result
        traceback.print_exc()
        print(json.dumps({"correct": False, "attempted": 0, "failed": 0, "metrics": {},
                          "device": {"platform": "gpu", "kind": "unknown", "count": 0,
                                     "memory_peak_bytes": 0},
                          "error": traceback.format_exc(limit=3).splitlines()[-1]}),
              file=out, flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
