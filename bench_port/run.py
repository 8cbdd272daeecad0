#!/usr/bin/env python3
"""Run one cell of the benchmark of `cvaegan_tpu_torch` once.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's pieces are found by the names in
`BENCHMARK.json` (`harness/spec.py`). The run itself happens in a worker
process (`worker.py`) under a deadline, so that a result line comes on
every path: set-up, the timed window of `--seconds` (or, with `--trace
1`, the traced calls), then the comparison with the plain reference. The
last line of standard output is the result, one JSON object with
`correct`, `attempted`, `failed`, `metrics`, `device` (and `breakdown`
when traced) and last `compared`: each number compared beside its limit,
which are also the last lines of standard error.

No result is printed, and the exit code is not 0, where the cell's CUDA
devices are missing, where JAX, Flax or the JAX package was loaded by the
time the window closed, or where the checkout holds no program. Build and
kernel caches stay inside the checkout (`bench_port/.cache/`, and the
program's own `cvaegan_tpu_torch/_build/`).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

T0 = time.time()
BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"
PROGRAM = "cvaegan_tpu_torch"
#: seconds a run may take: a cell's first run in a checkout builds the
#: program's kernels; every later one finds them built
DEADLINE_S, FIRST_DEADLINE_S = 340.0, 1150.0
NO_RESULT = {3, 4}


def _error_line(reason: str) -> str:
    return json.dumps({"correct": False, "attempted": 0, "failed": 0, "metrics": {},
                       "device": {"platform": "gpu", "kind": "unknown", "count": 0,
                                  "memory_peak_bytes": 0}, "error": reason})


def _environment() -> dict:
    env = dict(os.environ)
    env.update({
        "TORCH_EXTENSIONS_DIR": str(CACHE / "torch_extensions"),
        "TRITON_CACHE_DIR": str(CACHE / "triton"),
        "CUDA_CACHE_PATH": str(CACHE / "cuda"),
        "USE_FLAX": "0",
        "USE_JAX": "0",
        "OMP_NUM_THREADS": "1",
        "PYTHONPATH": os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p),
        "PYTHONUNBUFFERED": "1",
    })
    return env


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not (ROOT / PROGRAM / "__init__.py").is_file():
        print(f"no result: the checkout holds no {PROGRAM}", file=sys.stderr)
        return 2
    warm = CACHE / "warm" / args.workload
    deadline = DEADLINE_S if warm.exists() else FIRST_DEADLINE_S
    cmd = [sys.executable, str(BENCH / "worker.py"), "--workload", args.workload,
           "--seed", str(args.seed), "--seconds", str(args.seconds),
           "--trace", str(args.trace), "--t0", repr(T0)]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=_environment(), stdout=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=max(deadline - (time.time() - T0), 1.0))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        print(f"the run passed its deadline of {deadline:.0f} s and was stopped",
              file=sys.stderr)
        print(_error_line(f"deadline of {deadline:.0f} s"), flush=True)
        return 1
    if proc.returncode in NO_RESULT:
        return proc.returncode
    lines = [ln for ln in out.decode(errors="replace").splitlines() if ln.strip()]
    result = None
    if lines:
        try:
            result = json.loads(lines[-1])
        except json.JSONDecodeError:
            result = None
    if not isinstance(result, dict) or "correct" not in result:
        print(_error_line(f"the worker ended with code {proc.returncode} and no result"),
              flush=True)
        return 1
    print(json.dumps(result), flush=True)
    if proc.returncode == 0:
        warm.parent.mkdir(parents=True, exist_ok=True)
        warm.touch()
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
