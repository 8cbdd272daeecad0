"""Finding a cell's pieces by the names in `BENCHMARK.json`.

A cell (`workloads[]`) names a configuration and a traffic mix. The
configuration's file is the one `BENCHMARK.json` gives; the traffic mix is
`bench_port/traffic/<traffic>.json`, which names its driver,
`bench_port/drivers/<driver>.py`; the limits of the comparison that
decides `correct` are `bench_port/limits/<cell>.json`; each metric is read
by `bench_port/metrics/<metric>.py`; a configuration's operation counts
are `bench_port/counts/<config>.py`.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
from typing import List

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: pathlib.Path):
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: pathlib.Path, name: str):
    """Import a file of the benchmark by its path (metric files carry dots
    in their names)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell(name: str, bench: dict = None) -> dict:
    """Everything a run of cell `name` reads, by name."""
    bench = bench or benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(work)}")
    w = work[name]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits_path = BENCH / "limits" / f"{name}.json"
    return {
        "name": name,
        "workload": w,
        "config_name": w["config"],
        "cfg": load_json(ROOT / config["file"]),
        "traffic": traffic,
        "limits": load_json(limits_path) if limits_path.exists() else {},
        "driver_path": BENCH / "drivers" / f"{traffic['driver']}.py",
        "counts_path": BENCH / "counts" / f"{w['config']}.py",
    }


def metrics(name: str, traced: bool, bench: dict = None) -> List[dict]:
    """The metrics a run of cell `name` reports: its end-to-end metrics
    untraced, its per-layer metrics traced (those without a `workloads`
    key where the cell reports the end-to-end metric they move)."""
    bench = bench or benchmark()
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    if not traced:
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in moves)]


def metric_path(metric: str) -> pathlib.Path:
    return BENCH / "metrics" / f"{metric}.py"
