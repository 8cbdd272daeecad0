"""BENCHMARK.json against the shape the benchmark format sets, and every name it gives
against the files of the harness."""

import json
import math
import re

import pytest

from bench_port.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"][:2] == ["python3", "bench_port/run.py"]
    assert bench["paths"] == ["bench_port"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_run_seconds_fit_the_full_check(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def _names(bench):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            yield entry["name"]
    for w in bench["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in bench["configs"]:
        yield from c["reduced"]


def test_names_and_units_are_legal(bench):
    for name in _names(bench):
        assert NAME.match(name), name
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)), group


@pytest.mark.parametrize("entry_keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}, set()),
    ("workloads", {"name", "config", "traffic", "chips", "why"}, set()),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}, {"workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}, {"workloads"}),
])
def test_entries_have_just_the_format_keys(bench, entry_keys):
    group, required, optional = entry_keys
    for entry in bench[group]:
        assert required <= set(entry) <= required | optional, entry


def test_every_cell_names_files_that_exist(bench):
    for w in bench["workloads"]:
        c = spec.cell(w["name"], bench)
        assert c["driver_path"].is_file()
        assert c["counts_path"].is_file()
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        for m in spec.metrics(w["name"], False, bench) + spec.metrics(w["name"], True, bench):
            assert spec.metric_path(m["name"]).is_file(), m["name"]
        assert c["limits"].get("limits"), f"{w['name']} has no limits"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in spec.metrics(w["name"], False, bench)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics(w["name"], True, bench)


def test_per_layer_metrics_move_a_metric_their_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert "workloads" not in moved or cell in moved["workloads"]


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert math.isfinite(m["bound"])


def test_config_files(bench):
    for c in bench["configs"]:
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert cfg["compute_dtype"] == "float32"
