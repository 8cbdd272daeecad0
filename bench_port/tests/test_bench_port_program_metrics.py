"""The per-layer metrics that read the program's own spans and counts
(`harness/program_spans.py`): each against spans recorded by the
program's recorder under the profiler on the CPU, against spans given
by hand, and None where the program recorded nothing or has no spans."""

import pytest
from torch.profiler import ProfilerActivity, profile

from bench_port.harness import program_spans, spec
from cvaegan_tpu_torch.utils import profiling

METRICS = ("graph_nodes_per_step", "draw_nodes_per_step", "fit_host_ms_per_call",
           "gen_copy_share")
GRAPH = {"kernel": 100, "by_phase": {"step.draw": 30, "step.d": 50, "rest": 20},
         "memset": 0, "memcpy": 2, "other": 0}


def _read(name):
    return spec.load_module(spec.metric_path(name), f"bench_metric_{name}").read(
        {"trace": None, "work": []})


@pytest.fixture(autouse=True)
def _clean():
    profiling.reset()
    yield
    profiling.reset()


def _span(name, parent, start, end, call, **attrs):
    return profiling.Span(name, parent, start, end, attrs, call)


def test_every_metric_is_declared():
    per_layer = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name in METRICS:
        assert per_layer[name]["source"] in ("program_span", "program_counter")
        assert spec.metric_path(name).is_file()


@pytest.mark.parametrize("name", METRICS)
def test_none_without_spans(name, monkeypatch):
    assert _read(name) is None  # nothing recorded
    monkeypatch.delattr(profiling, "spans")  # a program without spans
    assert program_spans.recorded() == []
    assert _read(name) is None


def test_recorded_training_calls():
    """Two `fit` calls recorded by the program's recorder: nodes per step
    from the graph's counts, host time outside `fit.epochs`."""
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with profiling.span("fit"):
                with profiling.span("fit.prepare", rows=10):
                    pass
                with profiling.span("fit.epochs", epochs=3, steps=30, graph_nodes=GRAPH):
                    sum(range(20000))
                with profiling.span("fit.chunk_end"):
                    pass
    assert _read("graph_nodes_per_step") == pytest.approx(10.2)  # memcpy nodes too
    assert _read("draw_nodes_per_step") == pytest.approx(3.0)
    spans = profiling.spans()
    host = [spans[i].end_ns - spans[i].start_ns - (spans[i + 2].end_ns - spans[i + 2].start_ns)
            for i, s in enumerate(spans) if s.name == "fit"]
    assert _read("fit_host_ms_per_call") == pytest.approx(sum(host) / 2 / 1e6)
    assert _read("gen_copy_share") is None


def test_hand_spans(monkeypatch):
    """A bank call whose epochs replayed no graph (the plain path) reads no
    nodes; a bank call's host time counts every child but `fit.epochs`;
    the copy's share sums over calls."""
    spans = [
        _span("bank.fit", None, 0, 10_000_000, 0),
        _span("bank.load", 0, 1_000_000, 2_000_000, 0),
        _span("fit.epochs", 0, 2_000_000, 9_000_000, 0, epochs=2, steps=8),
        _span("gen.fast", None, 20_000_000, 24_000_000, 3, rows=5),
        _span("gen.copy", 3, 22_000_000, 23_000_000, 3, bytes=20),
        _span("gen.fast", None, 30_000_000, 36_000_000, 5, rows=5),
        _span("gen.copy", 5, 32_000_000, 35_000_000, 5, bytes=20),
    ]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert _read("graph_nodes_per_step") is None
    assert _read("draw_nodes_per_step") is None
    assert _read("fit_host_ms_per_call") == pytest.approx(3.0)
    assert _read("gen_copy_share") == pytest.approx(100.0 * 4 / 10)
    spans[2] = _span("fit.epochs", 0, 2_000_000, 9_000_000, 0, epochs=2, steps=8,
                     graph_nodes={**GRAPH, "by_phase": {"rest": 100}})
    assert _read("graph_nodes_per_step") == pytest.approx(25.5)
    assert _read("draw_nodes_per_step") == 0.0
