"""The RAIN-GAN cell's own pieces: its FLOP counts against hand counts,
its leaves against the program's, and `attention_nodes_per_step` against
spans given by hand, None where the program recorded no `net.attention`
phase (a program whose attention has no span)."""

import math

import pytest

from bench_port.harness import spec
from cvaegan_tpu_torch.utils import profiling

CFG = spec.load_json(spec.BENCH / "configs" / "raingan-carhacking.json")
GRAPH = {"kernel": 100, "by_phase": {"step.draw": 30, "net.attention": 40, "rest": 30},
         "memset": 0, "memcpy": 2, "other": 0}


def _counts():
    return spec.load_module(spec.BENCH / "counts" / "raingan-carhacking.py", "counts_rain")


def _products(first, blocks, heads):
    """(every dense product's in x out summed, the first's, the blocks'
    widths) of a projection of `first` (in, out), blocks (in, out) and
    heads (in, out)."""
    total = first[0] * first[1]
    for a, b in blocks:
        total += 4 * a * a + a * b + b * b + (a * b if a != b else 0)
    total += sum(a * b for a, b in heads)
    return total, first[0] * first[1], [a for a, _ in blocks]


def test_rain_steps_by_hand():
    b = 128
    enc = _products((15, 256), [(256, 256), (256, 128)], [(128, 128), (128, 128)])
    gen = _products((133, 256), [(256, 256), (256, 128), (128, 64)], [(64, 10)])
    dis = _products((15, 256), [(256, 256), (256, 128)], [(128, 1)])
    clf = _products((10, 256), [(256, 256), (256, 128)], [(128, 5)])
    # the critic's spectral layers: projection, feed-forwards, shortcut, head
    spectral = 6 * (15 * 256 + 2 * 256 * 256 + 256 * 128 + 128 * 128 + 256 * 128 + 128)

    def fwd(net, rows, power=0):
        total, _, widths = net
        return 2 * rows * total + 4 * rows * sum(widths) + power

    def bwd(net, rows, weights, inputs):
        total, first, widths = net
        out = 8 * rows * sum(widths) + 2 * rows * (total - first)
        out += 2 * rows * total if weights else 0
        out += 2 * rows * first if inputs else 0
        return out

    d = fwd(gen, b) + fwd(dis, 2 * b, spectral) + bwd(dis, 2 * b, True, False)
    c = fwd(gen, b) + fwd(clf, 2 * b) + bwd(clf, 2 * b, True, False)
    g = (fwd(enc, b) + 2 * fwd(gen, b) + fwd(dis, b, spectral) + fwd(clf, b)
         + bwd(dis, b, False, True) + bwd(clf, b, False, True)
         + bwd(gen, b, True, True) + bwd(gen, b, True, False) + bwd(enc, b, True, False))
    counts = _counts()
    assert counts.step_flops(CFG) == {"d": d, "c": c, "g": g}
    assert counts.epoch_flops(CFG) == 5 * (5 * d + 5 * c + 3 * g)
    assert not hasattr(counts, "generator_forward")


def test_leaves_are_the_programs():
    """3,137,616 parameters in 178 leaves, as the port's modules hold."""
    from bench_port.harness import program
    from bench_port.reference import nets, rain_nets
    from cvaegan_tpu_torch import RAIN_GAN

    layout = rain_nets.layout(CFG)
    params = [(n, s) for leaves in layout.values() for n, s, _ in leaves
              if not nets.is_buffer(n)]
    assert len(params) == 178
    assert sum(math.prod(s) for _, s in params) == 3_137_616
    t = RAIN_GAN(seed=1, settings=program.settings(CFG, 1), device="cpu")
    t.feature_num, t.label_num = CFG["feature_num"], CFG["label_num"]
    t.state = t._build_state()
    program.check_trainer(t, CFG, layout)


def _read(name="attention_nodes_per_step"):
    return spec.load_module(spec.metric_path(name), f"bench_metric_{name}").read(
        {"trace": None, "work": []})


@pytest.fixture(autouse=True)
def _clean():
    profiling.reset()
    yield
    profiling.reset()


def test_attention_nodes_per_step(monkeypatch):
    spans = [profiling.Span("fit", None, 0, 10, {}, 0),
             profiling.Span("fit.epochs", 0, 1, 9, {"epochs": 2, "steps": 8}, 0)]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert _read() is None  # the plain path replays no graph
    spans[1] = profiling.Span("fit.epochs", 0, 1, 9,
                              {"epochs": 2, "steps": 8, "graph_nodes": GRAPH}, 0)
    assert _read() == pytest.approx(10.0)
    assert _read("graph_nodes_per_step") == pytest.approx(25.5)
    spans[1] = profiling.Span("fit.epochs", 0, 1, 9, {"epochs": 2, "steps": 8, "graph_nodes": {
        **GRAPH, "by_phase": {"step.draw": 30, "rest": 70}}}, 0)
    assert _read() is None  # a graph without the phase: the parent's program
    monkeypatch.delattr(profiling, "spans")  # a program without spans
    assert _read() is None


def test_the_cell_is_declared():
    bench = spec.benchmark()
    c = spec.cell("raingan.fit.strict", bench)
    assert c["traffic"]["driver"] == "rain_fit" and c["cfg"]["model"] == "rain_gan"
    traced = {m["name"] for m in spec.metrics("raingan.fit.strict", True, bench)}
    assert {"attention_nodes_per_step", "graph_nodes_per_step", "mfu.train"} <= traced
    assert {m["name"] for m in spec.metrics("raingan.fit.strict", False, bench)} == {
        "train_steps_per_s", "setup_s"}
