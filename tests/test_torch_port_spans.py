"""The port's spans and counts (`cvaegan_tpu_torch/utils/profiling.py`):
off without a recording profiler, on under `torch.profiler` on the
profiler's own clock, the spans a plain CPU fit, a seed bank and the
fast generation path emit, the counters' registry, and the kernel nodes
of a capture by phase (with a stand-in for the CUDA driver here; on the
card, against the captured graph and one replay's kernels).

The test marked `cuda` skips without a card; this file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_spans.py -q
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cvaegan_tpu_torch import CVAEGAN
from cvaegan_tpu_torch.algorithms import base
from cvaegan_tpu_torch.algorithms.seed_bank import SeedBank
from cvaegan_tpu_torch.core import config as tconfig
from cvaegan_tpu_torch.kernels import block_attention, fused_mlp
from cvaegan_tpu_torch.models.layers import one_hot
from cvaegan_tpu_torch.utils import profiling

CLASSES = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _clean():
    profiling.reset()
    yield
    profiling.reset()


def _settings():
    """One epoch of small batches, 2 D, 2 C and 1 E+G steps a class."""
    s = tconfig.Settings()
    s.gan.epochs = 1
    s.gan.batch_size = 8
    s.gan.d_loop_num = s.gan.c_loop_num = 2
    s.gan.g_loop_num = 1
    return s


def _data(rows_per_class=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((CLASSES * rows_per_class, 4)).astype(np.float32)
    return x, np.repeat(np.arange(CLASSES), rows_per_class).astype(np.int32)


def _trainer(device="cpu"):
    t = CVAEGAN(seed=0, settings=_settings(), device=device)
    t.verbose = False
    return t


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


def _names(spans):
    return collections.Counter(s.name for s in spans)


def test_off_records_nothing():
    t = _trainer()
    assert profiling.span("fit") is profiling.span("gen.fast")  # the shared no-op
    t.fit(_data())
    t.generate_samples_fast(1, 5)
    assert not profiling.recording()
    assert profiling.spans() == []


def test_on_shares_the_profilers_clock_and_nests():
    with _recording() as prof:
        with profiling.span("warm"):  # the profiler's first annotation sets up
            pass
        with profiling.span("outer", a=1) as outer:
            with profiling.span("inner"):
                with profiling.span("innermost"):
                    sum(range(1000))
            with profiling.span("sibling"):
                pass
            outer.set(b=2)
    spans = profiling.spans()
    assert [s.name for s in spans] == ["warm", "outer", "inner", "innermost", "sibling"]
    assert [s.parent for s in spans] == [None, None, 1, 2, 1]
    assert [s.call for s in spans] == [0, 1, 1, 1, 1]
    assert spans[1].attrs == {"a": 1, "b": 2}
    kineto = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()}
    for s in spans:
        assert abs(kineto[s.name].start_ns() - s.start_ns) < 1_000_000, s.name
        assert s.end_ns >= s.start_ns


def test_plain_fit_and_generation_spans():
    t = _trainer()
    with _recording():
        t.fit(_data())
        t.generate_samples_fast(2, 5)
    spans = profiling.spans()
    names = _names(spans)
    cfg = t.gan_cfg
    assert names["fit"] == names["fit.prepare"] == names["fit.epochs"] == 1
    assert names["fit.chunk_end"] == 1 and names["fit.capture"] == 0  # the plain path
    assert (names["step.d"], names["step.c"], names["step.eg"]) == (
        CLASSES * cfg.d_loop_num, CLASSES * cfg.c_loop_num, CLASSES * cfg.g_loop_num)
    # one Adam step a D or C step, two (encoder, generator) an E+G step
    assert names["step.adam"] == names["step.d"] + names["step.c"] + 2 * names["step.eg"]
    by_name = {s.name: s for s in spans}
    fit = spans.index(by_name["fit"])
    for child in ("fit.prepare", "fit.epochs", "fit.chunk_end"):
        assert by_name[child].parent == fit and by_name[child].call == fit
    assert by_name["fit.prepare"].attrs["rows"] == CLASSES * 8
    assert by_name["fit.epochs"].attrs == {"epochs": 1, "steps": t._steps_per_epoch()}
    gen = spans.index(by_name["gen.fast"])
    assert by_name["gen.fast"].attrs == {"rows": 5}
    for child in ("gen.draw", "gen.fold", "gen.forward", "gen.copy"):
        assert by_name[child].parent == gen
    assert by_name["gen.fold"].attrs == {"built": True}
    assert by_name["gen.copy"].attrs == {"bytes": 5 * t.feature_num * 4}
    assert profiling.counters()["gen.fold_builds"] == 1


def test_fast_path_on_the_cpu_returns_the_plain_rows():
    """On the CPU the rows are the plain forward's, copied as before:
    no page-locked memory, no blocks; no rows give an empty array."""
    t = _trainer()
    t._prepare(_data())
    gen = t.state["generator"]
    start = t.generator.get_state()
    got = t.generate_samples_fast(1, 300)
    t.generator.set_state(start)
    labels, z = t._labels(1, 300), t._prior(300)
    want = fused_mlp.fast_generator_forward(
        gen, z, one_hot(labels, t.label_num), final=gen.out_activation or "none")
    assert got.dtype == np.float32 and np.array_equal(got, want.numpy())
    empty = t.generate_samples_fast(2, 0)
    assert empty.shape == (0, t.feature_num) and empty.dtype == np.float32
    counts = profiling.counters()
    assert counts.get("gen.pinned_copies", 0) == counts.get("gen.copy_blocks", 0) == 0


@pytest.mark.parametrize("n", [0, 1, 1000, base.COPY_BLOCK_ROWS, base.COPY_BLOCK_ROWS + 1,
                               834_000])
def test_row_blocks_cover_the_rows_in_order(n):
    blocks = base.row_blocks(n)
    assert len(blocks) == -(-n // base.COPY_BLOCK_ROWS)
    ends = [0] + [b for _, b in blocks]
    assert [a for a, _ in blocks] == ends[:-1] and ends[-1] == n
    assert all(0 < b - a <= base.COPY_BLOCK_ROWS for a, b in blocks)


def test_bank_spans_sum_steps_over_replicas():
    bank = SeedBank(CVAEGAN, seeds=[0, 1], settings=_settings(), device="cpu")
    x, y = _data(seed=1)
    y = np.where(y == 1, 0, y)  # the second replica lacks class 1
    with _recording():
        bank.fit([_data(), (x, y)])
    spans = profiling.spans()
    names = _names(spans)
    assert names["bank.fit"] == names["bank.prepare"] == names["bank.load"] == 1
    assert names["bank.store"] == names["fit.epochs"] == 1 and names["fit.prepare"] == 2
    epochs = next(s for s in spans if s.name == "fit.epochs")
    assert epochs.attrs["steps"] == sum(t._steps_per_epoch() for t in bank.trainers)
    assert epochs.attrs["steps"] == (2 * CLASSES - 1) * 5
    root = [s for s in spans if s.parent is None]
    assert [s.name for s in root] == ["bank.fit"]


def test_trace_clears_and_carries_spans(tmp_path):
    with _recording():
        with profiling.span("before"):
            pass
    with profiling.trace(tmp_path):
        with profiling.span("fit.prepare"):
            pass
    assert [s.name for s in profiling.spans()] == ["fit.prepare"]
    (trace_file,) = tmp_path.glob("*.pt.trace.json")
    assert '"fit.prepare"' in trace_file.read_text()


def test_counters_read_the_launch_globals_once(monkeypatch):
    monkeypatch.setattr(fused_mlp, "LAUNCHES", 3)
    monkeypatch.setattr(fused_mlp, "TC_LAUNCHES", 2)
    monkeypatch.setattr(fused_mlp, "SIMT_LAUNCHES", 1)
    monkeypatch.setattr(block_attention, "ENTROPY_LAUNCHES", 4)
    profiling.count("fit.captures")
    profiling.count("fit.replays", 50)
    first = profiling.counters()
    assert first == profiling.counters()  # reading counts nothing
    assert first["fused_mlp.launches"] == 3 and first["fused_mlp.tc_launches"] == 2
    assert first["block_attention.entropy_launches"] == 4
    assert first["fit.captures"] == 1 and first["fit.replays"] == 50
    profiling.reset()
    assert set(profiling.counters().values()) == {0}
    assert fused_mlp.LAUNCHES == 0


class _FakeDriver:
    """A CUDA graph under capture: `launch` adds a node of a
    `CUgraphNodeType`, which the capture's next node depends on;
    `shuffle` lists the nodes in another order than they were added."""

    def __init__(self, shuffle=False):
        self.types, self.shuffle = {}, shuffle

    def launch(self, kind=0):
        self.types[len(self.types)] = kind

    def capture_graph(self, stream):
        return "graph"

    def capture_leaves(self, stream):
        return (len(self.types) - 1,) if self.types else ()

    def nodes(self, graph):
        nodes = list(self.types)
        return nodes[::-1] if self.shuffle else nodes

    def node_type(self, node):
        return self.types[node]


def _launch_phases(driver):
    driver.launch()  # before the count: "rest"
    with profiling.count_nodes(0, driver=driver) as nodes:
        driver.launch()
        with profiling.span("step.d"):
            driver.launch()
            with profiling.span("step.draw"):
                driver.launch()
                driver.launch(2)  # a memset
            with profiling.span("step.adam"):
                for _ in range(3):
                    driver.launch()
            driver.launch(1)  # a memcpy
            driver.launch()
        driver.launch(6)  # another kind
    return nodes.counts()


def test_nodes_count_to_the_innermost_span():
    counts = _launch_phases(_FakeDriver())
    assert counts == {
        "kernel": 8, "by_phase": {"rest": 2, "step.d": 2, "step.draw": 1, "step.adam": 3},
        "memset": 1, "memcpy": 1, "other": 1}
    assert profiling.spans() == []  # counted, not recorded: no profiler ran
    assert profiling.span("step.d") is profiling.span("x")  # off again


def test_nodes_out_of_order_count_to_rest():
    with pytest.warns(UserWarning, match="not in the order"):
        counts = _launch_phases(_FakeDriver(shuffle=True))
    assert counts["by_phase"] == {"rest": 8} and counts["kernel"] == 8


def test_no_driver_no_counts(monkeypatch):
    monkeypatch.setattr(profiling, "_cuda_driver", lambda: None)
    with profiling.count_nodes(0) as nodes:
        assert profiling.span("step.d") is profiling.span("x")
    assert nodes is None


@pytest.mark.cuda
def test_captured_epoch_nodes_by_phase(monkeypatch):
    """The phases sum to the captured graph's kernel nodes, which the
    graph itself lists with its memset and memcpy nodes, and one replay
    runs one device operation for each node: a memset as a `Memset`, a
    kernel or a memcpy (`memcpy32_post`) as a kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.autograd import DeviceType

    graph_class = torch.cuda.CUDAGraph

    def kept():  # a graph that keeps its cudaGraph_t for `raw_cuda_graph`
        return graph_class(keep_graph=True)

    kept.register_generator_state = graph_class.register_generator_state
    monkeypatch.setattr(torch.cuda, "CUDAGraph", kept)
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t = _trainer("cuda")
        t.fit(_data(64))
        graph = t._graph[1]
        counts = graph.node_counts
        assert profiling.counters()["fit.captures"] == 1
        assert sum(counts["by_phase"].values()) == counts["kernel"]
        assert all(counts["by_phase"].get(p) for p in (
            "step.d", "step.c", "step.eg", "step.adam", "step.draw", "rest"))
        driver = profiling._cuda_driver()
        nodes = driver.nodes(graph.raw_cuda_graph())
        kinds = collections.Counter(driver.node_type(n) for n in nodes[:len(nodes)])
        assert (kinds[0], kinds[2], kinds[1]) == (
            counts["kernel"], counts["memset"], counts["memcpy"])
        every = counts["kernel"] + counts["memset"] + counts["memcpy"] + counts["other"]
        assert sum(kinds.values()) == every
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t.fit(_data(64))
            torch.cuda.synchronize()
        events = list(prof.profiler.kineto_results.events())
        launches = {e.correlation_id() for e in events if e.name() == "cudaGraphLaunch"}
        ran = [e.name() for e in events if e.device_type() == DeviceType.CUDA
               and e.correlation_id() in launches and not e.is_user_annotation()]
        assert len(launches) == 1 and len(ran) == every
        assert sum(n.startswith("Memset") for n in ran) == counts["memset"]
        (epochs,) = [s for s in profiling.spans() if s.name == "fit.epochs"]
        assert epochs.attrs["graph_nodes"] == counts
        (capture,) = [s for s in profiling.spans() if s.name == "fit.capture"]
        assert capture.attrs == {"hit": True}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32


def test_rain_gan_steps_hold_attention_spans():
    """A 2-epoch RAIN-GAN fit records its D, C and E+G steps as `step.d`,
    `step.c` and `step.eg`, each holding the `net.attention` spans of the
    networks it runs (D: the generator's 3 and the critic's 2; C: the
    generator's 3 and the classifier's 2; E+G: the encoder's 2, the
    generator's 3 twice, the critic's 2 and the classifier's 2); a
    CVAE-GAN fit records no `net.attention` span and its steps as before."""
    from cvaegan_tpu_torch import RAIN_GAN

    s = _settings()
    s.gan.epochs = 2
    rain = RAIN_GAN(seed=0, settings=s, device="cpu")
    rain.verbose = False
    cvae = _trainer()
    with _recording():
        rain.fit(_data())
    spans = profiling.spans()
    names = _names(spans)
    rounds = s.gan.epochs * CLASSES
    assert (names["step.d"], names["step.c"], names["step.eg"]) == (
        rounds * s.gan.d_loop_num, rounds * s.gan.c_loop_num, rounds * s.gan.g_loop_num)
    inside = collections.Counter(spans[sp.parent].name for sp in spans
                                 if sp.name == "net.attention" and sp.parent is not None)
    assert inside["step.d"] == 5 * names["step.d"]
    assert inside["step.c"] == 5 * names["step.c"]
    assert inside["step.eg"] == 12 * names["step.eg"]
    assert names["step.adam"] == names["step.d"] + names["step.c"] + 2 * names["step.eg"]
    profiling.reset()
    with _recording():
        cvae.fit(_data())
    names = _names(profiling.spans())
    assert names["net.attention"] == 0
    assert (names["step.d"], names["step.c"], names["step.eg"]) == (
        CLASSES * cvae.gan_cfg.d_loop_num, CLASSES * cvae.gan_cfg.c_loop_num,
        CLASSES * cvae.gan_cfg.g_loop_num)
