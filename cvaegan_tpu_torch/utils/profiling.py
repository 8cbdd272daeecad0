"""Tracing, spans and counters, throughput and a NaN sanitizer, the
counterpart of `cvaegan_tpu/utils/profiling.py`.

  * `trace(logdir)`: `torch.profiler` over the enclosed block, CPU and
    (where there is a card) CUDA activities, written to `logdir` as a
    Chrome/TensorBoard trace file (`*.pt.trace.json`), the program's
    spans in it;
  * `span(name, **attrs)`: a span of the program (`fit`, `fit.epochs`,
    `bank.load`, `gen.copy`, ...), on exactly while a `torch.profiler`
    session records (`trace()`, or any `torch.profiler.profile`). On, it
    is a `record_function` of that name, so the trace shows it on the
    device timeline's clock, and it is kept in memory with its parent,
    its start and end (`time.time_ns()`, the clock of the profiler's
    host events) and its attributes until `spans()` reads it. Off, it is
    one shared no-op context;
  * `counters()`: the program's counts (`fit.captures`, `fit.replays`,
    `gen.fold_builds`, `gen.pinned_copies`, `gen.copy_blocks`) and the
    kernel wrappers' launch counts;
    `reset()` clears the spans and sets every count to 0;
  * kernel nodes by phase of a captured graph: while `count_nodes` is
    entered (inside a CUDA graph's capture, `core.state.capture_graphs`),
    the kernel nodes each span adds to the graph, as its innermost span,
    count to that span's name (nodes added with no span open to
    "rest"), memset, memcpy and other nodes apart. This runs at capture
    only, whether or not the profiler records, and adds nothing to the
    graph;
  * `Throughput`: steps/s (and samples/s) with a one-line JSON report;
    `stop()` synchronizes the device it was given before it reads the
    clock, so the time covers the device's work, not its enqueueing;
  * `nan_debug()`: raises `FloatingPointError` naming the op on the first
    NaN an op produces, as `jax_debug_nans` does in the JAX package. A
    captured CUDA graph cannot raise, so inside it the trainers' and the
    classifier's `fit` run their plain versions, as JAX de-optimizes.

The spans, the counts and the capture being counted are the process's
own: the program calls spans from one thread.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import importlib
import json
import pathlib
import time
import warnings
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack


@contextlib.contextmanager
def trace(logdir=None):
    """Profile the enclosed block; the trace file is written into `logdir`
    (default: `trace/` under the settings' log directory) when the block
    ends. Yields the profiler (`key_averages()` etc.)."""
    if logdir is None:
        from cvaegan_tpu_torch.core import config as config_lib

        logdir = config_lib.settings.paths.logs / "trace"
    logdir = pathlib.Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    _clear_spans()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


class Span(NamedTuple):
    """A span that `spans()` returns: `parent` and `call` are indices into
    the same list (the innermost span open when it began, and the
    outermost: the `fit`, `bank.fit` or `gen.fast` call it belongs to;
    its own index for an outermost span); `end_ns` is None while it is
    open."""

    name: str
    parent: Optional[int]
    start_ns: int
    end_ns: Optional[int]
    attrs: dict
    call: int


class _Record:
    __slots__ = ("name", "parent", "start_ns", "end_ns", "attrs")

    def __init__(self, name, parent, start_ns, attrs):
        self.name, self.parent, self.start_ns, self.attrs = name, parent, start_ns, attrs
        self.end_ns = None


#: the spans recorded since the last `reset()` or `trace()`, in the order
#: they began, and those still open, innermost last
_records: List[_Record] = []
_open: List[_Record] = []
#: the program's counts
_counts: Dict[str, int] = {}
#: the capture whose kernel nodes are being counted (`count_nodes`)
_nodes: Optional["_NodeCount"] = None


def recording() -> bool:
    """Whether a `torch.profiler` session records: spans are on exactly
    then."""
    return _profiler._is_profiler_enabled


class _Off:
    """The span while nothing records and no capture is counted."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "_record", "_function", "_counted")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self._record = self._function = self._counted = None

    def __enter__(self):
        if _nodes is not None:
            self._counted = _nodes
            _nodes.enter(self.name)
        if recording():
            record = _Record(self.name, _open[-1] if _open else None, time.time_ns(),
                             self.attrs)
            _records.append(record)
            _open.append(record)
            self._record = record
            self._function = torch.profiler.record_function(self.name)
            self._function.__enter__()
        return self

    def __exit__(self, *exc):
        if self._function is not None:
            self._function.__exit__(*exc)
            self._record.end_ns = time.time_ns()
            if _open and _open[-1] is self._record:  # else a reset() came between
                _open.pop()
        if self._counted is not None:
            self._counted.exit()
        return None

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span (a capture's hit, the
        bytes copied)."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager: the span `name` with `attrs` while a profiler
    records or a capture's nodes are counted, else a shared no-op. Both
    have `set(**attrs)`."""
    if _nodes is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def spanned(name: str):
    """Decorator: the function's every call inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapped
    return wrap


def spans() -> List[Span]:
    """The spans recorded since the last `reset()` or `trace()`."""
    index = {id(r): i for i, r in enumerate(_records)}
    out: List[Span] = []
    for r in _records:
        parent = index.get(id(r.parent)) if r.parent is not None else None
        call = len(out) if parent is None else out[parent].call
        out.append(Span(r.name, parent, r.start_ns, r.end_ns, dict(r.attrs), call))
    return out


def count(name: str, n: int = 1) -> None:
    """Add `n` to the program's count `name`."""
    _counts[name] = _counts.get(name, 0) + n


#: the kernel wrappers' launch counts: each module's globals, named
#: `<module>.<global in lower case>` in `counters()`
_LAUNCHES = {"fused_mlp": ("LAUNCHES", "TC_LAUNCHES", "SIMT_LAUNCHES"),
             "block_attention": ("LAUNCHES", "ENTROPY_LAUNCHES", "BF16_LAUNCHES",
                                 "BF16_ENTROPY_LAUNCHES")}


def _launch_globals():
    """(name in `counters()`, module, global) of each launch count."""
    for module, names in _LAUNCHES.items():
        m = importlib.import_module(f"cvaegan_tpu_torch.kernels.{module}")
        for name in names:
            yield f"{module}.{name.lower()}", m, name


def counters() -> Dict[str, int]:
    """The program's counts and the kernel wrappers' launch counts (read
    from `kernels/fused_mlp.py` and `kernels/block_attention.py`, which
    keep them)."""
    out = dict(_counts)
    for key, module, name in _launch_globals():
        out[key] = getattr(module, name)
    return out


def _clear_spans() -> None:
    _records.clear()
    _open.clear()


def reset() -> None:
    """Clear the spans and set every count of `counters()` to 0."""
    _clear_spans()
    _counts.clear()
    for _, module, name in _launch_globals():
        setattr(module, name, 0)


# ---------------------------------------------------------------------------
# Kernel nodes of a capture, by phase.
# ---------------------------------------------------------------------------

#: `CUgraphNodeType` values
_KERNEL, _MEMCPY, _MEMSET = 0, 1, 2


class _CudaDriver:
    """The CUDA driver calls the node counts take, through the driver
    library torch has loaded."""

    def __init__(self):
        lib = ctypes.CDLL("libcuda.so.1")
        p, size = ctypes.c_void_p, ctypes.c_size_t
        # (stream, status, id, graph, dependencies[, edge data], count); v3
        # (CUDA 12.3 on) takes the edge data, v2 not
        info = getattr(lib, "cuStreamGetCaptureInfo_v3", None)
        self._v3 = info is not None
        if info is None:
            info = lib.cuStreamGetCaptureInfo_v2
        info.argtypes = [p, ctypes.POINTER(ctypes.c_int), p, ctypes.POINTER(p),
                         ctypes.POINTER(ctypes.POINTER(p)), *([p] if self._v3 else []),
                         ctypes.POINTER(size)]
        lib.cuGraphGetNodes.argtypes = [p, p, ctypes.POINTER(size)]
        lib.cuGraphNodeGetType.argtypes = [p, ctypes.POINTER(ctypes.c_int)]
        for fn in (info, lib.cuGraphGetNodes, lib.cuGraphNodeGetType):
            fn.restype = ctypes.c_int
        self._info, self._lib = info, lib

    @staticmethod
    def _check(rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{what} failed with CUresult {rc}")

    def _capture_info(self, stream: int):
        status, graph = ctypes.c_int(), ctypes.c_void_p()
        deps, n = ctypes.POINTER(ctypes.c_void_p)(), ctypes.c_size_t(0)
        edges = [None] if self._v3 else []
        self._check(self._info(stream, ctypes.byref(status), None, ctypes.byref(graph),
                               ctypes.byref(deps), *edges, ctypes.byref(n)),
                    "cuStreamGetCaptureInfo")
        if status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
            raise RuntimeError("count_nodes: the stream is not capturing")
        return graph.value, tuple(deps[i] for i in range(n.value))

    def capture_graph(self, stream: int) -> int:
        """The graph that `stream` is capturing into."""
        return self._capture_info(stream)[0]

    def capture_leaves(self, stream: int) -> tuple:
        """The nodes the capture's next node will depend on: the last
        added on `stream` (and on each stream it joined since)."""
        return self._capture_info(stream)[1]

    def nodes(self, graph: int) -> list:
        """The graph's nodes, in the order they were added."""
        n = ctypes.c_size_t(0)
        self._check(self._lib.cuGraphGetNodes(graph, None, ctypes.byref(n)),
                    "cuGraphGetNodes")
        if not n.value:  # an empty buffer is an invalid value
            return []
        buf = (ctypes.c_void_p * n.value)()
        self._check(self._lib.cuGraphGetNodes(graph, buf, ctypes.byref(n)),
                    "cuGraphGetNodes")
        return buf[:n.value]

    def node_type(self, node: int) -> int:
        kind = ctypes.c_int()
        self._check(self._lib.cuGraphNodeGetType(node, ctypes.byref(kind)),
                    "cuGraphNodeGetType")
        return kind.value


_driver: Optional[_CudaDriver] = None


def _cuda_driver() -> Optional[_CudaDriver]:
    """The driver's calls, or None (with a warning, once) where this
    system's driver library lacks them: the capture then has no counts."""
    global _driver
    if _driver is None:
        try:
            _driver = _CudaDriver()
        except (OSError, AttributeError) as e:
            warnings.warn(f"kernel nodes are not counted: {e}")
            _driver = False
    return _driver or None


class _NodeCount:
    """Kernel nodes of one capture by phase: the name of the innermost
    span open when a node was added, or "rest". A span's entry and exit
    only mark the capture's last nodes (a walk of the graph there would
    cost its size at every mark); `close` walks the graph once."""

    def __init__(self, driver, stream: int):
        self._driver, self._stream = driver, stream
        self._graph = driver.capture_graph(stream)
        self._phases: List[str] = []
        #: (the capture's last nodes, the phase open until then)
        self._marks: List[tuple] = []
        self.kernel: Dict[str, int] = {}
        self.memset = self.memcpy = self.other = 0

    def _mark(self) -> None:
        self._marks.append((self._driver.capture_leaves(self._stream),
                            self._phases[-1] if self._phases else "rest"))

    def enter(self, name: str) -> None:
        self._mark()
        self._phases.append(name)

    def exit(self) -> None:
        self._mark()
        self._phases.pop()

    def close(self) -> None:
        """Count every node of the graph (while it is still capturing:
        the graph goes when the capture ends) to the phase open when it
        was added: a node up to a mark's last node to that mark's phase."""
        self._mark()
        nodes = self._driver.nodes(self._graph)
        where = {node: i for i, node in enumerate(nodes)}
        ends = [max((where[n] + 1 for n in leaves), default=0) for leaves, _ in self._marks]
        if any(b < a for a, b in zip(ends, ends[1:])):
            warnings.warn("the graph's nodes are not in the order they were added: "
                          "every kernel node counts to 'rest'")
            ends = []
        start = 0
        for end, (_, phase) in zip(ends, self._marks):
            for node in nodes[start:end]:
                self._count(node, phase)
            start = max(start, end)
        for node in nodes[start:]:
            self._count(node, "rest")

    def _count(self, node, phase: str) -> None:
        kind = self._driver.node_type(node)
        if kind == _KERNEL:
            self.kernel[phase] = self.kernel.get(phase, 0) + 1
        elif kind == _MEMSET:
            self.memset += 1
        elif kind == _MEMCPY:
            self.memcpy += 1
        else:
            self.other += 1

    def counts(self) -> dict:
        """{"kernel": total, "by_phase": {phase: kernel nodes}, "memset",
        "memcpy", "other": nodes of each}."""
        return {"kernel": sum(self.kernel.values()), "by_phase": dict(self.kernel),
                "memset": self.memset, "memcpy": self.memcpy, "other": self.other}


@contextlib.contextmanager
def count_nodes(stream: int, driver=None):
    """Count, by phase, the nodes of the graph that `stream` (a
    `cuda_stream` handle) is capturing into, those before the block
    included; yields the `_NodeCount` (read `counts()` after the block),
    or None where the driver's calls are missing. The block must end
    before the capture does. `driver` stands in for the CUDA driver (the
    tests' fake)."""
    global _nodes
    driver = driver or _cuda_driver()
    if driver is None:
        yield None
        return
    counter = _NodeCount(driver, stream)
    _nodes = counter
    try:
        yield counter
        counter.close()
    finally:
        _nodes = None


#: allocation ops, whose outputs hold whatever the memory held
_UNINITIALIZED = {torch.ops.aten.empty, torch.ops.aten.empty_like,
                  torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
                  torch.ops.aten.new_empty_strided}


class _NanCheck(TorchDispatchMode):
    """Runs every op, then raises if a floating-point output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in _UNINITIALIZED:
            return out
        for t in pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextlib.contextmanager
def nan_debug():
    """Raise `FloatingPointError` on the first NaN any op produces in the
    block (each op's outputs are checked, which waits for the device)."""
    with _NanCheck():
        yield


def nan_debug_active() -> bool:
    """Whether the calling code runs inside `nan_debug()`."""
    return any(isinstance(m, _NanCheck) for m in _get_current_dispatch_mode_stack())


class Throughput:
    """Steps/s (and samples/s) counter.

    >>> t = Throughput(steps_per_epoch=65, batch_size=128, device="cuda")
    >>> t.start(); ...train...; print(t.report(epochs=100))
    """

    def __init__(self, steps_per_epoch: int, batch_size: Optional[int] = None,
                 device=None):
        self.steps_per_epoch = steps_per_epoch
        self.batch_size = batch_size
        self.device = None if device is None else torch.device(device)
        self._t0: Optional[float] = None
        self.elapsed: float = 0.0

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("Throughput.stop() before start()")
        self._sync()
        self.elapsed = time.perf_counter() - self._t0
        return self.elapsed

    def report(self, epochs: int) -> dict:
        if self._t0 is not None and self.elapsed == 0.0:
            self.stop()
        steps = epochs * self.steps_per_epoch
        out = {"steps": steps, "seconds": round(self.elapsed, 3),
               "steps_per_sec": round(steps / self.elapsed, 2)}
        if self.batch_size:
            out["samples_per_sec"] = round(steps * self.batch_size / self.elapsed, 1)
        return out

    def report_json(self, epochs: int) -> str:
        return json.dumps(self.report(epochs))
