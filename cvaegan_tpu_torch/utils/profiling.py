"""Tracing, throughput and a NaN sanitizer, the counterpart of
`cvaegan_tpu/utils/profiling.py`.

  * `trace(logdir)`: `torch.profiler` over the enclosed block, CPU and
    (where there is a card) CUDA activities, written to `logdir` as a
    Chrome/TensorBoard trace file (`*.pt.trace.json`);
  * `Throughput`: steps/s (and samples/s) with a one-line JSON report;
    `stop()` synchronizes the device it was given before it reads the
    clock, so the time covers the device's work, not its enqueueing;
  * `nan_debug()`: raises `FloatingPointError` naming the op on the first
    NaN an op produces, as `jax_debug_nans` does in the JAX package. A
    captured CUDA graph cannot raise, so inside it the trainers' and the
    classifier's `fit` run their plain versions, as JAX de-optimizes.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import time
from typing import Optional

import torch
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
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


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
