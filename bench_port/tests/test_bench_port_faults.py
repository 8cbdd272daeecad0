"""A whole run past the look for a card, on the CPU at a tiny size, with
the timed path broken underneath, from the start or in the window only:
`correct` comes out false for each fault a cell can have, and true for
the sound program.

Faults: a step that returns its state unchanged (Adam steps nothing);
half of the batch left out, each loss the mean over the rest; an answer
altered where it is produced (one generated row changed). The cells run
on one chip: no exchange between chips exists to leave out."""

import argparse
import io
import json
import time

import pytest
import torch

from bench_port import worker
from bench_port.harness import spec

torch.set_num_threads(2)
SEED = 2**31 + 2025


@pytest.fixture()
def tiny(monkeypatch):
    """The cells' traffic at a size the CPU holds: the widths, batch and
    schedule stay."""
    cell = spec.cell

    def small(name, bench=None):
        c = cell(name, bench)
        c["traffic"] = {**c["traffic"], "frames": 20000, "frames_per_replica": 8000,
                        "replicas": 2, "epochs_per_call": 1, "sample_span": 2}
        return c

    monkeypatch.setattr(spec, "cell", small)


def _run(workload):
    out = io.StringIO()
    args = argparse.Namespace(workload=workload, seed=SEED, seconds=0.01, trace=0,
                              t0=time.time())
    assert worker.run(args, out, device="cpu") == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _half(fn, axis_from_end=2, labels=False):
    def wrapped(*args, **kwargs):
        cut = []
        for a in args:
            dim = a.dim() - (1 if labels and a.dtype == torch.int64 else axis_from_end)
            cut.append(a.narrow(dim, 0, a.shape[dim] // 2))
        return fn(*cut, **kwargs)
    return wrapped


def _plant_half_batch(monkeypatch):
    from cvaegan_tpu_torch.core import losses

    for name in ("mse", "kl_standard_normal", "wasserstein_d_loss", "wasserstein_g_loss"):
        monkeypatch.setattr(losses, name, _half(getattr(losses, name)))
    monkeypatch.setattr(losses, "cross_entropy", _half(losses.cross_entropy, labels=True))


def _plant_unchanged(monkeypatch):
    from cvaegan_tpu_torch.core import state

    monkeypatch.setattr(state.Adam, "step", lambda self, grads: None)


def _plant_altered(monkeypatch):
    from cvaegan_tpu_torch.kernels import fused_mlp

    forward = fused_mlp.fast_generator_forward

    def altered(*args, **kwargs):
        out = forward(*args, **kwargs)
        out[0] = 1.0 - out[0]
        return out

    monkeypatch.setattr(fused_mlp, "fast_generator_forward", altered)


@pytest.mark.parametrize("workload", ["cvaegan.fit.strict", "cvaegan.bank20.strict",
                                      "cvaegan.gen.fast"])
def test_the_sound_program_is_correct(tiny, workload):
    result = _run(workload)
    assert result["correct"] is True, result["compared"]


@pytest.mark.parametrize("workload", ["cvaegan.fit.strict", "cvaegan.bank20.strict"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(tiny, monkeypatch, workload, fault):
    {"unchanged": _plant_unchanged, "half_batch": _plant_half_batch}[fault](monkeypatch)
    result = _run(workload)
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("workload", ["cvaegan.fit.strict", "cvaegan.bank20.strict"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_step_broken_in_the_window_only_is_not_correct(tiny, monkeypatch, workload, fault):
    """Set-up runs sound; the fault is planted as the window's first call
    starts."""
    plant = {"unchanged": _plant_unchanged, "half_batch": _plant_half_batch}[fault]
    load = spec.load_module

    def loading(path, name):
        module = load(path, name)
        if hasattr(module, "Driver"):
            call = module.Driver.call

            def broken(self):
                plant(monkeypatch)
                return call(self)

            monkeypatch.setattr(module.Driver, "call", broken)
        return module

    monkeypatch.setattr(spec, "load_module", loading)
    result = _run(workload)
    assert result["correct"] is False, result["compared"]


def test_an_altered_row_is_not_correct(tiny, monkeypatch):
    _plant_altered(monkeypatch)
    result = _run("cvaegan.gen.fast")
    assert result["correct"] is False, result["compared"]
