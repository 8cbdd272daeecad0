"""Whole runs of the RAIN-GAN training cell past the look for a card, on
the CPU at a tiny size, with the training step broken underneath, from
the start or in the window only: `correct` comes out false for each
fault, and true for the sound program. The faults are those of
`test_bench_port_faults.py`: a step that returns its state unchanged
(Adam steps nothing), and half of the batch left out, each loss the mean
over the rest; and two that a check of one step of each kind a round,
or of one class's round alone, would not see: each round's C steps all
on its first C step's batch (the draws go on as before), and the rounds
of classes 1-3 fed the labels of class 0."""

import argparse
import io
import json
import time

import pytest
import torch

from bench_port import worker
from bench_port.harness import spec
from bench_port.tests.test_bench_port_faults import _plant_half_batch, _plant_unchanged

torch.set_num_threads(2)
SEED = 2**31 + 2025
CELL = "raingan.fit.strict"
PLANT = {"unchanged": _plant_unchanged, "half_batch": _plant_half_batch}


def _plant_reused_batch(monkeypatch):
    from cvaegan_tpu_torch.algorithms.rain_gan import RAIN_GAN

    d_step, c_step = RAIN_GAN._d_step, RAIN_GAN._c_step

    def d(self, x, y, z):
        self._first_c = None  # a round starts with its D steps
        return d_step(self, x, y, z)

    def c(self, x, y, z):
        if getattr(self, "_first_c", None) is None:
            self._first_c = (x, y)
        return c_step(self, *self._first_c, z)

    monkeypatch.setattr(RAIN_GAN, "_d_step", d)
    monkeypatch.setattr(RAIN_GAN, "_c_step", c)


def _plant_other_labels(monkeypatch):
    from cvaegan_tpu_torch.algorithms.rain_gan import RAIN_GAN

    sample = RAIN_GAN._sample_batch

    def wrong(self, class_id):
        x, y = sample(self, class_id)
        return x, (torch.zeros_like(y) if class_id in (1, 2, 3) else y)

    monkeypatch.setattr(RAIN_GAN, "_sample_batch", wrong)


HIDDEN = {"reused_c_batch": _plant_reused_batch, "other_labels": _plant_other_labels}


@pytest.fixture()
def tiny(monkeypatch):
    """The cell's traffic at a size the CPU holds: the widths, batch and
    schedule stay."""
    cell = spec.cell

    def small(name, bench=None):
        c = cell(name, bench)
        c["traffic"] = {**c["traffic"], "frames": 20000, "epochs_per_call": 1}
        return c

    monkeypatch.setattr(spec, "cell", small)


def _run():
    out = io.StringIO()
    args = argparse.Namespace(workload=CELL, seed=SEED, seconds=0.01, trace=0, t0=time.time())
    assert worker.run(args, out, device="cpu") == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_the_sound_program_is_correct(tiny):
    result = _run()
    assert result["correct"] is True, result["compared"]


@pytest.mark.parametrize("fault", sorted(PLANT))
def test_a_broken_training_step_is_not_correct(tiny, monkeypatch, fault):
    PLANT[fault](monkeypatch)
    result = _run()
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("fault", sorted(HIDDEN))
def test_a_fault_in_repeated_steps_or_other_classes_is_not_correct(tiny, monkeypatch, fault):
    HIDDEN[fault](monkeypatch)
    result = _run()
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("fault", sorted(PLANT))
def test_a_step_broken_in_the_window_only_is_not_correct(tiny, monkeypatch, fault):
    """The timed path broken alone, as a captured graph that differs from
    the step code would be: every fit call runs the fault but the eager
    ones, which are set-up's checked rounds and the epoch the window's
    graph is held to."""
    load = spec.load_module

    def loading(path, name):
        module = load(path, name)
        if hasattr(module, "Driver"):
            build = module.Driver._build

            def building(self, s):
                build(self, s)
                plain = self._fit

                def fit(data, eager=False):
                    if eager:
                        return plain(data, eager=True)
                    with monkeypatch.context() as m:
                        PLANT[fault](m)
                        return plain(data)

                self._fit = fit

            monkeypatch.setattr(module.Driver, "_build", building)
        return module

    monkeypatch.setattr(spec, "load_module", loading)
    result = _run()
    assert result["correct"] is False, result["compared"]
