"""Driver of the RAIN-GAN training cell: repeated `fit` calls of one
`RAIN_GAN` trainer.

The window is the training driver's (`drivers/fit.py`), with RAIN-GAN's
trainer, leaves (`reference/rain_nets.py::layout`), reference
(`reference/rain_train.py`) and loss keys, `attention_loss` among them.
Every epoch the program runs, checked or timed, takes the
configuration's schedule: 5 D, 5 C and 3 E+G steps a class round. The
check departs from `fit.Driver`'s where RAIN-GAN carries a rounding
difference too far for it:

- Set-up checks one class round at a time, each from the seed's weights
  and generator state: one epoch of `fit`, run eagerly, on the frames of
  each class `check_classes` names, made distinct. The plain reference
  follows each from the same start. Each number is the worst class's,
  but the two medians, which are the mean over the classes.
  In RAIN-GAN's critic, which has no dropout, a bias's gradient over a
  strict batch cancels between the real and the fake rows down to
  rounding, and Adam's first steps turn that rounding into steps of up
  to the learning rate, with a sign of their own in any two programs.
  Past one round, or from the window's trained state, the sound
  program's worst leaves read as far from the reference as the
  half-batch fault (`PERF.md` §2). Within one round, the classifier's C
  steps run before any E+G step, on fakes of the generator the round
  started with, so `classifier_change_gap_median` (the classifier's
  median leaf) stays at rounding where the TF32 control's does not.
- After the window has closed, from a copy of the state it left, the
  window's own captured epoch is replayed once on the frames, and the
  same epoch is then run eagerly from the same copy: `window_graph_gap`
  holds the timed graph to the step code that set-up held to the
  reference, over every class's round. The two run the same kernels in
  the same order, so no rounding difference is there for the critic to
  carry: it reads 0. Every optimizer's step count has to have moved by
  the steps the window's calls are counted with (`window_steps_gap`).
"""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from bench_port.data import car_hacking
from bench_port.drivers import fit
from bench_port.harness import compare, program, weights
from bench_port.reference import rain_nets, rain_train

#: the numbers that the check takes as the mean over the checked classes'
#: rounds, where every other is the worst class's: a sound round now and
#: then reads several times its usual gap in one class alone (`PERF.md` §2)
MEAN = ("change_gap_median", "classifier_change_gap_median")


class Driver(fit.Driver):
    def _build(self, s) -> None:
        from cvaegan_tpu_torch import RAIN_GAN

        t = RAIN_GAN(seed=self.seed, settings=s, device=self.device)
        t.verbose = False
        self.trainers = [t]
        self._fit = lambda data, eager=False: t.fit(data[0], eager=eager)

    def _loss_keys(self) -> List[str]:
        return rain_train.loss_keys(self.cfg)

    def make_inputs(self) -> None:
        """The frames and the initial weights, as `fit.Driver.make_inputs`
        makes them, with RAIN-GAN's leaves; and each checked class's frames
        apart, made distinct."""
        (seed,) = self.seeds()
        self.datasets = [car_hacking.frames(self.frames(), seed)]
        x, y = self.datasets[0]
        self.check_sets = {}
        for c in self.traffic["check_classes"]:
            rows = np.flatnonzero(y == int(c))
            self.check_sets[int(c)] = [(car_hacking.distinct(x[rows], seed), y[rows])]
        self.layout = rain_nets.layout(self.cfg)
        self.leaves0 = weights.make(self.layout, [seed], self.device)

    def _state(self) -> dict:
        return {"leaves": program.state_leaves(self.trainers),
                "adam_m": program.adam_moments(self.trainers)}

    def _restore(self) -> None:
        """The trainers' state and generators as the snapshot took them."""
        snap = self.snapshot
        with torch.no_grad():
            torch._foreach_copy_(snap.src, snap.buf)
        for t, state in zip(self.trainers, snap.rng):
            t.generator.set_state(state)

    def setup(self) -> None:
        self.make_inputs()
        self.settings = program.settings(self.cfg, self.seed)
        self._build(self.settings)
        (t,) = self.trainers
        t._prepare(self.datasets[0])
        program.check_trainer(t, self.cfg, self.layout)
        program.load_leaves(t, self.leaves0, 0)
        steps = self._steps()
        self.steps_per_epoch = int(sum(steps[net].sum() for net in
                                       ("discriminator", "classifier", "generator")))
        self.snapshot = program.Snapshot(self.trainers)
        self.snapshot.take()
        self.settings.gan.epochs = 1
        self.prog = {}
        for c, sets in self.check_sets.items():
            self._restore()
            self._fit(sets, eager=True)
            self.prog[c] = {"losses": program.loss_history(self.trainers, self._loss_keys(), 1,
                                                           first=-1),
                            **self._state()}
        self._restore()
        self._fit(self.datasets)  # the window's graph, captured
        self.settings.gan.epochs = int(self.traffic["epochs_per_call"])
        self.counts0 = program.adam_counts(self.trainers)
        self.window_calls = 0

    def release(self) -> None:
        """Keep the window's step counts, as `fit.Driver.release` does; run
        the window's epoch replayed and eagerly from one copy; then free
        the program."""
        epochs = self.settings.gan.epochs
        counts = program.adam_counts(self.trainers)
        self.settings.gan.epochs = 1
        self.snapshot.take()
        start = self.snapshot.start()
        self._fit(self.datasets)
        replayed = self._state()
        self._restore()
        self._fit(self.datasets, eager=True)
        self.window = {
            "graph": {"start": start, "replayed": replayed, "eager": self._state()},
            "counts": counts,
            "counted": {net: self.window_calls * epochs * n for net, n in self._steps().items()},
        }
        self.trainers = self._fit = self.snapshot = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -------------------------------------------------------------- check
    def reference(self, half_batch: bool = False, c: int = None) -> dict:
        """The plain reference over one round of class `c` (the last
        checked class where None) from the seed's weights."""
        c = max(self.check_sets) if c is None else c
        return rain_train.fit(self.cfg, self.leaves0, self._data(self.check_sets[c]),
                              self.seeds(), [1], self.device, half_batch=half_batch)

    def window_reference(self, start: dict, half_batch: bool = False) -> dict:
        """The plain reference over one round of the last checked class
        from `start` (`control.py` reads its losses from the state the
        reference reaches in set-up)."""
        return rain_train.fit(self.cfg, start["leaves"],
                              self._data(self.check_sets[max(self.check_sets)]), self.seeds(),
                              [1], self.device, half_batch=half_batch, start=start)

    def compare(self, got: dict, ref: dict) -> Dict[str, dict]:
        """`fit.Driver.compare`'s numbers, and `classifier_change_gap_median`:
        the classifier's median leaf's change gap."""
        out = super().compare(got, ref)
        out["classifier_change_gap_median"] = {
            "value": out["change_gap"]["by_net"]["classifier"][1], "at": "classifier"}
        return out

    def compare_graph(self, graph: dict) -> Dict[str, dict]:
        """`window_graph_gap`: the worst leaf, over the networks' leaves
        and the Adam first moments, of the norm of the replayed graph's
        state less the eager epoch's, over the larger of the eager
        epoch's norm (of the change from the start, for a leaf) and the
        median leaf's."""
        start, got, ref = graph["start"], graph["replayed"], graph["eager"]
        gaps, names = [], []
        for part, base in (("leaves", start["leaves"]), ("adam_m", None)):
            diffs, norms = [], []
            for net, leaves in ref[part].items():
                for k, r in leaves.items():
                    moved = r.double() - (0.0 if base is None else base[net][k].double())
                    diffs.append((got[part][net][k].double() - r.double()).flatten(1).norm(dim=1))
                    norms.append(moved.flatten(1).norm(dim=1))
                    names.append((net, f"{part}:{k}"))
            d, n = torch.stack(diffs), torch.stack(norms)  # [L, K]
            scale = torch.maximum(n, n.median(dim=0).values[None, :])
            gaps.append(d / torch.clamp_min(scale, 1e-30))
        value, at = compare.worst_gap(torch.cat(gaps), names)
        return {"window_graph_gap": {"value": value, "at": at}}

    def check(self) -> Dict[str, dict]:
        out = {}
        by_class = {c: self.compare(got, self.reference(c=c)) for c, got in self.prog.items()}
        for name in by_class[min(by_class)]:
            values = {c: numbers[name]["value"] for c, numbers in by_class.items()}
            worst = max(values, key=values.get)
            at = f"class {worst}: {by_class[worst][name]['at']}"
            if name in MEAN:
                out[name] = {"value": sum(values.values()) / len(values),
                             "at": f"mean of {len(values)} classes; the worst, {at}"}
            else:
                out[name] = {**by_class[worst][name], "at": at}
        w = self.window
        out.update(self.compare_graph(w["graph"]))
        moved = {net: w["counts"][net] - self.counts0[net] for net in w["counts"]}
        gap = max(int((moved[net] - w["counted"][net]).abs().max()) for net in moved)
        out["window_steps_gap"] = {
            "value": float(gap),
            "at": {net: [int(moved[net].min()), int(moved[net].max()),
                         int(w["counted"][net].max())] for net in moved}}
        return out
