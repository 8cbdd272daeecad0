"""Driver of the training cells: repeated `fit` calls of one trainer.

Set-up makes the data and the initial weights from the seed, builds the
trainer, and drives it through its first epochs with the window's own
call (`fit`, at `check_calls` epochs per call), fed the window's frames
of the classes `check_classes` only, the same count of each in every
replica, with no two rows alike (`data/car_hacking.py::distinct`): an
epoch is then one round of each of those classes, where the window's has
five, and the program captures it as a graph of its own. A round carries
a rounding difference about tenfold into the next, so that after the
five rounds of a whole epoch a one-ulp change of the weights reads as
large as products in TF32 do, while after two it stays at rounding
(`PERF.md` §2). One epoch on the frames then captures the window's
graph. That same trainer runs the window: `fit` calls of
`epochs_per_call` epochs each on the frames, continuing one state.
Before each window call the trainer's state and its generator's are
copied aside (`harness/program.py::Snapshot`).

Once the window has closed and the trainer is freed, the comparison
(`harness/compare.py`) reads:

- set-up: the plain reference follows those first calls from the same
  rows and weights; each epoch's recorded losses, each Adam's first
  moment after the first call by the worst leaf, and every leaf's change
  after the last, by the worst leaf and by the median leaf;
- window: the reference follows the first epoch of the window's last
  call from that call's copied start (the program's own state: the
  start of the run is what set-up checks), on the frames, and the losses
  that call recorded for it are compared; and every optimizer's step
  count has to have moved by the steps the window's calls are counted
  with, no more and no fewer.

A captured epoch is the smallest unit the program exposes: the numbers
are per epoch, not per optimizer step.
"""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from bench_port.data import car_hacking
from bench_port.harness import compare, program, weights
from bench_port.reference import nets
from bench_port.reference import train as ref_train


class Driver:
    span = "bench.fit"

    def __init__(self, ctx: dict):
        self.ctx = ctx
        self.cfg, self.traffic = ctx["cfg"], ctx["traffic"]
        self.device = torch.device(ctx["device"])
        self.seed = int(ctx["seed"])

    # ----------------------------------------------------------- replicas
    def seeds(self) -> List[int]:
        return [self.seed]

    def frames(self) -> int:
        return int(self.traffic["frames"])

    def _build(self, s) -> None:
        t = program.trainer_class(self.cfg)(seed=self.seed, settings=s, device=self.device)
        t.verbose = False
        self.trainers = [t]
        self._fit = lambda data: t.fit(data[0])

    # -------------------------------------------------------------- setup
    def make_inputs(self) -> None:
        """The data and the initial weights, from the seed: what the program
        and the reference are both handed."""
        seeds = self.seeds()
        self.datasets = [car_hacking.frames(self.frames(), s) for s in seeds]
        keep = [int(c) for c in self.traffic["check_classes"]]
        count = {c: min(int((y == c).sum()) for _, y in self.datasets) for c in keep}
        self.check_sets = []
        for (x, y), s in zip(self.datasets, seeds):
            rows = np.sort(np.concatenate([np.flatnonzero(y == c)[:count[c]] for c in keep]))
            self.check_sets.append((car_hacking.distinct(x[rows], s), y[rows]))
        self.layout = nets.layout(self.cfg)
        self.leaves0 = weights.make(self.layout, seeds, self.device)

    def _steps(self) -> Dict[str, torch.Tensor]:
        """{net: [K]}: each replica's optimizer steps of `net` in one epoch,
        by the schedule (each present class's D, C and E+G loops), which is
        what the metric counts."""
        cfg = self.cfg
        classes = torch.tensor([len(np.unique(y)) for _, y in self.datasets])
        loops = {"discriminator": cfg["d_loop_num"], "classifier": cfg["c_loop_num"],
                 "encoder": cfg["g_loop_num"], "generator": cfg["g_loop_num"]}
        return {net: classes * n for net, n in loops.items()}

    def setup(self) -> None:
        cfg, traffic = self.cfg, self.traffic
        self.make_inputs()
        self.settings = program.settings(cfg, self.seed)
        self._build(self.settings)
        for k, (t, ds) in enumerate(zip(self.trainers, self.check_sets)):
            t._prepare(ds)
            program.check_trainer(t, cfg, self.layout)
            program.load_leaves(t, self.leaves0, k)
        steps = self._steps()
        self.steps_per_epoch = int(sum(steps[net].sum() for net in
                                       ("discriminator", "classifier", "generator")))
        calls = list(traffic["check_calls"])
        self.settings.gan.epochs = calls[0]
        self._fit(self.check_sets)
        self.prog_m = program.adam_moments(self.trainers)
        for n in calls[1:]:
            self.settings.gan.epochs = n
            self._fit(self.check_sets)
        self.prog_leaves = program.state_leaves(self.trainers)
        self.prog_losses = program.loss_history(self.trainers, ref_train.loss_keys(cfg),
                                                sum(calls))
        self.settings.gan.epochs = 1  # the window's graph, captured
        self._fit(self.datasets)
        self.settings.gan.epochs = int(traffic["epochs_per_call"])
        self.counts0 = program.adam_counts(self.trainers)
        self.snapshot = program.Snapshot(self.trainers)
        self.window_calls = 0

    # ------------------------------------------------------------- window
    def call(self) -> Dict[str, float]:
        self.snapshot.take()
        self._fit(self.datasets)
        self.window_calls += 1
        return {"steps": self.settings.gan.epochs * self.steps_per_epoch,
                "epochs": self.settings.gan.epochs * len(self.trainers)}

    def release(self) -> None:
        """Keep what the window produced for the comparison, then free the
        program."""
        epochs = self.settings.gan.epochs
        self.window = {
            "losses": program.loss_history(self.trainers, ref_train.loss_keys(self.cfg), 1,
                                           first=-epochs),
            "start": self.snapshot.start(),
            "counts": program.adam_counts(self.trainers),
            "counted": {net: self.window_calls * epochs * n for net, n in self._steps().items()},
        }
        self.trainers = self._fit = self.snapshot = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -------------------------------------------------------------- check
    def _data(self, sets) -> ref_train.Data:
        return ref_train.Data([torch.as_tensor(x, device=self.device) for x, _ in sets],
                              [torch.as_tensor(y, device=self.device) for _, y in sets],
                              self.cfg["label_num"])

    def reference(self, half_batch: bool = False) -> dict:
        """The plain reference over the same rows, weights, seeds and
        calls as set-up's."""
        return ref_train.fit(self.cfg, self.leaves0, self._data(self.check_sets), self.seeds(),
                             self.traffic["check_calls"], self.device, half_batch=half_batch)

    def window_reference(self, start: dict, half_batch: bool = False) -> dict:
        """The plain reference over one epoch of the frames from `start`."""
        return ref_train.fit(self.cfg, start["leaves"], self._data(self.datasets),
                             self.seeds(), [1], self.device, half_batch=half_batch,
                             start=start)

    def program_outputs(self) -> dict:
        return {"losses": self.prog_losses, "adam_m": self.prog_m, "leaves": self.prog_leaves}

    def compare(self, got: dict, ref: dict) -> Dict[str, dict]:
        """Set-up's numbers: `got` (the program's outputs, or a control's)
        against the reference's."""
        masks = compare.counted(ref["grad_rms"], ref["leaves"])
        loss, loss_at = compare.loss_gap(got["losses"], ref["losses"])
        out = {"loss_gap": {"value": loss, "at": loss_at}}
        for name, got_t, ref_t in (
                ("moment_gap", got["adam_m"], ref["adam_m"]),
                ("change_gap", compare.change(got["leaves"], self.leaves0),
                 compare.change(ref["leaves"], self.leaves0))):
            gaps, names = compare.norm_gaps(got_t, ref_t, masks)
            value, at = compare.worst_gap(gaps, names)
            out[name] = {"value": value, "at": at, "by_net": compare.by_net(gaps, names)}
            if name == "change_gap":
                value, at = compare.median_gap(gaps)
                out["change_gap_median"] = {"value": value, "at": at}
        out["change_gap"]["left_out"] = compare.left_out(masks, ref["leaves"])
        return out

    def compare_window(self, losses: torch.Tensor, ref: dict) -> Dict[str, dict]:
        """The window's loss number: the first epoch of its last call
        (`losses`, `[1, K, keys]`) against the reference's from that call's
        start."""
        value, at = compare.loss_gap(losses, ref["losses"])
        return {"window_loss_gap": {"value": value, "at": at}}

    def check(self) -> Dict[str, dict]:
        out = self.compare(self.program_outputs(), self.reference())
        w = self.window
        out.update(self.compare_window(w["losses"], self.window_reference(w["start"])))
        moved = {net: w["counts"][net] - self.counts0[net] for net in w["counts"]}
        gap = max(int((moved[net] - w["counted"][net]).abs().max()) for net in moved)
        out["window_steps_gap"] = {
            "value": float(gap),
            "at": {net: [int(moved[net].min()), int(moved[net].max()),
                         int(w["counted"][net].max())] for net in moved}}
        return out
