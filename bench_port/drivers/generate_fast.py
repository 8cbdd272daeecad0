"""Driver of the generation cells: repeated `generate_samples_fast` calls.

Set-up makes the seed's Car-Hacking window, whose class counts give each
minority class's shortfall against the majority class (the rows a user
asks for to balance the window), and the generator's weights from the
seed, with drawn BatchNorm statistics (speed does not depend on
training). It warms every shape with one call per class. The window
calls `generate_samples_fast(c, need_c)` for the classes in turn. Every
call's rows are checked for their shape; the rows of one call per class
at indices drawn from the seed, and of the last call, are kept and held
to the plain reference once the window has closed.
"""

from __future__ import annotations

import gc
from typing import Dict

import numpy as np
import torch

from bench_port.data import car_hacking
from bench_port.harness import program, weights
from bench_port.reference import generate, nets


class Driver:
    span = "bench.generate"

    def __init__(self, ctx: dict):
        self.ctx = ctx
        self.cfg, self.traffic = ctx["cfg"], ctx["traffic"]
        self.device = torch.device(ctx["device"])
        self.seed = int(ctx["seed"])

    def make_inputs(self) -> None:
        """The window, each class's need and the generator's weights, from
        the seed; and which window calls are held to the reference."""
        cfg, traffic = self.cfg, self.traffic
        self.data = car_hacking.frames(int(traffic["frames"]), self.seed)
        counts = np.bincount(self.data[1], minlength=cfg["label_num"])
        top = int(counts.max())
        self.plan = [(int(c), top - int(counts[c])) for c in traffic["classes"]]
        self.layout = nets.layout(cfg)
        self.leaves0 = weights.make(self.layout, [self.seed], self.device, drawn_stats=True)
        rng = np.random.default_rng(self.seed)
        span = int(traffic["sample_span"])
        n_cls = len(self.plan)
        self.keep = {n_cls * int(r) + j for j, r in enumerate(rng.integers(0, span, n_cls))}

    def setup(self) -> None:
        cfg = self.cfg
        self.make_inputs()
        s = program.settings(cfg, self.seed)
        t = program.trainer_class(cfg)(seed=self.seed, settings=s, device=self.device)
        t.verbose = False
        t._prepare(self.data)
        program.check_trainer(t, cfg, self.layout)
        program.load_leaves(t, self.leaves0, 0)
        self.trainer = t
        self.calls = []
        self.kept: Dict[int, np.ndarray] = {}
        for c, n in self.plan:
            self._generate(c, n)
        self.i = 0
        self.failed = 0
        self.last = None

    def _generate(self, c: int, n: int) -> np.ndarray:
        out = self.trainer.generate_samples_fast(c, n)
        self.calls.append((c, n))
        return out

    def call(self) -> Dict[str, float]:
        c, n = self.plan[self.i % len(self.plan)]
        out = self._generate(c, n)
        ok = (isinstance(out, np.ndarray) and out.shape == (n, self.cfg["feature_num"])
              and out.dtype == np.float32)
        self.failed += 0 if ok else 1
        index = len(self.calls) - 1
        if self.i in self.keep:
            self.kept[index] = out
        self.last = (index, out)
        self.i += 1
        return {"rows": int(out.shape[0]) if ok else 0, "failed": 0 if ok else 1}

    def release(self) -> None:
        if self.last is not None:
            self.kept[self.last[0]] = self.last[1]
        self.trainer = None
        gc.collect()
        torch.cuda.empty_cache()

    def reference(self) -> Dict[int, torch.Tensor]:
        return generate.replay(self.cfg, self.leaves0["generator"], self.seed, self.calls,
                               self.kept, self.device)

    def compare(self, got: Dict[int, np.ndarray], ref: Dict[int, torch.Tensor]) -> Dict[str, dict]:
        """The widest gap of any kept row's value from the reference's (a
        call whose rows have another shape reads infinite), and the calls
        whose rows had the wrong shape or type."""
        gap, at, checked = 0.0, None, 0
        for i, rows in sorted(got.items()):
            want = ref[i]
            if tuple(rows.shape) != tuple(want.shape):
                gap, at = float("inf"), f"call {i}: shape {rows.shape}, want {tuple(want.shape)}"
                break
            worst = float((torch.as_tensor(rows, device=want.device) - want).abs().max())
            checked += rows.shape[0]
            if not worst <= gap:  # a larger gap, or NaN
                gap, at = (worst if worst == worst else float("inf")), f"call {i}"
        return {"max_abs_gap": {"value": gap, "at": at, "rows": checked},
                "bad_calls": {"value": float(self.failed)}}

    def check(self) -> Dict[str, dict]:
        return self.compare(self.kept, self.reference())
