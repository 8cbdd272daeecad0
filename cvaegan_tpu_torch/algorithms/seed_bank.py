"""Seed-parallel training: K independent replicas in one captured epoch,
the counterpart of `cvaegan_tpu/algorithms/seed_bank.py`.

A strict CVAE-GAN epoch is ~25k small kernels, so on a GPU a fit is
bound by the kernel count, not by the arithmetic. `SeedBank` trains K
replicas of one trainer class (one per seed) with each kernel run once
for all of them: the replicas' networks are stacked into banked networks
whose tensors carry a leading replica axis (`models/banked.py`), and the
trainer's own epoch (`_epoch_body`, its D, C and G steps) runs on
`[K, batch, features]` operands (`[K, batch, seq, features]` inside
RAIN-GAN's attention stacks), each matmul one batched matmul over K.
The JAX package gets the same by `vmap`ping the epoch. On CUDA the whole
banked epoch is captured as one CUDA graph and replayed once per epoch,
as a trainer's `fit` does.

What each replica sees is its serial fit's:
  * random draws: each replica keeps its trainer's own `torch.Generator`,
    seeded as its serial trainer, and draws every input (batch indices,
    z, eps, dropout masks, CTGAN's column masks and interpolation alpha,
    QG-SMOTE's quantile alpha, TMG-GAN's diversity z) in the same order
    and at the same shapes as a serial `fit`, into its slice of a `[K,
    ...]` buffer; all K generators are registered with the graph;
  * losses: each replica's loss is the mean over its own batch; the
    backward pass takes their sum, so each replica's parameters get the
    gradient of their own loss alone; Adam is per replica, with a step
    count `[K]`;
  * data: replicas may hold different datasets of one shape (the
    multi-seed study's per-seed fixtures); each draws with its own class
    sizes, from index tables padded to the widest;
  * absent classes in strict mode: a class round runs when any replica
    has the class; a replica that lacks it keeps its whole state through
    the round (parameters, BatchNorm statistics, spectral u/v, Adam
    moments and count: TMG-GAN's replica keeps the class's generator and
    its Adam) and draws nothing, and its history records its
    last present round's losses, as JAX's `_guard_class_round` does.

After `fit`, `trainers[k]` is a full trainer of `seeds[k]` with the whole
per-trainer API. Epoch-cadenced host hooks (`_on_chunk_end`: RAIN-GAN's
attention history, TMG-GAN's scatters) are skipped in bank mode, as in
the JAX package.

With `mesh=` (a `parallel.mesh.Mesh`) the replicas are split over the
mesh's 'data' axis, as the JAX package shards the replica axis: each data
rank trains its K/n replicas as one bank, with no collective inside the
epoch, and at the end of `fit` every replica's state, optimizer state,
generator state and loss history are all-gathered, so that `trainers[k]`
on every rank is replica k.

    bank = SeedBank(CVAEGAN, seeds=range(16), balanced_mode=True)
    trainers = bank.fit(datasets)          # one dataset, or one per seed
    trainers[7].generate_samples_fast(2, 8192)
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cvaegan_tpu_torch.algorithms.base import GenerativeTrainer
from cvaegan_tpu_torch.core import config as config_lib
from cvaegan_tpu_torch.core.state import Adam
from cvaegan_tpu_torch.data.sampler import INT32_MAX
from cvaegan_tpu_torch.models import banked
from cvaegan_tpu_torch.parallel import mesh as mesh_lib
from cvaegan_tpu_torch.utils import profiling


class _Banked:
    """Mixin over a trainer class: the class's own steps and epoch on K
    replicas at once. Its draw methods and `_rounds` replace the
    trainer's; the networks, optimizers, generator and data are the
    banked ones `_build_bank` sets."""

    def _generators(self) -> List[torch.Generator]:
        return self.generator.generators

    def _on_chunk_end(self, epochs_done: int) -> None:
        """Skipped in bank mode, as in the JAX package: per-replica host
        work."""

    # ------------------------------------------------------------ draws
    @profiling.spanned("step.draw")
    def _uniform(self, shape) -> torch.Tensor:
        return self.generator.rand(shape)

    @profiling.spanned("step.draw")
    def _normal(self, shape) -> torch.Tensor:
        return self.generator.randn(shape)

    def _labels(self, target_label: int, num: int) -> torch.Tensor:
        return torch.full((self._k, num), int(target_label), dtype=torch.int64,
                          device=self.device)

    def _rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows `idx [K, n]` of each replica's samples -> `[K, n, features]`."""
        return self._data["samples"][self._replica_ids, idx]

    def _present_labels(self, num: int) -> torch.Tensor:
        """`sampler.present_labels` per replica: uniform over its present
        classes, through its order table (the identity when all are
        present)."""
        raw = self.generator.randint(self._data["label_highs"], (num,))
        return self._data["order"].gather(1, raw)

    @profiling.spanned("step.draw")
    def _sample_batch(self, class_id: Optional[int]):
        bs, data = self.gan_cfg.batch_size, self._data
        if self.balanced_mode:
            labels = self._present_labels(bs)
            counts = torch.clamp_min(data["counts"].gather(1, labels), 1)
            r = self.generator.randint([INT32_MAX] * self._k, (bs,))
            return self._rows(data["table"][self._replica_ids, labels, r % counts]), labels
        counts = torch.clamp_min(data["counts"][:, class_id, None], 1)
        r = self.generator.randint([INT32_MAX] * self._k, (bs,))
        return (self._rows(data["table"][:, class_id].gather(1, r % counts)),
                self._labels(class_id, bs))

    @profiling.spanned("step.draw")
    def _sample_labels(self, class_id: Optional[int]) -> torch.Tensor:
        bs = self.gan_cfg.batch_size
        if self.balanced_mode:
            return self._present_labels(bs)
        return self._labels(class_id, bs)

    @profiling.spanned("step.draw")
    def _random_batch(self):
        n = self._data["samples"].shape[1]
        r = self.generator.randint([n] * self._k, (self.gan_cfg.batch_size,))
        return self._rows(r), self._data["labels"].gather(1, r)

    def _pattern(self) -> tuple:
        return tuple((self._data["host_counts"] > 0).ravel().tolist())

    def _replica_steps_per_epoch(self) -> int:
        return self._held_steps

    # ----------------------------------------------------------- rounds
    def _class_rounds(self) -> List[Optional[int]]:
        return self._union_rounds

    def _rounds(self, round_fn):
        """Every round any replica has. In a round that some replicas lack,
        those draw nothing and get their state back afterwards, and their
        losses stay those of their last present round."""
        out = None
        for class_id in self._union_rounds:
            active = self._active[class_id]
            if all(active):
                out = round_fn(class_id)
                continue
            mask = self._masks[class_id]
            static = self._static_tensors()[:-1]  # every state and Adam tensor
            with torch.no_grad():
                saved = [t.clone() for t in static]
            self.generator.active = active
            try:
                new = round_fn(class_id)
            finally:
                self.generator.active = [True] * self._k
            with torch.no_grad():
                for t, s in zip(static, saved):
                    t.copy_(torch.where(mask.view(-1, *[1] * (t.dim() - 1)), t, s))
            out = new if out is None else {
                k: torch.where(mask, v, out[k]) for k, v in new.items()}
        return out


def _banked_class(cls):
    return type(f"Banked{cls.__name__}", (_Banked, cls), {})


class SeedBank:
    """Train K same-architecture replicas (one per seed) concurrently.

    `cls` is any of the port's 11 trainers, as in the JAX package; the
    other parameters are the trainer's (`ema_filter` where the trainer
    takes it; TMG-GAN refuses `balanced_mode`, as its trainer does).
    After `fit`, `self.trainers[k]` is a fully trained, independently
    usable trainer for `seeds[k]`."""

    def __init__(self, cls, seeds: Sequence[int],
                 settings: Optional[config_lib.Settings] = None,
                 balanced_mode: bool = False, ema_filter: bool = False,
                 device="cuda", mesh=None):
        if len(seeds) == 0:
            raise ValueError("SeedBank needs at least one seed")
        if mesh is not None:
            if not isinstance(mesh, mesh_lib.Mesh):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
            n_data = mesh.shape.get("data", 1)
            if len(seeds) % n_data:
                raise ValueError(
                    f"{len(seeds)} seeds do not divide the mesh's "
                    f"'data' axis ({n_data})")
        self.mesh = mesh
        self.seeds = list(seeds)
        self.settings = settings or config_lib.settings
        # `ema_filter` only where asked for: TMG-GAN's trainer takes none
        extra = {"ema_filter": True} if ema_filter else {}
        self.trainers = [cls(seed=s, settings=self.settings, device=device,
                             balanced_mode=balanced_mode, **extra)
                         for s in self.seeds]
        #: wall-clock seconds of the last `fit` (stacking, capture and every
        #: epoch, host sync included)
        self.fit_seconds: float = 0.0
        #: aggregate optimizer steps/s across all replicas in the last
        #: `fit` (each replica counted with its own class rounds); 0 until
        #: fit runs
        self.steps_per_sec: float = 0.0
        #: the banked trainer, kept across fits so that a later fit can
        #: replay the same captured epoch
        self._bank = None
        #: the replicas this rank trains: all of them, or its data rank's
        #: share under a mesh
        self._held = self.trainers
        if mesh is not None:
            per = len(self.seeds) // mesh.shape["data"]
            lo = mesh.local_rank("data") * per
            self._held = self.trainers[lo:lo + per]

    # ------------------------------------------------------------------ fit
    @profiling.spanned("bank.fit")
    def fit(self, datasets, eager: bool = False) -> List[GenerativeTrainer]:
        """Train all replicas for `settings.gan.epochs` epochs; `datasets`
        is one dataset (shared by every replica) or a sequence of exactly
        `len(seeds)` datasets. Returns `self.trainers`.

        Calling `fit` again continues training from the trained replica
        states, as a trainer's `fit` does. On CUDA each epoch is a replay
        of one captured CUDA graph; `eager=True` runs the plain version.
        Under `mesh=` every rank of the mesh calls it. Spans: `bank.fit`,
        and in it `bank.prepare` (each replica's `fit.prepare`),
        `bank.load`, the banked trainer's `fit.capture`, `fit.epochs` and
        `fit.chunk_end`, and `bank.store`."""
        t0 = time.time()
        if not isinstance(datasets, (list, tuple)):
            datasets = [datasets] * len(self.trainers)
        if len(datasets) != len(self.trainers):
            raise ValueError(f"{len(self.trainers)} seeds but {len(datasets)} datasets")
        with mesh_lib.use_mesh(None):  # a bank's epoch has no collective
            with profiling.span("bank.prepare"):
                for t, ds in zip(self.trainers, datasets):
                    t._prepare(ds)
            shapes = {tuple(t._data["samples"].shape) for t in self.trainers}
            if len(shapes) != 1:
                raise ValueError(f"replica train sets must share one shape, got {shapes}")
            if len({t.label_num for t in self.trainers}) != 1:
                raise ValueError("replica datasets must share label_num")

            with profiling.span("bank.load"):
                bank = self._load()
            epochs = bank.gan_cfg.epochs
            bank._fit_prepared(epochs, eager=eager)
            with profiling.span("bank.store"):
                self._store()
        for key, rows in bank.loss_history.items():
            for k, t in enumerate(self._held):
                t.loss_history[key].extend(row[k] for row in rows)
            rows.clear()
        if self.mesh is not None:
            self._gather(epochs)
        if bank.device.type == "cuda":
            torch.cuda.synchronize(bank.device)
        self.fit_seconds = time.time() - t0
        steps = epochs * sum(t._steps_per_epoch() for t in self.trainers)
        self.steps_per_sec = steps / max(self.fit_seconds, 1e-9)
        return self.trainers

    def _gather(self, epochs: int) -> None:
        """Give every rank every replica: each data rank's replicas'
        state, optimizer state, generator state and last `epochs` of loss
        history, all-gathered over the mesh's 'data' axis."""
        def items(t):
            history = torch.tensor([t.loss_history[k][-epochs:] for k in t.loss_keys],
                                   dtype=torch.float32).reshape(len(t.loss_keys), epochs)
            return [*t._static_tensors()[:-1], history, t.generator.get_state()]

        gathered = mesh_lib.all_gather_items([items(t) for t in self._held], self.mesh)
        with torch.no_grad():
            for t, got in zip(self.trainers, gathered):
                if t in self._held:
                    continue
                *tensors, history, rng_state = got
                for dst, src in zip(t._static_tensors()[:-1], tensors):
                    dst.copy_(src)
                t.generator.set_state(rng_state.cpu().clone())
                for k, row in zip(t.loss_keys, history.tolist()):
                    t.loss_history[k].extend(row)
                t._clear_gen_caches()

    # -------------------------------------------------------- stack/unstack
    def _load(self):
        """The banked trainer, holding the replicas' current states,
        optimizer states and data: built anew when a replica's networks or
        data changed identity or shape, else refilled in place, so that
        its captured epoch stays valid."""
        key = [(id(t.state), tuple(t._data["samples"].shape),
                tuple(t._data["index"].table.shape)) for t in self._held]
        if self._bank is None or self._bank[0] != key:
            self._bank = (key, self._build_bank())
        bank = self._bank[1]
        for name, net in bank.state.items():
            banked.load(net, [t.state[name] for t in self._held])
        with torch.no_grad():
            for name, opt in bank.optimizers.items():
                replicas = [t.optimizers[name].tensors() for t in self._held]
                for dst, srcs in zip(opt.tensors(), zip(*replicas)):
                    dst.copy_(torch.stack(srcs))
        data = self._bank_data()
        if bank._data is not None and np.array_equal(bank._data["host_counts"],
                                                     data["host_counts"]):
            with torch.no_grad():
                for k, v in data.items():
                    if isinstance(v, torch.Tensor):
                        bank._data[k].copy_(v)
        else:
            self._set_data(bank, data)
        bank._held_steps = sum(t._steps_per_epoch() for t in self._held)
        return bank

    def _store(self) -> None:
        """Hand each trainer its replica's state and optimizer state."""
        bank = self._bank[1]
        for name, net in bank.state.items():
            banked.store(net, [t.state[name] for t in self._held])
        with torch.no_grad():
            for name, opt in bank.optimizers.items():
                for k, t in enumerate(self._held):
                    for dst, src in zip(t.optimizers[name].tensors(), opt.tensors()):
                        dst.copy_(src[k])
        for t in self._held:
            t._clear_gen_caches()

    def _build_bank(self):
        """A banked trainer of the replicas' class, with banked networks
        and optimizers of their shapes and the replicas' generators."""
        trainers = self._held
        template = trainers[0]
        bank = object.__new__(_banked_class(type(template)))
        bank.__dict__.update(vars(template))
        k, device = len(trainers), template.device
        bank.verbose = False
        bank._k = k
        bank.state = nn.ModuleDict({
            name: banked.stack([t.state[name] for t in trainers])
            for name in template.state.keys()})
        # an optimizer is named by its network's path in the state
        # (TMG-GAN's `gens.{i}`)
        bank.optimizers = {
            name: Adam(list(bank.state.get_submodule(name).parameters()), opt.lr, opt.b1,
                       opt.b2, opt.eps, replicas=k)
            for name, opt in template.optimizers.items()}
        bank.generator = banked.ReplicaGenerators([t.generator for t in trainers], device)
        bank.loss_history = {key: [] for key in template.loss_keys}
        bank._gen_caches = {}
        bank._epoch_t = torch.zeros((), dtype=torch.float32, device=device)
        bank._losses_out = torch.zeros((len(template.loss_keys), k), device=device)
        bank._replica_ids = torch.arange(k, device=device)[:, None]
        bank._data = None
        bank._drop_graphs()
        return bank

    def _bank_data(self) -> Dict:
        """The replicas' data stacked: samples `[K, N, F]`, labels `[K, N]`,
        index tables padded to the widest `[K, C, W]`, class sizes `[K, C]`
        (and on the host), and what `sampler.present_labels` draws from for
        each replica: its present classes in order, padded with 0, `[K, C]`,
        and their number (all C when every class or none is present)."""
        ts = self._held
        width = max(int(t._data["index"].table.shape[1]) for t in ts)
        label_num = ts[0].label_num
        orders = []
        for t in ts:
            present = t._data["index"].present()
            if len(present) in (0, label_num):
                present = np.arange(label_num)
            orders.append(present)
        device = ts[0].device
        return {
            "samples": torch.stack([t._data["samples"] for t in ts]),
            "labels": torch.stack([t._data["labels"] for t in ts]),
            "table": torch.stack([F.pad(t._data["index"].table,
                                        (0, width - t._data["index"].table.shape[1]))
                                  for t in ts]),
            "counts": torch.stack([t._data["index"].counts for t in ts]),
            "host_counts": np.stack([t._data["index"].host_counts for t in ts]),
            "order": torch.as_tensor(
                np.stack([np.pad(o, (0, label_num - len(o))) for o in orders]),
                dtype=torch.int64, device=device),
            "label_highs": [len(o) for o in orders],
        }

    def _set_data(self, bank, data: Dict) -> None:
        """Give the banked trainer new data, and the class rounds, the
        replicas active in each and their masks that the data implies."""
        bank._data = data
        rounds = [t._class_rounds() for t in self._held]
        if all(r == [None] for r in rounds):
            union: List[Optional[int]] = [None]
        else:
            union = sorted(set().union(*rounds))
        bank._union_rounds = union
        bank._active = {c: [c in r for r in rounds] for c in union}
        bank._masks = {c: torch.tensor(a, device=bank.device)
                       for c, a in bank._active.items()}
        bank._drop_graphs()  # the old data's tensors may be freed and reused
