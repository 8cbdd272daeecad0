"""The uniform trainer API, the counterpart of `cvaegan_tpu/algorithms/base.py`.

Reference API parity (`src/cvae_gan.py:59,339,347,380,263`):
fit(dataset), generate_samples(label, num),
generate_qualified_samples(label, num, threshold),
reconstruct_samples(samples, labels), loss_history, plot_loss_history().

Execution model: each trainer holds its networks as an `nn.ModuleDict`
on an explicit device (`device="cuda"` unless the caller asks for the
CPU), one `core.state.Adam` per network, and one `torch.Generator` on
that device, seeded from `seed=` or `settings.seed`, for every random
draw. Weights are drawn on the CPU from a generator with the same seed,
so a seed gives the same weights on every device.

Training: the JAX package compiles a whole epoch (classes x (5 D + 5 C +
3 G) optimizer steps) into one XLA program. The port's counterpart is one
CUDA graph per epoch: on CUDA, `fit` captures the epoch once (after a
warm-up of one step of each kind on the capture stream, whose effects on
the state and the generator are undone) and replays it once per epoch;
the epoch number is copied into a device scalar before each replay, and
the trainer's generator is registered with the graph, so each replay
draws fresh noise. Running the same epoch function without capture is the
plain version: it is what runs on the CPU, and on CUDA only when `fit` is
asked for it with `eager=True`. A failed capture raises.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from cvaegan_tpu_torch import convert
from cvaegan_tpu_torch.core import config as config_lib
from cvaegan_tpu_torch.core.state import Adam, resolve_device
from cvaegan_tpu_torch.data.sampler import (
    ClassIndex,
    present_labels,
    sample_balanced_batch,
    sample_class_batch,
)
from cvaegan_tpu_torch.data.tabular import TabularDataset
from cvaegan_tpu_torch.kernels import fused_mlp as fused
from cvaegan_tpu_torch.models.layers import one_hot

QUALIFIED_PATIENCE = 20
PRINT_EVERY = 50


def _as_arrays(dataset) -> Tuple[np.ndarray, np.ndarray]:
    if isinstance(dataset, TabularDataset):
        return dataset.tr_samples, dataset.tr_labels
    if isinstance(dataset, tuple) and len(dataset) == 2:
        return np.asarray(dataset[0], np.float32), np.asarray(dataset[1], np.int32)
    raise TypeError("expected a TabularDataset or an (samples, labels) tuple, "
                    f"got {type(dataset)!r}")


class GenerativeTrainer:
    """Base class. Subclasses set `name`, `config_key` and `loss_keys` and
    implement `_build`, `_build_optimizers`, `_jax_dims`, `_epoch_body`,
    `_warm_up`, `_generator_forward` and, where they have one,
    `_classifier_logits`."""

    name: str = "base"
    config_key: str = ""
    loss_keys: Tuple[str, ...] = ()
    #: epochs whose losses come back to the host in one transfer.
    epoch_chunk: int = 500
    #: set False to silence the progress prints.
    verbose: bool = True
    #: per-chunk checkpoints are ROADMAP item A19; `fit` raises if set.
    checkpoint_dir = None
    conditional_sampling: bool = True

    def __init__(self, seed: Optional[int] = None,
                 settings: Optional[config_lib.Settings] = None,
                 device="cuda", balanced_mode: bool = False,
                 ema_filter: bool = False):
        self.settings = settings or config_lib.settings
        self.gan_cfg = self.settings.gan
        config_lib.check_compute_dtype(self.gan_cfg)
        self.device = resolve_device(device)
        #: filter qualified samples with an EMA copy of the companion
        #: classifier (kept in the state as `classifier_ema`, updated once
        #: per epoch).
        self.ema_filter = ema_filter
        self.ema_decay = 0.99
        #: one class-balanced mixed D/C/G round per epoch instead of the
        #: reference's per-class round-robin.
        self.balanced_mode = balanced_mode
        self.hparams = dict(config_lib.MODEL_CONFIGS.get(self.config_key, {}))
        self.seed = self.settings.seed if seed is None else seed
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)

        self.feature_num: int = 0
        self.label_num: int = 0
        self.state: Optional[nn.ModuleDict] = None
        self.optimizers: Dict[str, Adam] = {}
        self._data: Optional[Dict] = None
        self.loss_history: Dict[str, list] = {k: [] for k in self.loss_keys}
        #: the epoch number and the epoch's losses, on the device: a
        #: captured epoch reads the one and writes the other
        self._epoch_t = torch.zeros((), dtype=torch.float32, device=self.device)
        self._losses_out = torch.zeros(len(self.loss_keys), device=self.device)
        #: (key, CUDAGraph) of the captured epoch
        self._graph = None

    # ------------------------------------------------------- subclass hooks
    def _build(self, init_generator: torch.Generator) -> Dict[str, nn.Module]:
        """Create the networks, initialised from `init_generator`, on
        `self.device`."""
        raise NotImplementedError

    def _build_optimizers(self, nets: Dict[str, nn.Module]) -> Dict[str, Adam]:
        """One optimizer per trained network."""
        return {}

    @staticmethod
    def _jax_dims(tree) -> Tuple[int, int, int]:
        """(feature_num, label_num, z_size) of the JAX trainer's state tree."""
        raise NotImplementedError

    def _epoch_body(self, epoch: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One training epoch at the epoch number `epoch` (a device scalar);
        returns the epoch's scalar losses by `loss_keys`."""
        raise NotImplementedError(f"{self.name}: training is not ported yet")

    def _warm_up(self) -> None:
        """One optimizer step of each kind the epoch runs, before capture."""
        raise NotImplementedError

    def _build_state(self) -> nn.ModuleDict:
        """`_build`, the optional EMA-filter copy of the classifier, and the
        optimizers."""
        nets = self._build(torch.Generator().manual_seed(self.seed))
        if self.ema_filter and "classifier" in nets:
            nets["classifier_ema"] = copy.deepcopy(nets["classifier"])
        self.optimizers = self._build_optimizers(nets)
        self._graph = None
        return nn.ModuleDict(nets)

    def _filter_state(self, state):
        """State used by the qualified-sample FILTER: the EMA classifier
        when enabled, the live one otherwise."""
        if "classifier_ema" in state:
            return {**dict(state.items()), "classifier": state["classifier_ema"]}
        return state

    def _generator_forward(self, state, z: torch.Tensor,
                           labels: torch.Tensor) -> torch.Tensor:
        """Eval-mode generator forward -> samples [n, feature_num]."""
        raise NotImplementedError

    def _classifier_logits(self, state, x: torch.Tensor) -> Optional[torch.Tensor]:
        """Eval-mode companion-classifier logits, or None if the algorithm
        has no companion classifier."""
        return None

    # ------------------------------------------------------------- sampling
    def _sample_batch(self, class_id: Optional[int]):
        """(x_real, labels) for one conditional update: rows of class
        `class_id` in strict mode, a class-balanced mixed batch in
        balanced_mode (where `class_id` is None)."""
        bs, data = self.gan_cfg.batch_size, self._data
        if self.balanced_mode:
            return sample_balanced_batch(self.generator, data["index"],
                                         data["samples"], bs)
        x = sample_class_batch(self.generator, data["index"], data["samples"],
                               class_id, bs)
        return x, self._labels(class_id, bs)

    def _sample_labels(self, class_id: Optional[int]) -> torch.Tensor:
        """Labels for updates that need no real batch: the target class in
        strict mode, uniform over the present classes in balanced_mode."""
        bs = self.gan_cfg.batch_size
        if self.balanced_mode:
            return present_labels(self.generator, (bs,), self._data["index"])
        return self._labels(class_id, bs)

    def _class_rounds(self) -> List[Optional[int]]:
        """The class rounds of one epoch: one mixed round (None) in
        balanced_mode, else one round per PRESENT class in order. The JAX
        package scans every class and masks the absent ones' rounds
        (`_guard_class_round`), recording the last present round's losses;
        the port's data is fixed for the whole fit, so the absent rounds
        are left out when the epoch is built, with the same result."""
        if self.balanced_mode:
            return [None]
        return [int(c) for c in self._data["index"].present()]

    # ---------------------------------------------------------------- setup
    def _prepare(self, dataset) -> None:
        samples, labels = _as_arrays(dataset)
        self.feature_num = int(samples.shape[1])
        self.label_num = int(labels.max()) + 1 if labels.size else 0
        index = ClassIndex.build(labels, self.label_num, device=self.device)
        old = self._data
        if (old is not None and old["samples"].shape == samples.shape
                and old["index"].table.shape == index.table.shape
                and np.array_equal(old["index"].host_counts, index.host_counts)):
            # Same shapes and class sizes: refill the tensors a captured
            # epoch reads, in place.
            old["samples"].copy_(torch.as_tensor(samples))
            old["labels"].copy_(torch.as_tensor(labels))
            old["index"].table.copy_(index.table)
        else:
            self._data = {
                "samples": torch.as_tensor(samples, device=self.device),
                "labels": torch.as_tensor(labels, device=self.device),
                "index": index,
            }
            self._graph = None
        if self.state is None:
            self.state = self._build_state()

    def load_jax_state(self, tree) -> None:
        """Take the weights of the JAX trainer of the same name (plain
        nested dicts of numpy arrays, one per network, see
        `convert.state_from_jax`; a network's `opt_state` goes into its
        optimizer), building the networks from the tree's shapes if
        needed."""
        feature_num, label_num, z_size = self._jax_dims(tree)
        if z_size != self.gan_cfg.z_size:
            raise ValueError(f"the tree's generator takes z of {z_size}, "
                             f"settings.gan.z_size is {self.gan_cfg.z_size}")
        if self.state is None or (feature_num, label_num) != (
                self.feature_num, self.label_num):
            self.feature_num, self.label_num = feature_num, label_num
            self.state = self._build_state()
        convert.state_from_jax(tree, self.state, self.optimizers)

    def _require_state(self) -> None:
        config_lib.check_compute_dtype(self.gan_cfg)
        if self.state is None:
            raise RuntimeError(f"{self.name}: no networks yet; call fit(), "
                               "_prepare() or load_jax_state() first")

    def _labels(self, target_label: int, num: int) -> torch.Tensor:
        return torch.full((num,), int(target_label), dtype=torch.int64,
                          device=self.device)

    def _prior(self, num: int) -> torch.Tensor:
        return torch.randn((num, self.gan_cfg.z_size), generator=self.generator,
                           device=self.device)

    # ------------------------------------------------------------------ fit
    def fit(self, dataset, eager: bool = False) -> None:
        """Train for `settings.gan.epochs` epochs. On CUDA each epoch is a
        replay of one captured CUDA graph; `eager=True` runs the plain
        version instead (the epoch op by op), as the CPU always does."""
        if self.checkpoint_dir is not None:
            raise NotImplementedError(
                f"{self.name}: per-chunk checkpoints are not ported yet "
                "(ROADMAP A19)")
        self._prepare(dataset)
        self._fit_prepared(self.gan_cfg.epochs, eager=eager)

    def fit_streamed(self, *args, **kwargs):
        raise NotImplementedError(
            f"{self.name}: out-of-core fits are not ported yet (ROADMAP A18)")

    def _fit_prepared(self, epochs: int, eager: bool = False) -> None:
        """Run `epochs` epochs on `self._data`/`self.state`; the losses of
        each `epoch_chunk` epochs come to the host in one transfer."""
        self._require_state()
        chunk = max(1, min(self.epoch_chunk, epochs))
        if eager or self.device.type != "cuda":
            run = self._epoch
        else:
            run = self._captured_epoch()
        history = torch.zeros((chunk, len(self.loss_keys)), device=self.device)
        e = 0
        while e < epochs:
            n = min(chunk, epochs - e)
            for i in range(n):
                self._epoch_t.fill_(e + i)
                run()
                history[i].copy_(self._losses_out)
            losses = history[:n].cpu().numpy()
            for j, k in enumerate(self.loss_keys):
                self.loss_history[k].extend(losses[:, j].tolist())
            if self.verbose and self.loss_keys:
                for i in range(0, n, PRINT_EVERY):
                    head = ", ".join(f"{k}: {losses[i, j]:.4f}"
                                     for j, k in enumerate(self.loss_keys))
                    print(f"{self.name} epoch {e + i}/{epochs}, {head}")
            e += n

    def _epoch(self) -> None:
        """One epoch at `self._epoch_t`: the body, its losses into
        `self._losses_out`, and the EMA of the classifier's parameters
        (e <- d e + (1 - d) p, d = `ema_decay`). Reads no value on the
        host."""
        losses = self._epoch_body(self._epoch_t)
        with torch.no_grad():
            self._losses_out.copy_(torch.stack([losses[k] for k in self.loss_keys]))
            if "classifier_ema" in self.state:
                d = self.ema_decay
                ema = list(self.state["classifier_ema"].parameters())
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, torch._foreach_mul(
                    list(self.state["classifier"].parameters()), 1.0 - d))

    def _static_tensors(self) -> List[torch.Tensor]:
        """Every tensor an epoch updates in place."""
        tensors = list(self.state.state_dict(keep_vars=True).values())
        for opt in self.optimizers.values():
            tensors += opt.tensors()
        return [*tensors, self._losses_out]

    def _capture_key(self):
        cfg = self.gan_cfg
        return (id(self.state), id(self._data["samples"]), self.balanced_mode,
                tuple(self._class_rounds()),
                tuple(self._data["index"].host_counts.tolist()),
                cfg.batch_size, cfg.d_loop_num, cfg.c_loop_num, cfg.g_loop_num,
                tuple(sorted(self.hparams.items())), self.ema_decay)

    def _captured_epoch(self):
        """The replay of this trainer's captured epoch, capturing it first
        unless a capture for the same state, data, mode, class rounds and
        settings exists."""
        key = self._capture_key()
        if self._graph is not None and self._graph[0] == key:
            return self._graph[1].replay
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                "this torch cannot register a generator with a CUDA graph "
                "(CUDAGraph.register_generator_state); fit(eager=True) runs the "
                "plain version")
        self._graph = None
        stream = torch.cuda.Stream(device=self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        static = self._static_tensors()
        with torch.no_grad():
            saved = [t.detach().clone() for t in static]
        rng_state = self.generator.get_state()
        with torch.cuda.stream(stream):
            self._warm_up()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        with torch.no_grad():
            for t, s in zip(static, saved):
                t.copy_(s)
        self.generator.set_state(rng_state)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph, stream=stream):
            self._epoch()
        self._graph = (key, graph)
        return graph.replay

    # ------------------------------------------------------------ generation
    @torch.no_grad()
    def generate_samples(self, target_label: int, num: int) -> np.ndarray:
        """Sample `num` rows of class `target_label` from the prior
        (reference `src/cvae_gan.py:339-345`), as float32 numpy."""
        self._require_state()
        labels = self._labels(target_label, num)
        out = self._generator_forward(self.state, self._prior(num), labels)
        return out.to(torch.float32).cpu().numpy()

    @torch.no_grad()
    def generate_samples_fast(self, target_label: int, num: int) -> np.ndarray:
        """Prior sampling through the fused generator kernel
        (`kernels/fused_mlp.py`): eval-mode BatchNorm folded into the
        matmuls, all four layers in one launch. The final activation is
        the generator's own. Only available for the standard MLP
        generator; raises NotImplementedError otherwise."""
        self._require_state()
        gen = self.state["generator"]
        labels = self._labels(target_label, num)
        z = self._prior(num)
        final = getattr(gen, "out_activation", None) or "none"
        try:
            out = fused.fast_generator_forward(
                gen, z, one_hot(labels, self.label_num), final=final)
        except NotImplementedError as e:
            raise NotImplementedError(
                f"{self.name}: {e}; use generate_samples()") from e
        return out.cpu().numpy()

    @torch.no_grad()
    def generate_qualified_samples(
        self, target_label: int, num: int,
        confidence_threshold: Optional[float] = None,
    ) -> np.ndarray:
        """Classifier-filtered generation (reference
        `src/cvae_gan.py:347-378`): keep samples with max softmax prob >
        threshold AND argmax == target_label; give up once a cumulative
        budget of 20 zero-survivor candidate batches is spent (never
        refunded on success). Candidate batches are min(4096, capacity)
        rows, where the capacity is the smallest power of two >=
        max(num, 256), as in the JAX package. A host loop drives one
        candidate batch per iteration on the device."""
        self._require_state()
        if confidence_threshold is None:
            confidence_threshold = self.hparams.get("confidence_threshold", 0.5)
        if num <= 0:
            return np.empty((0, self.feature_num), np.float32)
        cap = 256
        while cap < num:
            cap *= 2
        cand = min(4096, cap)
        labels = self._labels(target_label, cand)
        fstate = self._filter_state(self.state)

        kept, count, patience = [], 0, QUALIFIED_PATIENCE
        while count < num and patience > 0:
            x = self._generator_forward(self.state, self._prior(cand), labels)
            probs = torch.softmax(self._classifier_logits(fstate, x), dim=-1)
            valid = ((probs.amax(dim=-1) > confidence_threshold)
                     & (probs.argmax(dim=-1) == labels))
            rows = x[valid]
            if rows.shape[0] == 0:
                patience -= 1
                continue
            rows = rows[: num - count]
            kept.append(rows)
            count += rows.shape[0]
        if not kept:
            return np.empty((0, self.feature_num), np.float32)
        return torch.cat(kept).to(torch.float32).cpu().numpy()

    def reconstruct_samples(self, samples, labels) -> np.ndarray:
        """Encode-then-decode round trip (reference
        `src/cvae_gan.py:380-397`). Only meaningful for VAE-family models;
        others raise."""
        raise NotImplementedError(f"{self.name} has no encoder")

    # ---------------------------------------------------------- diagnostics
    def get_feature_importance(self, net: str = "discriminator"):
        """Per-input-feature mean |W| of a network's first dense layer
        (reference `src/models/cvae_gan_models.py:231-247,285-292`): for
        conditional networks (data_importance, condition_importance), for
        the classifier a single vector."""
        from cvaegan_tpu_torch.utils import introspection

        self._require_state()
        if net not in self.state:
            raise KeyError(f"{self.name} has no network {net!r}; "
                           f"available: {sorted(self.state.keys())}")
        if net == "classifier":
            return introspection.first_layer_importance(self.state[net])
        return introspection.split_importance(self.state[net], self.feature_num)

    def plot_loss_history(self):
        """Per-loss curves + a combined plot saved under gan_outs
        (reference `src/cvae_gan.py:263-337`). Needs matplotlib."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        keys = [k for k in self.loss_keys if self.loss_history.get(k)]
        if not keys:
            return None
        rows = (len(keys) + 1) // 2
        plt.figure(figsize=(12, 4 * rows))
        for i, k in enumerate(keys):
            plt.subplot(rows, 2, i + 1)
            plt.plot(self.loss_history[k])
            plt.xlabel("Epoch")
            plt.ylabel("Loss")
            plt.title(k)
        plt.tight_layout()
        out = self.settings.paths.gan_outs / f"{self.name}_loss_history.jpg"
        plt.savefig(out)
        plt.close()

        plt.figure(figsize=(12, 6))
        for k in keys:
            vals = self.loss_history[k]
            if k == "adv_loss":
                plt.plot([abs(v) for v in vals], label=f"{k} (abs)")
            else:
                plt.plot(vals, label=k)
        plt.xlabel("Epoch")
        plt.ylabel("Loss")
        plt.title(f"{self.name} loss history")
        plt.legend()
        plt.grid(True, alpha=0.3)
        out2 = self.settings.paths.gan_outs / f"{self.name}_combined_loss.jpg"
        plt.savefig(out2)
        plt.close()
        print(f"loss curves saved to {out} and {out2}")
        return out
