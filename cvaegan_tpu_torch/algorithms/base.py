"""Serving half of the uniform trainer API, the counterpart of
`cvaegan_tpu/algorithms/base.py`.

Reference API parity (`src/cvae_gan.py:339,347,380`):
generate_samples(label, num), generate_qualified_samples(label, num,
threshold), reconstruct_samples(samples, labels). `fit` belongs to the
training slice; until it lands, a trainer's networks come from
`_prepare(dataset)` (fresh weights) or `load_jax_state(tree)` (weights
carried across from the JAX package, see `convert.py`).

Execution model: each trainer holds its networks as an `nn.ModuleDict`
on an explicit device (`device="cuda"` unless the caller asks for the
CPU) and one `torch.Generator` on that device, seeded from `seed=` or
`settings.seed`, for every random draw. Weights are drawn on the CPU from
a generator with the same seed, so a seed gives the same weights on
every device.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from cvaegan_tpu_torch import convert
from cvaegan_tpu_torch.core import config as config_lib
from cvaegan_tpu_torch.core.state import resolve_device
from cvaegan_tpu_torch.data.tabular import TabularDataset
from cvaegan_tpu_torch.kernels import fused_mlp as fused
from cvaegan_tpu_torch.models.layers import one_hot

QUALIFIED_PATIENCE = 20


def _as_arrays(dataset) -> Tuple[np.ndarray, np.ndarray]:
    if isinstance(dataset, TabularDataset):
        return dataset.tr_samples, dataset.tr_labels
    if isinstance(dataset, tuple) and len(dataset) == 2:
        return np.asarray(dataset[0], np.float32), np.asarray(dataset[1], np.int32)
    raise TypeError("expected a TabularDataset or an (samples, labels) tuple, "
                    f"got {type(dataset)!r}")


class GenerativeTrainer:
    """Base class. Subclasses set `name` and `config_key` and implement
    `_build`, `_jax_dims`, `_generator_forward` and, where they have one,
    `_classifier_logits`."""

    name: str = "base"
    config_key: str = ""

    def __init__(self, seed: Optional[int] = None,
                 settings: Optional[config_lib.Settings] = None,
                 device="cuda", ema_filter: bool = False):
        self.settings = settings or config_lib.settings
        self.gan_cfg = self.settings.gan
        config_lib.check_compute_dtype(self.gan_cfg)
        self.device = resolve_device(device)
        #: filter qualified samples with an EMA copy of the companion
        #: classifier (kept in the state as `classifier_ema`).
        self.ema_filter = ema_filter
        self.hparams = dict(config_lib.MODEL_CONFIGS.get(self.config_key, {}))
        self.seed = self.settings.seed if seed is None else seed
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)

        self.feature_num: int = 0
        self.label_num: int = 0
        self.state: Optional[nn.ModuleDict] = None
        self._data: Optional[Dict[str, torch.Tensor]] = None

    # ------------------------------------------------------- subclass hooks
    def _build(self, init_generator: torch.Generator) -> Dict[str, nn.Module]:
        """Create the networks, initialised from `init_generator`, on
        `self.device`."""
        raise NotImplementedError

    @staticmethod
    def _jax_dims(tree) -> Tuple[int, int, int]:
        """(feature_num, label_num, z_size) of the JAX trainer's state tree."""
        raise NotImplementedError

    def _build_state(self) -> nn.ModuleDict:
        """`_build` plus the optional EMA-filter copy of the classifier."""
        nets = self._build(torch.Generator().manual_seed(self.seed))
        if self.ema_filter and "classifier" in nets:
            nets["classifier_ema"] = copy.deepcopy(nets["classifier"])
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

    # ---------------------------------------------------------------- setup
    def _prepare(self, dataset) -> None:
        samples, labels = _as_arrays(dataset)
        self.feature_num = int(samples.shape[1])
        self.label_num = int(labels.max()) + 1 if labels.size else 0
        self._data = {
            "samples": torch.as_tensor(samples, device=self.device),
            "labels": torch.as_tensor(labels, device=self.device),
        }
        if self.state is None:
            self.state = self._build_state()

    def load_jax_state(self, tree) -> None:
        """Take the weights of the JAX trainer of the same name (plain
        nested dicts of numpy arrays, one per network, see
        `convert.state_from_jax`), building the networks from the tree's
        shapes if needed."""
        feature_num, label_num, z_size = self._jax_dims(tree)
        if z_size != self.gan_cfg.z_size:
            raise ValueError(f"the tree's generator takes z of {z_size}, "
                             f"settings.gan.z_size is {self.gan_cfg.z_size}")
        if self.state is None or (feature_num, label_num) != (
                self.feature_num, self.label_num):
            self.feature_num, self.label_num = feature_num, label_num
            self.state = self._build_state()
        convert.state_from_jax(tree, self.state)

    def _require_state(self) -> None:
        config_lib.check_compute_dtype(self.gan_cfg)
        if self.state is None:
            raise RuntimeError(f"{self.name}: no networks yet; call _prepare() "
                               "or load_jax_state() first")

    def _labels(self, target_label: int, num: int) -> torch.Tensor:
        return torch.full((num,), int(target_label), dtype=torch.int64,
                          device=self.device)

    def _prior(self, num: int) -> torch.Tensor:
        return torch.randn((num, self.gan_cfg.z_size), generator=self.generator,
                           device=self.device)

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
