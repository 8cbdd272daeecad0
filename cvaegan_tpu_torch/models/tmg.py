"""The TMG-GAN model family, the counterparts of `cvaegan_tpu/models/tmg.py`
(reference `src/models/tmg_gan_models.py`).

The CD network is a shared spectral-norm trunk with two heads: a critic
score and SOFTMAX class probabilities (`:9-47`). The reference feeds those
probabilities straight into `cross_entropy`, which applies log-softmax
again (`src/tmg_gan.py:75-79`); the trainer reproduces that by applying
the standard cross entropy to them.

The per-class generator (`:50-94`): z -> MLP trunk -> Dense -> tanh, the
trunk's output exposed as the hidden state. The trainer holds one per
class (the JAX package stacks their parameters and vmaps one module).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from cvaegan_tpu_torch.models.layers import (
    Dense,
    Dropout,
    MLPTrunk,
    SpectralDense,
    hidden_sizes,
    leaky_relu,
)


class TMGCD(nn.Module):
    """x -> 3 x [SpectralDense + LeakyReLU(0.2)], Dropout(0.3) after the
    first two (h3 pinned to 64) -> (SpectralDense(1) score,
    softmax(Dense(num_classes)) probabilities, the trunk's hidden state)."""

    def __init__(self, input_dim: int, num_classes: int):
        super().__init__()
        dims = [input_dim, *hidden_sizes(input_dim, pin_h3=True)]
        self.layers = nn.ModuleList(SpectralDense(dims[i], dims[i + 1]) for i in range(3))
        self.score = SpectralDense(dims[-1], 1)
        self.classes = Dense(dims[-1], num_classes)
        self.dropout = Dropout(0.3)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        l1, l2, l3 = self.layers
        h = self.dropout(leaky_relu(l1(x)), generator)
        h = self.dropout(leaky_relu(l2(h)), generator)
        h = leaky_relu(l3(h))
        return self.score(h), torch.softmax(self.classes(h), dim=-1), h


class TMGGenerator(nn.Module):
    """z -> MLP trunk (hidden sizes from `feature_num`) -> tanh(Dense).
    Returns (samples, hidden)."""

    def __init__(self, latent_dim: int, feature_num: int):
        super().__init__()
        hs = hidden_sizes(feature_num)
        self.trunk = MLPTrunk(latent_dim, hs)
        self.head = Dense(hs[-1], feature_num)

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.trunk(z)
        return torch.tanh(self.head(h)), h
