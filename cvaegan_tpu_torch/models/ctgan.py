"""The CTGAN model family, the counterparts of `cvaegan_tpu/models/ctgan.py`:
residual MLP blocks with per-row column masks (`src/models/ctgan_models.py`).

The generator and the critic take an extra one-hot column mask appended
to their inputs: one random column per row in training, round-robin in
eval (`:90-97,182-189`). The mask is an explicit argument, so the trainer
draws it from its own generator. The critic and the classifier drop out
and take the generator to draw their keep-masks from.
`ModeSpecificNormalization` (`:284-300`) is ported for parity and, as in
the JAX package and the reference, not wired into training.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cvaegan_tpu_torch.models.banked import ReplicaGenerators
from cvaegan_tpu_torch.models.layers import (
    BatchNorm,
    Dense,
    Dropout,
    dense_bn,
    SpectralDense,
    hidden_sizes,
    leaky_relu,
    one_hot,
    whole_features,
)


def random_column_mask(generator, batch: int, num_columns: int, device) -> torch.Tensor:
    """Training mask: one column per row, uniform (`:91-93`), as float32
    one-hot `[batch, num_columns]`. From a seed bank's `ReplicaGenerators`
    each replica draws its own `[batch]`, as its trainer does, and the
    mask is `[K, batch, num_columns]`."""
    if isinstance(generator, ReplicaGenerators):
        cols = generator.randint([num_columns] * len(generator.generators), (batch,))
    else:
        cols = torch.randint(0, num_columns, (batch,), generator=generator, device=device)
    return F.one_hot(cols, num_columns).to(torch.float32)


def round_robin_column_mask(batch: int, num_columns: int, device) -> torch.Tensor:
    """Eval mask: row i marks column i % num_columns (`:94-95`)."""
    cols = torch.arange(batch, device=device) % num_columns
    return F.one_hot(cols, num_columns).to(torch.float32)


class ResidualBlock(nn.Module):
    """[Linear -> BN -> ReLU -> Linear -> BN] + shortcut, the shortcut a
    Linear only where the width changes (`:8-36`); `spectral` puts
    spectral norm on all three Linears."""

    def __init__(self, in_features: int, features: int, spectral: bool = False):
        super().__init__()
        dense = SpectralDense if spectral else Dense
        self.dense1 = dense(in_features, features)
        self.bn1 = BatchNorm(features)
        self.dense2 = dense(features, features)
        self.bn2 = BatchNorm(features)
        self.shortcut = dense(in_features, features) if in_features != features else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = dense_bn(self.dense2, self.bn2, torch.relu(dense_bn(self.dense1, self.bn1, x)))
        return h + (x if self.shortcut is None else self.shortcut(x))


class CTGANGenerator(nn.Module):
    """concat(z, onehot(y), column_mask) -> Dense + BN + ReLU -> two
    residual blocks, each followed by ReLU -> Dense -> tanh (`:40-123`).
    Returns the samples alone."""

    def __init__(self, latent_dim: int, output_dim: int, num_classes: int):
        super().__init__()
        self.num_classes = num_classes
        h1, h2, h3 = hidden_sizes(latent_dim + num_classes + output_dim)
        self.proj = Dense(latent_dim + num_classes + output_dim, h1)
        self.bn = BatchNorm(h1)
        self.blocks = nn.ModuleList([ResidualBlock(h1, h2), ResidualBlock(h2, h3)])
        self.head = Dense(h3, output_dim)

    def forward(self, z: torch.Tensor, labels: torch.Tensor,
                column_mask: torch.Tensor) -> torch.Tensor:
        x = torch.cat([z, one_hot(labels, self.num_classes), column_mask], dim=-1)
        h = torch.relu(dense_bn(self.proj, self.bn, x))
        for block in self.blocks:
            h = torch.relu(block(h))
        return torch.tanh(self.head(h))


class CTGANDiscriminator(nn.Module):
    """Spectral residual critic over concat(x, onehot(y), column_mask):
    SN-Dense, then two spectral residual blocks, each stage followed by
    LeakyReLU(0.2) and Dropout(0.1), then an SN-Dense score
    (`:127-212`). Without labels a zero condition vector is concatenated."""

    def __init__(self, input_dim: int, num_classes: int):
        super().__init__()
        self.num_classes = num_classes
        d = 2 * input_dim + num_classes
        h1, h2, h3 = hidden_sizes(d)
        self.proj = SpectralDense(d, h1)
        self.blocks = nn.ModuleList([ResidualBlock(h1, h2, spectral=True),
                                     ResidualBlock(h2, h3, spectral=True)])
        self.head = SpectralDense(h3, 1)
        self.dropout = Dropout(0.1)

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor],
                column_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cond = (one_hot(labels, self.num_classes) if labels is not None else
                torch.zeros(*x.shape[:-1], self.num_classes, dtype=x.dtype,
                            device=x.device))
        h = self.dropout(leaky_relu(self.proj(torch.cat([x, cond, column_mask], dim=-1))),
                         generator)
        for block in self.blocks:
            h = self.dropout(leaky_relu(block(h)), generator)
        return self.head(h)


class CTGANClassifier(nn.Module):
    """[Linear -> BN -> ReLU -> Dropout(0.3)] x2 -> Linear -> ReLU ->
    logits, h3 pinned to 64 (`:241-281`)."""

    def __init__(self, input_dim: int, num_classes: int):
        super().__init__()
        dims = [input_dim, *hidden_sizes(input_dim, pin_h3=True), num_classes]
        self.layers = nn.ModuleList(Dense(dims[i], dims[i + 1]) for i in range(4))
        self.bn = nn.ModuleList(BatchNorm(h) for h in dims[1:3])
        self.dropout = Dropout(0.3)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        l1, l2, l3, l4 = self.layers
        h = self.dropout(torch.relu(dense_bn(l1, self.bn[0], x)), generator)
        h = self.dropout(torch.relu(dense_bn(l2, self.bn[1], h)), generator)
        return l4(torch.relu(l3(h)))


class ModeSpecificNormalization(nn.Module):
    """Per-mode affine y = gamma[mode] * x + beta[mode], gamma 1, beta 0
    (`:284-300`)."""

    def __init__(self, num_features: int, num_modes: int = 3):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(num_modes, num_features))
        self.beta = nn.Parameter(torch.zeros(num_modes, num_features))

    def forward(self, x: torch.Tensor, modes: torch.Tensor) -> torch.Tensor:
        gamma, beta = whole_features(self.gamma, self.beta)  # sliced by feature if placed
        return gamma[modes] * x + beta[modes]
