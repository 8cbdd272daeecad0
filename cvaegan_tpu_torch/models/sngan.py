"""The SNGAN model family, the counterparts of `cvaegan_tpu/models/sngan.py`:
spectral normalisation on every Linear, the generator's and the companion
classifier's included (`src/models/sngan_models.py`).

Generator: [SN-Linear -> BatchNorm -> ReLU] x3 + SN-Linear -> Sigmoid
(`:21-40`). Discriminator: SN-Linears with LeakyReLU(0.2), no dropout
(`:91-116`). Classifier: SN-Linears with ReLU (`:158-180`). None of them
drops out, so none takes a generator. As in `models/mlp.py`, each
constructor takes its input width first and modules one-hot their
integer labels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from cvaegan_tpu_torch.models.layers import (
    BatchNorm,
    Dense,
    SpectralDense,
    dense_bn,
    hidden_sizes,
    leaky_relu,
    one_hot,
)


class SNGANGenerator(nn.Module):
    """concat(z, onehot(y)) -> [SN-Dense -> BatchNorm -> ReLU] x3 ->
    SN-Dense -> sigmoid. Returns (samples, hidden). `spectral=False` (the
    trainer's `hparams["spectral_g"]`) makes the Linears plain, the JAX
    package's sweep knob."""

    def __init__(self, latent_dim: int, output_dim: int, num_classes: int,
                 spectral: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.spectral = spectral
        dense = SpectralDense if spectral else Dense
        d = latent_dim + num_classes
        dims = [d, *hidden_sizes(d)]
        self.layers = nn.ModuleList(dense(dims[i], dims[i + 1]) for i in range(3))
        self.bn = nn.ModuleList(BatchNorm(h) for h in dims[1:])
        self.head = dense(dims[-1], output_dim)

    def forward(self, z: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = z
        if self.num_classes > 0:
            h = torch.cat([z, one_hot(labels, self.num_classes)], dim=-1)
        for layer, bn in zip(self.layers, self.bn):
            h = torch.relu(dense_bn(layer, bn, h))
        return torch.sigmoid(self.head(h)), h


class SNGANDiscriminator(nn.Module):
    """concat(x, onehot(y)) -> SN-Dense + LeakyReLU(0.2) x3 (h3 pinned to
    64) -> SN-Dense score. Without labels a zero condition vector is
    concatenated. Returns (score, hidden)."""

    def __init__(self, input_dim: int, num_classes: int):
        super().__init__()
        self.num_classes = num_classes
        d = input_dim + num_classes
        dims = [d, *hidden_sizes(d, pin_h3=True), 1]
        self.layers = nn.ModuleList(SpectralDense(dims[i], dims[i + 1]) for i in range(4))

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.num_classes > 0:
            cond = (one_hot(labels, self.num_classes) if labels is not None else
                    torch.zeros(*x.shape[:-1], self.num_classes, dtype=x.dtype,
                                device=x.device))
            x = torch.cat([x, cond], dim=-1)
        h = x
        for layer in self.layers[:-1]:
            h = leaky_relu(layer(h))
        return self.layers[-1](h), h


class SNGANClassifier(nn.Module):
    """SN-Dense + ReLU x3 (h3 pinned to 64) -> SN-Dense logits."""

    def __init__(self, input_dim: int, num_classes: int):
        super().__init__()
        dims = [input_dim, *hidden_sizes(input_dim, pin_h3=True), num_classes]
        self.layers = nn.ModuleList(SpectralDense(dims[i], dims[i + 1]) for i in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.layers[:-1]:
            h = torch.relu(layer(h))
        return self.layers[-1](h)
