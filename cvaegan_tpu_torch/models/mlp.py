"""The MLP model family, the counterparts of `cvaegan_tpu/models/mlp.py`.

One parametric implementation covers the reference's per-algorithm
model files (`src/models/{cvae_gan,cvae,vae,vae_gan,gan,cgan,sngan}_models.py`),
which differ only in conditioning (num_classes > 0 or 0), spectral
normalisation and output activation.

Modules take integer labels and one-hot them internally; unconditional
variants pass `labels=None`. Unlike Flax, a torch module needs its input
width when it is built, so each constructor takes it first. Modules that
drop out take the `torch.Generator` to draw their masks from.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from cvaegan_tpu_torch.models.layers import (
    Dense,
    Dropout,
    LayerNorm,
    MLPTrunk,
    SpectralDense,
    hidden_sizes,
    leaky_relu,
    one_hot,
)

OUT_ACTIVATIONS = ("sigmoid", "tanh", None)


def _condition(x: torch.Tensor, labels: Optional[torch.Tensor],
               num_classes: int) -> torch.Tensor:
    if num_classes == 0:
        return x
    if labels is None:
        raise ValueError("a conditional module needs labels")
    return torch.cat([x, one_hot(labels, num_classes)], dim=-1)


class GaussianEncoder(nn.Module):
    """VAE encoder: trunk + (mu, log_var) heads
    (`src/models/cvae_gan_models.py:7-73`). Conditional when
    num_classes > 0 (input is concat(x, onehot(y)))."""

    def __init__(self, input_dim: int, num_classes: int, latent_dim: int = 128):
        super().__init__()
        self.num_classes = num_classes
        d = input_dim + num_classes
        hs = hidden_sizes(d)
        self.trunk = MLPTrunk(d, hs)
        self.mu = Dense(hs[-1], latent_dim)
        self.log_var = Dense(hs[-1], latent_dim)

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.trunk(_condition(x, labels, self.num_classes))
        return self.mu(h), self.log_var(h)


def reparameterize(mu: torch.Tensor, log_var: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """z = mu + eps * exp(0.5 log_var) (`src/models/cvae_gan_models.py:69-72`)."""
    std = torch.exp(0.5 * log_var)
    eps = torch.randn(std.shape, generator=generator, device=std.device,
                      dtype=std.dtype)
    return mu + eps * std


class Generator(nn.Module):
    """Generator/decoder: trunk + output head
    (`src/models/cvae_gan_models.py:76-162`). The input is
    concat(z, onehot(y)), z first. Returns (sample, hidden), where hidden
    is the trunk output (the reference's `hidden_status`).

    out_activation: 'sigmoid' for most models, 'tanh' for TMG-GAN, None
    for raw output. spectral=True gives the SNGAN variant with spectral
    norm on every Linear and no BatchNorm.
    """

    def __init__(self, latent_dim: int, output_dim: int, num_classes: int = 0,
                 out_activation: Optional[str] = "sigmoid",
                 spectral: bool = False):
        super().__init__()
        if out_activation not in OUT_ACTIVATIONS:
            raise ValueError(f"out_activation must be one of {OUT_ACTIVATIONS}")
        self.num_classes = num_classes
        self.out_activation = out_activation
        self.spectral = spectral
        d = latent_dim + num_classes
        hs = hidden_sizes(d)
        if spectral:
            dims = [d, *hs]
            self.layers = nn.ModuleList(
                SpectralDense(dims[i], dims[i + 1]) for i in range(3))
            self.head = SpectralDense(hs[-1], output_dim)
        else:
            self.trunk = MLPTrunk(d, hs)
            self.head = Dense(hs[-1], output_dim)

    def forward(self, z: torch.Tensor, labels: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = _condition(z, labels, self.num_classes)
        if self.spectral:
            for layer in self.layers:
                h = leaky_relu(layer(h))
        else:
            h = self.trunk(h)
        x = self.head(h)
        if self.out_activation == "sigmoid":
            x = torch.sigmoid(x)
        elif self.out_activation == "tanh":
            x = torch.tanh(x)
        return x, h


class Discriminator(nn.Module):
    """Critic: 4 (spectral) Linears with LeakyReLU + Dropout(0.3)
    (`src/models/cvae_gan_models.py:165-248`). Conditional via one-hot
    concat; when `labels is None` and num_classes > 0 a zero condition
    vector is concatenated (reference `:221-223`). Returns (score, hidden)."""

    def __init__(self, input_dim: int, num_classes: int = 0, spectral: bool = True):
        super().__init__()
        self.num_classes = num_classes
        d = input_dim + num_classes
        dims = [d, *hidden_sizes(d, pin_h3=True), 1]
        dense = SpectralDense if spectral else Dense
        self.layers = nn.ModuleList(dense(dims[i], dims[i + 1]) for i in range(4))
        self.dropout = Dropout(0.3)

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.num_classes > 0 and labels is None:
            cond = torch.zeros(x.shape[0], self.num_classes, dtype=x.dtype,
                               device=x.device)
            x = torch.cat([x, cond], dim=-1)
        else:
            x = _condition(x, labels, self.num_classes)
        l1, l2, l3, l4 = self.layers
        h = self.dropout(leaky_relu(l1(x)), generator)
        h = self.dropout(leaky_relu(l2(h)), generator)
        h = leaky_relu(l3(h))
        return l4(h), h


class Classifier(nn.Module):
    """Companion / downstream classifier
    (`src/models/cvae_gan_models.py:251-292`): Linear+ReLU+Dropout,
    Linear+LayerNorm+ReLU+Dropout, Linear+ReLU, Linear->logits."""

    def __init__(self, input_dim: int, num_classes: int, spectral: bool = False):
        super().__init__()
        dims = [input_dim, *hidden_sizes(input_dim, pin_h3=True), num_classes]
        dense = SpectralDense if spectral else Dense
        self.layers = nn.ModuleList(dense(dims[i], dims[i + 1]) for i in range(4))
        self.norm = LayerNorm(dims[2])
        self.dropout = Dropout(0.3)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        l1, l2, l3, l4 = self.layers
        h = self.dropout(torch.relu(l1(x)), generator)
        h = self.dropout(torch.relu(self.norm(l2(h))), generator)
        h = torch.relu(l3(h))
        return l4(h)
