"""Shared building blocks, the counterparts of `cvaegan_tpu/models/layers.py`.

The reference builds every network from the same ingredients
(`src/models/cvae_gan_models.py`): Linear (with optional spectral norm),
BatchNorm1d, LeakyReLU(0.2), Dropout(0.3), and the hidden-size rule
h1=max(256,d), h2=max(128,d//2), h3=max(64,d//4) (discriminators and
classifiers pin h3=64).

Layouts and numerics follow the JAX package, not torch's built-ins:

  * `Dense` keeps torch's `[out, in]` weight; the JAX kernel is its
    transpose (`convert.py` carries weights across).
  * `BatchNorm` is written by hand: the running variance is updated with
    the BIASED batch variance, var = max(0, E[x^2] - E[x]^2), as Flax does;
    `torch.nn.BatchNorm1d` would use the unbiased one.
  * `SpectralDense` keeps the power-iteration vectors `u` [out] and `v`
    [in] as buffers and runs one iteration per train forward, without
    gradient; `torch.nn.utils.parametrizations.spectral_norm` iterates
    differently and normalises with max(|x|, eps).
  * Every module reads `self.training`; a train-mode forward under
    `torch.no_grad()` still updates the BatchNorm statistics and `u`/`v`
    in place (the JAX package returns them as new mutables instead).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cvaegan_tpu_torch.core import initializers as init

LEAKY_SLOPE = 0.2


def hidden_sizes(total_input_dim: int, pin_h3: bool = False) -> Tuple[int, int, int]:
    """Reference hidden-size rule (`src/models/cvae_gan_models.py:16-18`,
    `:173-175` for the pinned variant)."""
    h1 = max(256, total_input_dim)
    h2 = max(128, total_input_dim // 2)
    h3 = 64 if pin_h3 else max(64, total_input_dim // 4)
    return (h1, h2, h3)


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Integer labels -> float32 one-hot."""
    return F.one_hot(labels.long(), num_classes).to(torch.float32)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


class Dense(nn.Module):
    """Linear layer with the reference's N(0, 0.02)/zeros init."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def init_from(self, generator: torch.Generator) -> None:
        init.dense_kernel_(self.weight, generator)
        if self.bias is not None:
            init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class SpectralDense(nn.Module):
    """Linear layer with spectral normalisation by one power-iteration
    step per train forward (reference `src/models/cvae_gan_models.py:
    178-189`).

    In the JAX layout K = weight.T [in, out]: v = n(K u), u = n(K^T v),
    sigma = v^T K u, with n(x) = x / (|x| + 1e-12). Here that reads
    v = n(u W), u = n(W v), sigma = u^T W v. Gradients reach the weight
    through sigma but not through `u`/`v`.
    """

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.register_buffer("u", torch.zeros(features))
        self.register_buffer("v", torch.zeros(in_features))

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        init.dense_kernel_(self.weight, generator)
        if self.bias is not None:
            init.zeros_(self.bias)
        self.u.copy_(_l2_normalize(self.u.normal_(generator=generator)))
        self.v.copy_(_l2_normalize(self.v.normal_(generator=generator)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            with torch.no_grad():
                v = _l2_normalize(self.u @ self.weight)
                self.u.copy_(_l2_normalize(self.weight @ v))
                self.v.copy_(v)
        sigma = torch.dot(self.u, self.weight @ self.v)
        return F.linear(x, self.weight / sigma, self.bias)


def _moments(x: torch.Tensor, dim: int, keepdim: bool = False):
    """Mean and biased variance as Flax computes them: E[x^2] - E[x]^2,
    clipped at 0, in float32."""
    mean = x.mean(dim, keepdim=keepdim)
    var = torch.clamp_min((x * x).mean(dim, keepdim=keepdim) - mean * mean, 0.0)
    return mean, var


class BatchNorm(nn.Module):
    """BatchNorm1d with Flax's statistics: momentum 0.9 on the running
    averages (torch's 0.1), eps 1e-5, scale ~ N(1, 0.02), bias 0
    (`src/utils.py:99-101`), biased running variance."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def init_from(self, generator: torch.Generator) -> None:
        init.bn_scale_(self.weight, generator)
        init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = _moments(x, 0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class LayerNorm(nn.Module):
    """Flax `nn.LayerNorm(epsilon=1e-5)`: scale 1, bias 0, statistics as
    `_moments` computes them over the last axis."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = _moments(x, -1, keepdim=True)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def _keep_mask(x: torch.Tensor, keep_prob: float,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.rand(x.shape, generator=generator, device=x.device) < keep_prob


class Dropout(nn.Module):
    """Inverted dropout drawing its mask from an explicit generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        keep = _keep_mask(x, keep_prob, generator)
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class MLPTrunk(nn.Module):
    """The reference's 3x [Linear -> BatchNorm -> LeakyReLU(0.2)] stack
    (`src/models/cvae_gan_models.py:20-33`)."""

    def __init__(self, in_features: int, hidden: Sequence[int]):
        super().__init__()
        dims = [in_features, *hidden]
        self.dense = nn.ModuleList(
            Dense(dims[i], dims[i + 1]) for i in range(len(hidden)))
        self.bn = nn.ModuleList(BatchNorm(h) for h in hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for dense, bn in zip(self.dense, self.bn):
            x = leaky_relu(bn(dense(x)))
        return x
