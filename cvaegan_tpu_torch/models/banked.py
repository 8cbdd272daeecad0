"""Networks of a seed bank: K replicas of one network in one module.

`stack(nets)` takes K networks of the same architecture (any of the
port's: `models/{mlp,attention,sngan,ctgan,quantile,tmg}.py`, or an
`nn.ModuleList` of them) and returns one network of the same class whose
layers are banked: every parameter and buffer carries a leading replica
axis K, a dense layer is one batched matmul over the K replicas
(`torch.baddbmm`, on inputs of any rank >= 3), BatchNorm's batch moments
and spectral norm's power iteration are per replica, LayerNorm's scale
and bias broadcast over every axis between the replica and the feature
axis, and dropout draws each replica's mask from that replica's own
generator. The network's own forward then runs unchanged on `[K, batch,
features]` (`[K, batch, seq, features]` inside RAIN's attention stacks),
so a step of a bank is one kernel sequence for all K replicas, not K.
Under `layers.state_frozen` a banked layer updates nothing, as the
serial layers do. Under the bf16 compute policy each banked layer casts
as its serial layer does (`layers.dense`, `BatchNorm`, `LayerNorm`).

`load` and `store` copy the K networks' tensors into and out of the
banked one, in place, so a captured epoch stays valid.
"""

from __future__ import annotations

import copy
from typing import List, Sequence, Tuple

import torch
from torch import nn

from cvaegan_tpu_torch.models.layers import (
    BatchNorm,
    Dense,
    Dropout,
    LayerNorm,
    SpectralDense,
    _moments,
    compute_dtype,
    to_compute,
    widened,
)
from cvaegan_tpu_torch.utils import profiling


class ReplicaGenerators:
    """The K replicas' own generators. Each draw fills replica k's slice of
    a `[K, ...]` tensor from generator k, exactly as the replica's trainer
    draws the same shape; a replica outside `active` draws nothing and
    its slice is 0 (a masked class round, see `algorithms/seed_bank.py`)."""

    def __init__(self, generators: Sequence[torch.Generator], device):
        self.generators = list(generators)
        self.device = device
        self.active = [True] * len(self.generators)

    @profiling.spanned("step.draw")
    def _fill(self, shape, dtype, draw) -> torch.Tensor:
        shape = (len(self.generators), *shape)
        if all(self.active):
            out = torch.empty(shape, dtype=dtype, device=self.device)
        else:
            out = torch.zeros(shape, dtype=dtype, device=self.device)
        for k, g in enumerate(self.generators):
            if self.active[k]:
                draw(out[k], k, g)
        return out

    def randn(self, shape) -> torch.Tensor:
        return self._fill(shape, torch.float32, lambda t, k, g: t.normal_(generator=g))

    def rand(self, shape) -> torch.Tensor:
        return self._fill(shape, torch.float32, lambda t, k, g: t.uniform_(generator=g))

    def randint(self, highs: Sequence[int], shape) -> torch.Tensor:
        """int64 draws uniform on [0, highs[k]) for replica k."""
        return self._fill(shape, torch.int64,
                          lambda t, k, g: t.random_(0, int(highs[k]), generator=g))


def _stacked(tensors) -> torch.Tensor:
    return torch.stack([t.detach() for t in tensors])


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + eps)


def _per_replica(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`t [K, features]` viewed to broadcast against `x [K, ..., features]`."""
    return t.view(t.shape[0], *[1] * (x.dim() - 2), t.shape[-1])


def _linear(x: torch.Tensor, weight: torch.Tensor, bias) -> torch.Tensor:
    """`x [K, ..., in]` times replica k's `weight [K, out, in]` (and plus
    its bias) in `compute_dtype()`: the axes between are flattened into one
    batched matmul. Under bf16 the product is rounded before the bias is
    added, as `layers.dense` orders them; `baddbmm` would fuse the add."""
    dt = compute_dtype()
    flat = x.reshape(x.shape[0], -1, x.shape[-1])
    if dt == torch.float32 and bias is not None:
        out = torch.baddbmm(bias.unsqueeze(1), flat, weight.transpose(1, 2))
    elif dt == torch.float32:
        out = torch.bmm(flat, weight.transpose(1, 2))
    else:
        out = torch.bmm(flat.to(dt), weight.to(dt).transpose(1, 2))
        if bias is not None:
            out = out + bias.to(dt).unsqueeze(1)
    return out.reshape(*x.shape[:-1], weight.shape[1])


class BankedDense(nn.Module):
    """K `Dense` layers: weight `[K, out, in]`, bias `[K, out]`."""

    def __init__(self, layers: Sequence[Dense]):
        super().__init__()
        self.weight = nn.Parameter(_stacked(l.weight for l in layers))
        self.bias = (nn.Parameter(_stacked(l.bias for l in layers))
                     if layers[0].bias is not None else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(x, self.weight, self.bias)


class BankedSpectralDense(nn.Module):
    """K `SpectralDense` layers: one power-iteration step per replica per
    train forward, u `[K, out]`, v `[K, in]`, sigma `[K]`."""

    def __init__(self, layers: Sequence[SpectralDense]):
        super().__init__()
        self.weight = nn.Parameter(_stacked(l.weight for l in layers))
        self.bias = (nn.Parameter(_stacked(l.bias for l in layers))
                     if layers[0].bias is not None else None)
        #: False under `state_frozen`: no power iteration in train mode
        self.update_state = True
        self.register_buffer("u", _stacked(l.u for l in layers))
        self.register_buffer("v", _stacked(l.v for l in layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.update_state:
            with torch.no_grad():
                v = _l2_normalize(torch.bmm(self.u.unsqueeze(1), self.weight).squeeze(1))
                self.u.copy_(_l2_normalize(torch.bmm(self.weight, v.unsqueeze(2)).squeeze(2)))
                self.v.copy_(v)
        sigma = (self.u * torch.bmm(self.weight, self.v.unsqueeze(2)).squeeze(2)).sum(-1)
        return _linear(x, self.weight / sigma[:, None, None], self.bias)


class BankedBatchNorm(nn.Module):
    """K `BatchNorm` layers: moments over each replica's own batch."""

    def __init__(self, layers: Sequence[BatchNorm]):
        super().__init__()
        self.momentum, self.eps = layers[0].momentum, layers[0].eps
        #: False under `state_frozen`: batch statistics, no running update
        self.update_state = True
        self.weight = nn.Parameter(_stacked(l.weight for l in layers))
        self.bias = nn.Parameter(_stacked(l.bias for l in layers))
        self.register_buffer("running_mean", _stacked(l.running_mean for l in layers))
        self.register_buffer("running_var", _stacked(l.running_var for l in layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = widened(x)
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var = _moments(x, -2)
            if self.update_state:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1 - m) * var)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return to_compute((x - mean.unsqueeze(-2)) * scale.unsqueeze(-2)
                          + self.bias.unsqueeze(-2))


class BankedLayerNorm(nn.Module):
    """K `LayerNorm` layers: scale and bias `[K, features]`, on inputs
    `[K, ..., features]`."""

    def __init__(self, layers: Sequence[LayerNorm]):
        super().__init__()
        self.eps = layers[0].eps
        self.weight = nn.Parameter(_stacked(l.weight for l in layers))
        self.bias = nn.Parameter(_stacked(l.bias for l in layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = widened(x)
        mean, var = _moments(x, -1, keepdim=True)
        return ((x - mean) * (torch.rsqrt(var + self.eps) * _per_replica(self.weight, x))
                + _per_replica(self.bias, x))


@profiling.spanned("step.draw")
def _keep_mask(x: torch.Tensor, keep_prob: float,
               generator: ReplicaGenerators) -> torch.Tensor:
    return generator.rand(x.shape[1:]) < keep_prob


class BankedDropout(nn.Module):
    """`Dropout` whose generator is a `ReplicaGenerators`: replica k's mask
    is drawn from its own generator, at the shape its trainer draws."""

    def __init__(self, layers: Sequence[Dropout]):
        super().__init__()
        self.rate = layers[0].rate

    def forward(self, x: torch.Tensor, generator: ReplicaGenerators) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        keep = _keep_mask(x, keep_prob, generator)
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


BANKED = {Dense: BankedDense, SpectralDense: BankedSpectralDense,
          BatchNorm: BankedBatchNorm, LayerNorm: BankedLayerNorm,
          Dropout: BankedDropout}


def stack(nets: Sequence[nn.Module]) -> nn.Module:
    """One banked network from K networks of one architecture, holding
    copies of their tensors."""
    banked = copy.deepcopy(nets[0])
    for name, module in list(banked.named_modules()):
        kind = BANKED.get(type(module))
        if kind is not None:
            banked.set_submodule(name, kind([net.get_submodule(name) for net in nets]))
    return banked


def _pairs(banked: nn.Module, nets: Sequence[nn.Module]
           ) -> List[Tuple[torch.Tensor, List[torch.Tensor]]]:
    """(banked tensor, the K networks' tensors) for every parameter and
    buffer."""
    theirs = [net.state_dict(keep_vars=True) for net in nets]
    return [(t, [s[name] for s in theirs])
            for name, t in banked.state_dict(keep_vars=True).items()]


@torch.no_grad()
def load(banked: nn.Module, nets: Sequence[nn.Module]) -> None:
    """Copy the K networks' tensors into the banked network, in place."""
    for t, ts in _pairs(banked, nets):
        t.copy_(_stacked(ts))


@torch.no_grad()
def store(banked: nn.Module, nets: Sequence[nn.Module]) -> None:
    """Copy replica k of the banked network into network k, in place."""
    for t, ts in _pairs(banked, nets):
        for k, dst in enumerate(ts):
            dst.copy_(t[k])
