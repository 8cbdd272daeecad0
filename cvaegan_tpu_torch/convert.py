"""Carry network weights from the JAX package into the port.

A JAX network's state is a Flax variable tree: `params` plus its mutable
collections (`batch_stats` for BatchNorm running statistics, `spectral`
for the power-iteration vectors). This module takes such trees as plain
nested dicts of numpy arrays (e.g. from `jax.device_get`), so it never
sees a JAX or Flax type, and copies every leaf into the matching tensor
of the port's modules:

  * a Dense `kernel [in, out]` becomes a weight `[out, in]`;
  * `BatchNorm_{i}/BatchNorm_0` (the wrapper's inner Flax BatchNorm)
    gives scale, bias, mean and var;
  * `SpectralDense_{i}` gives kernel, bias and `spectral/u`, `spectral/v`;
  * the classifier's `LayerNorm_0` gives scale and bias;
  * a RAIN-GAN `MultiHeadSelfAttention_0` holds the q, k, v and output
    projections as `Dense_0` to `Dense_3`; a `ResidualAttentionBlock_{i}`
    holds `LayerNorm_0`, the attention, `LayerNorm_1`, and its
    feed-forward and shortcut layers as `Dense_{0,1,2}` (or
    `SpectralDense_{0,1,2}` in the discriminator), the shortcut only
    where the width changes.

A leaf the port has no place for, or a place no leaf fills, raises.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from cvaegan_tpu_torch.models import attention, mlp
from cvaegan_tpu_torch.models.layers import (
    BatchNorm,
    Dense,
    LayerNorm,
    MLPTrunk,
    SpectralDense,
)

Path = Tuple[str, ...]
#: path in the Flax tree -> (port tensor, whether the leaf is transposed)
Leaves = Dict[Path, Tuple[torch.Tensor, bool]]


def _flatten(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = (*prefix, str(k))
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _linear(prefix: Path, layer: nn.Module) -> Leaves:
    leaves = {("params", *prefix, "kernel"): (layer.weight, True)}
    if layer.bias is not None:
        leaves[("params", *prefix, "bias")] = (layer.bias, False)
    if isinstance(layer, SpectralDense):
        leaves[("spectral", *prefix, "u")] = (layer.u, False)
        leaves[("spectral", *prefix, "v")] = (layer.v, False)
    return leaves


def _named(prefix: Path, layers) -> Leaves:
    """Dense/SpectralDense layers in call order, named by Flax's counter
    of each kind."""
    leaves: Leaves = {}
    counts = {"Dense": 0, "SpectralDense": 0}
    for layer in layers:
        kind = "SpectralDense" if isinstance(layer, SpectralDense) else "Dense"
        leaves.update(_linear((*prefix, f"{kind}_{counts[kind]}"), layer))
        counts[kind] += 1
    return leaves


def _batchnorm(prefix: Path, bn: BatchNorm) -> Leaves:
    p = (*prefix, "BatchNorm_0")
    return {
        ("params", *p, "scale"): (bn.weight, False),
        ("params", *p, "bias"): (bn.bias, False),
        ("batch_stats", *p, "mean"): (bn.running_mean, False),
        ("batch_stats", *p, "var"): (bn.running_var, False),
    }


def _layernorm(prefix: Path, ln: LayerNorm) -> Leaves:
    return {
        ("params", *prefix, "scale"): (ln.weight, False),
        ("params", *prefix, "bias"): (ln.bias, False),
    }


def _trunk(prefix: Path, trunk: MLPTrunk) -> Leaves:
    leaves: Leaves = {}
    for i, (dense, bn) in enumerate(zip(trunk.dense, trunk.bn)):
        leaves.update(_linear((*prefix, f"Dense_{i}"), dense))
        leaves.update(_batchnorm((*prefix, f"BatchNorm_{i}"), bn))
    return leaves


def _attention(prefix: Path, mhsa: attention.MultiHeadSelfAttention) -> Leaves:
    return _named(prefix, (mhsa.query, mhsa.key, mhsa.value, mhsa.out))


def _block(prefix: Path, block: attention.ResidualAttentionBlock) -> Leaves:
    dense = [block.ff1, block.ff2] + ([block.shortcut] if block.shortcut else [])
    return {**_layernorm((*prefix, "LayerNorm_0"), block.norm1),
            **_attention((*prefix, "MultiHeadSelfAttention_0"), block.attention),
            **_layernorm((*prefix, "LayerNorm_1"), block.norm2),
            **_named(prefix, dense)}


def _rain(net: nn.Module, dense) -> Leaves:
    """A RAIN network: its Dense/SpectralDense layers outside the blocks
    (in call order), its `LayerNorm_0` where it has one, and its blocks."""
    leaves = _named((), dense)
    if hasattr(net, "norm"):
        leaves.update(_layernorm(("LayerNorm_0",), net.norm))
    for i, block in enumerate(net.blocks):
        leaves.update(_block((f"ResidualAttentionBlock_{i}",), block))
    return leaves


def net_leaves(net: nn.Module) -> Leaves:
    """Every tensor of a port network or layer, keyed by its path in the
    Flax variable tree of its JAX counterpart."""
    trunk = ("MLPTrunk_0",)
    if isinstance(net, (Dense, SpectralDense)):
        return _linear((), net)
    if isinstance(net, BatchNorm):
        return _batchnorm((), net)
    if isinstance(net, LayerNorm):
        return _layernorm((), net)
    if isinstance(net, MLPTrunk):
        return _trunk((), net)
    if isinstance(net, mlp.GaussianEncoder):
        return {**_trunk(trunk, net.trunk), **_linear(("Dense_0",), net.mu),
                **_linear(("Dense_1",), net.log_var)}
    if isinstance(net, mlp.Generator):
        if net.spectral:
            return _named((), [*net.layers, net.head])
        return {**_trunk(trunk, net.trunk), **_linear(("Dense_0",), net.head)}
    if isinstance(net, mlp.Discriminator):
        return _named((), net.layers)
    if isinstance(net, mlp.Classifier):
        return {**_named((), net.layers), **_layernorm(("LayerNorm_0",), net.norm)}
    if isinstance(net, attention.MultiHeadSelfAttention):
        return _attention((), net)
    if isinstance(net, attention.ResidualAttentionBlock):
        return _block((), net)
    if isinstance(net, attention.RAINEncoder):
        return _rain(net, [net.proj, net.mu, net.log_var])
    if isinstance(net, (attention.RAINGenerator, attention.RAINDiscriminator,
                        attention.RAINClassifier)):
        return _rain(net, [net.proj, net.head])
    raise TypeError(f"no Flax layout known for {type(net).__name__}")


@torch.no_grad()
def load_net(net: nn.Module, tree: Mapping) -> None:
    """Copy one network's (or layer's) Flax variable tree into `net`, in
    place."""
    want, got = net_leaves(net), _flatten(tree)
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"{type(net).__name__}: leaves missing from the tree "
                         f"{missing}, leaves the port has no place for {extra}")
    for path, (tensor, transposed) in want.items():
        arr = got[path].T if transposed else got[path]
        if tuple(arr.shape) != tuple(tensor.shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} in the tree, "
                             f"{tuple(tensor.shape)} in the port")
        tensor.copy_(torch.from_numpy(np.array(arr, np.float32)))


def cvaegan_dims(tree: Mapping) -> Tuple[int, int, int]:
    """(feature_num, label_num, z_size) of a JAX CVAE-GAN state tree."""
    gen = tree["generator"]["params"]
    feature_num = int(np.shape(gen["Dense_0"]["kernel"])[1])
    enc_in = int(np.shape(tree["encoder"]["params"]["MLPTrunk_0"]["Dense_0"]["kernel"])[0])
    label_num = enc_in - feature_num
    z_size = int(np.shape(gen["MLPTrunk_0"]["Dense_0"]["kernel"])[0]) - label_num
    return feature_num, label_num, z_size


def rain_gan_dims(tree: Mapping) -> Tuple[int, int, int]:
    """(feature_num, label_num, z_size) of a JAX RAIN-GAN state tree."""
    gen = tree["generator"]["params"]
    feature_num = int(np.shape(gen["Dense_1"]["kernel"])[1])
    label_num = int(np.shape(tree["encoder"]["params"]["Dense_0"]["kernel"])[0]) - feature_num
    z_size = int(np.shape(gen["Dense_0"]["kernel"])[0]) - label_num
    return feature_num, label_num, z_size


def state_from_jax(tree: Mapping, state: nn.ModuleDict) -> nn.ModuleDict:
    """Fill a trainer's state (`encoder`, `generator`, `discriminator`,
    `classifier`, and `classifier_ema` under the EMA filter) from `tree`,
    which holds one Flax variable tree per network, each with `params`
    and its mutable collections. Every leaf is accounted for."""
    if set(tree) != set(state.keys()):
        raise ValueError(f"networks in the tree {sorted(tree)} differ from "
                         f"the port's {sorted(state.keys())}")
    for name, net in state.items():
        load_net(net, tree[name])
    return state


#: a RAIN-GAN's state is filled network by network, as a CVAE-GAN's is
rain_gan_state_from_jax = state_from_jax
