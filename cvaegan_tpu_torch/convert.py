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
    where the width changes;
  * an SNGAN network holds its Linears as `SpectralDense_{i}` (`Dense_{i}`
    in a generator without spectral norm) and the generator's
    BatchNorms as `BatchNorm_{i}`;
  * a CTGAN `ResidualBlock_{i}` holds its two Linears and its shortcut as
    `Dense_{0,1,2}` (`SpectralDense_{0,1,2}` in the critic) and its
    BatchNorms as `BatchNorm_{0,1}`; `ModeSpecificNormalization` holds
    `gamma` and `beta`;
  * a QG-SMOTE `QuantileEncoder` holds `MLPTrunk_0` and its head as
    `Dense_0`, a `QuantileRegressor` its Linears as `Dense_{0,1,2}`;
  * a TMG-GAN `TMGCD` holds its trunk and score as `SpectralDense_{0..3}`
    and its class head as `Dense_0`; a `TMGGenerator` holds `MLPTrunk_0`
    and `Dense_0`. The JAX TMG-GAN stacks its per-class generators' trees
    (Adam state included) on a leading axis of one entry per class;
    `tmg_gan_state_from_jax` splits it.

A network's tree may also hold `opt_state`: its optax Adam state as
`{"count", "mu", "nu"}`, with `mu` and `nu` shaped like `params`. It goes
into the port's `core.state.Adam` of that network, so a JAX state resumes
training in the port.

A leaf the port has no place for, or a place no leaf fills, raises.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from cvaegan_tpu_torch.models import attention, ctgan, mlp, quantile, sngan, tmg
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


def _batchnorms(prefix: Path, bns) -> Leaves:
    leaves: Leaves = {}
    for i, bn in enumerate(bns):
        leaves.update(_batchnorm((*prefix, f"BatchNorm_{i}"), bn))
    return leaves


def _residual(prefix: Path, block: ctgan.ResidualBlock) -> Leaves:
    dense = [block.dense1, block.dense2] + ([block.shortcut] if block.shortcut else [])
    return {**_named(prefix, dense), **_batchnorms(prefix, (block.bn1, block.bn2))}


def _ctgan(net: nn.Module, dense, bns) -> Leaves:
    """A CTGAN generator or critic: its Linears outside the blocks (in
    call order), its BatchNorms and its residual blocks."""
    leaves = {**_named((), dense), **_batchnorms((), bns)}
    for i, block in enumerate(net.blocks):
        leaves.update(_residual((f"ResidualBlock_{i}",), block))
    return leaves


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
    if isinstance(net, sngan.SNGANGenerator):
        return {**_named((), [*net.layers, net.head]), **_batchnorms((), net.bn)}
    if isinstance(net, (sngan.SNGANDiscriminator, sngan.SNGANClassifier)):
        return _named((), net.layers)
    if isinstance(net, ctgan.ResidualBlock):
        return _residual((), net)
    if isinstance(net, ctgan.CTGANGenerator):
        return _ctgan(net, [net.proj, net.head], [net.bn])
    if isinstance(net, ctgan.CTGANDiscriminator):
        return _ctgan(net, [net.proj, net.head], [])
    if isinstance(net, ctgan.CTGANClassifier):
        return {**_named((), net.layers), **_batchnorms((), net.bn)}
    if isinstance(net, ctgan.ModeSpecificNormalization):
        return {("params", "gamma"): (net.gamma, False),
                ("params", "beta"): (net.beta, False)}
    if isinstance(net, (quantile.QuantileEncoder, tmg.TMGGenerator)):
        return {**_trunk(trunk, net.trunk), **_linear(("Dense_0",), net.head)}
    if isinstance(net, quantile.QuantileRegressor):
        return _named((), net.layers)
    if isinstance(net, tmg.TMGCD):
        return _named((), [*net.layers, net.score, net.classes])
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


@torch.no_grad()
def load_adam(opt, net: nn.Module, tree: Mapping) -> None:
    """Copy a network's optax Adam state `{"count", "mu", "nu"}` into `opt`,
    the port's `Adam` over `net`'s parameters, in place."""
    slots = {id(p): i for i, p in enumerate(opt.params)}
    params = {path: leaf for path, leaf in net_leaves(net).items() if path[0] == "params"}
    if sorted(slots) != sorted(id(tensor) for tensor, _ in params.values()):
        raise ValueError(f"{type(net).__name__}: the optimizer does not hold "
                         "exactly the network's parameters")
    for moment, dst in (("mu", opt.m), ("nu", opt.v)):
        got = {("params", *k): v for k, v in _flatten(tree[moment]).items()}
        if set(got) != set(params):
            raise ValueError(f"{type(net).__name__}: Adam {moment} leaves differ "
                             f"from the parameters: {sorted(set(got) ^ set(params))}")
        for path, (tensor, transposed) in params.items():
            arr = got[path].T if transposed else got[path]
            dst[slots[id(tensor)]].copy_(torch.from_numpy(np.array(arr, np.float32)))
    opt.count.fill_(int(np.asarray(tree["count"])))


def cvaegan_dims(tree: Mapping) -> Tuple[int, int, int]:
    """(feature_num, label_num, z_size) of a JAX CVAE-GAN state tree."""
    gen = tree["generator"]["params"]
    feature_num = int(np.shape(gen["Dense_0"]["kernel"])[1])
    enc_in = int(np.shape(tree["encoder"]["params"]["MLPTrunk_0"]["Dense_0"]["kernel"])[0])
    label_num = enc_in - feature_num
    z_size = int(np.shape(gen["MLPTrunk_0"]["Dense_0"]["kernel"])[0]) - label_num
    return feature_num, label_num, z_size


def _decoder_dims(net: Mapping) -> Tuple[int, int]:
    """(output features, input width) of a JAX MLP generator's tree."""
    params = net["params"]
    return (int(np.shape(params["Dense_0"]["kernel"])[1]),
            int(np.shape(params["MLPTrunk_0"]["Dense_0"]["kernel"])[0]))


def _classes(tree: Mapping) -> Optional[int]:
    """The classes of a tree's companion classifier (its last layer's
    width), or None if the tree has none."""
    if "classifier" not in tree:
        return None
    return int(np.shape(tree["classifier"]["params"]["Dense_3"]["kernel"])[1])


def cgan_dims(tree: Mapping) -> Tuple[int, int, int]:
    """(feature_num, label_num, z_size) of a JAX CGAN state tree."""
    feature_num, width = _decoder_dims(tree["generator"])
    label_num = _classes(tree)
    return feature_num, label_num, width - label_num


def unconditional_dims(tree: Mapping, decoder: str) -> Tuple[int, Optional[int], int]:
    """(feature_num, label_num, z_size) of a JAX GAN, VAE (`decoder` is
    "decoder") or VAE-GAN state tree; label_num is None for the VAE-GAN,
    none of whose networks depends on it."""
    feature_num, z_size = _decoder_dims(tree[decoder])
    return feature_num, _classes(tree), z_size


def rain_gan_dims(tree: Mapping) -> Tuple[int, int, int]:
    """(feature_num, label_num, z_size) of a JAX RAIN-GAN state tree."""
    gen = tree["generator"]["params"]
    feature_num = int(np.shape(gen["Dense_1"]["kernel"])[1])
    label_num = int(np.shape(tree["encoder"]["params"]["Dense_0"]["kernel"])[0]) - feature_num
    z_size = int(np.shape(gen["Dense_0"]["kernel"])[0]) - label_num
    return feature_num, label_num, z_size


def sngan_dims(tree: Mapping) -> Tuple[int, int, int]:
    """(feature_num, label_num, z_size) of a JAX SNGAN state tree, with or
    without spectral norm on the generator."""
    gen = tree["generator"]["params"]
    kind = "SpectralDense" if "SpectralDense_0" in gen else "Dense"
    feature_num = int(np.shape(gen[f"{kind}_3"]["kernel"])[1])
    label_num = int(np.shape(tree["classifier"]["params"]["SpectralDense_3"]["kernel"])[1])
    z_size = int(np.shape(gen[f"{kind}_0"]["kernel"])[0]) - label_num
    return feature_num, label_num, z_size


def ctgan_dims(tree: Mapping) -> Tuple[int, int, int]:
    """(feature_num, label_num, z_size) of a JAX CTGAN state tree (the
    generator's input is concat(z, onehot(y), column_mask))."""
    gen = tree["generator"]["params"]
    feature_num = int(np.shape(gen["Dense_1"]["kernel"])[1])
    label_num = _classes(tree)
    z_size = int(np.shape(gen["Dense_0"]["kernel"])[0]) - label_num - feature_num
    return feature_num, label_num, z_size


#: a QG-SMOTE tree reads as a CVAE-GAN's: its encoder's `MLPTrunk_0` takes
#: concat(x, onehot(y)), its generator's concat(z, onehot(y))
qg_smote_dims = cvaegan_dims


def tmg_gan_dims(tree: Mapping) -> Tuple[int, int, int]:
    """(feature_num, label_num, z_size) of a JAX TMG-GAN state tree, whose
    generators are stacked on a leading axis of one per class."""
    gens = tree["gens"]["params"]
    label_num, z_size = (int(n) for n in np.shape(gens["MLPTrunk_0"]["Dense_0"]["kernel"])[:2])
    feature_num = int(np.shape(gens["Dense_0"]["kernel"])[2])
    return feature_num, label_num, z_size


def state_from_jax(tree: Mapping, state: nn.ModuleDict,
                   optimizers: Optional[Mapping] = None) -> nn.ModuleDict:
    """Fill a trainer's state (its networks by name: `encoder`,
    `generator` or the VAE's `decoder`, `discriminator`, `classifier`, and
    `classifier_ema` under the EMA filter) from `tree`,
    which holds one Flax variable tree per network, each with `params`
    and its mutable collections, and optionally `opt_state`, which goes
    into `optimizers[name]`. Every leaf is accounted for."""
    if set(tree) != set(state.keys()):
        raise ValueError(f"networks in the tree {sorted(tree)} differ from "
                         f"the port's {sorted(state.keys())}")
    for name, net in state.items():
        variables = dict(tree[name])
        opt_state = variables.pop("opt_state", None)
        load_net(net, variables)
        if opt_state is not None:
            if optimizers is None or name not in optimizers:
                raise ValueError(f"{name}: the tree holds optimizer state, "
                                 "the port has no optimizer for it")
            load_adam(optimizers[name], net, opt_state)
    return state


#: a RAIN-GAN's state is filled network by network, as a CVAE-GAN's is
rain_gan_state_from_jax = state_from_jax


def _split(tree: Mapping, i: int):
    """Entry `i` of every leaf of a tree stacked on a leading axis."""
    return {k: (_split(v, i) if isinstance(v, Mapping) else np.asarray(v)[i])
            for k, v in tree.items()}


def tmg_gan_state_from_jax(tree: Mapping, state: nn.ModuleDict,
                           optimizers: Optional[Mapping] = None) -> nn.ModuleDict:
    """Fill a TMG-GAN's state: `cd` as `state_from_jax` fills a network,
    and `gens` (an `nn.ModuleList` of one `TMGGenerator` per class) from
    the tree's stacked `gens`, entry i of every leaf (its Adam `count`
    `[L]` included) into generator i and its Adam `optimizers["gens.{i}"]`."""
    if set(tree) != set(state.keys()):
        raise ValueError(f"networks in the tree {sorted(tree)} differ from "
                         f"the port's {sorted(state.keys())}")
    state_from_jax({"cd": tree["cd"]}, nn.ModuleDict({"cd": state["cd"]}), optimizers)
    variables = dict(tree["gens"])
    opt_state = variables.pop("opt_state", None)
    gens = state["gens"]
    stacked = {len(leaf) for leaf in _flatten(variables).values()}
    if stacked != {len(gens)}:
        raise ValueError(f"gens: leading axes {sorted(stacked)} in the tree, "
                         f"{len(gens)} generators in the port")
    for i, gen in enumerate(gens):
        load_net(gen, _split(variables, i))
        if opt_state is not None:
            if optimizers is None:
                raise ValueError("gens: the tree holds optimizer state, the port "
                                 "has no optimizer for it")
            load_adam(optimizers[f"gens.{i}"], gen, _split(opt_state, i))
    return state
