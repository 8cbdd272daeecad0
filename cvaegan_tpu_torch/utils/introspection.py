"""Model introspection: first-layer feature importance, the counterpart of
`cvaegan_tpu/utils/introspection.py` (reference
`src/models/cvae_gan_models.py:231-247,285-292`): the mean |weight| of a
network's first dense layer per input feature.

"First" is the JAX package's: the first `kernel` leaf of the network's
Flax parameter tree in its flattening order, which sorts keys at every
level (so for the encoder and the generator it is the `Dense_0` head,
not the trunk's first layer). The port's layer at that path is found with
`convert.net_leaves`; its `[out, in]` weight is the kernel transposed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from torch import nn

from cvaegan_tpu_torch.convert import net_leaves
from cvaegan_tpu_torch.parallel.mesh import gather_leaf


def first_dense_kernel(net: nn.Module) -> Optional[np.ndarray]:
    """The JAX `[in, out]` kernel of the network's first dense layer (whole:
    gathered over 'model' where `parallel.mesh.place` sliced it)."""
    kernels = sorted(path for path in net_leaves(net)
                     if path[0] == "params" and path[-1] == "kernel")
    if not kernels:
        return None
    tensor, _ = net_leaves(net)[kernels[0]]
    return gather_leaf(tensor).detach().cpu().numpy().T


def first_layer_importance(net: nn.Module) -> Optional[np.ndarray]:
    """Mean |W| over the output dim of the first dense layer ->
    per-input-feature importance [in_features]."""
    kernel = first_dense_kernel(net)
    if kernel is None:
        return None
    return np.mean(np.abs(kernel), axis=1)


def split_importance(net: nn.Module, in_features: int
                     ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Conditional-network variant: (data_importance, condition_importance)."""
    imp = first_layer_importance(net)
    if imp is None:
        return None, None
    return imp[:in_features], imp[in_features:]
