"""Network state for the port: the serving half of `cvaegan_tpu/core/state.py`.

In the JAX package a network's state is a `NetState` pytree of params,
mutable collections and optimizer state. Here a network is an
`nn.Module` that holds its parameters and buffers (BatchNorm running
statistics, spectral `u`/`v`) itself. This module builds a network's
initial state and runs its forwards; the optimizer step (Adam,
`grad_update`, `grad_update_pair`) belongs to the training slice.
"""

from __future__ import annotations

import torch
from torch import nn


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA is never dropped quietly:
    without it, only an explicit `device="cpu"` runs."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device


@torch.no_grad()
def init_net(module: nn.Module, generator: torch.Generator,
             device: torch.device) -> nn.Module:
    """Draw every layer's initial parameters from `generator` (a CPU
    generator, so a seed gives the same weights on every device) and move
    the network to `device`."""
    for m in module.modules():
        if hasattr(m, "init_from"):
            m.init_from(generator)
    return module.to(device)


def apply_eval(module: nn.Module, *args, **kwargs):
    """Forward pass in eval mode (running BatchNorm statistics, frozen
    spectral u/v, no dropout), without gradient."""
    was_training = module.training
    module.eval()
    try:
        with torch.no_grad():
            return module(*args, **kwargs)
    finally:
        module.train(was_training)


def apply_train(module: nn.Module, *args, **kwargs):
    """Forward pass in train mode without gradient. BatchNorm statistics
    and spectral u/v update in place, as torch modules in `.train()` mode
    under `no_grad` do (reference `src/cvae_gan.py:110-113`)."""
    was_training = module.training
    module.train()
    try:
        with torch.no_grad():
            return module(*args, **kwargs)
    finally:
        module.train(was_training)
