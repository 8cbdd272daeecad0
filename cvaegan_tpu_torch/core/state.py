"""Network and optimizer state for the port, the counterpart of
`cvaegan_tpu/core/state.py`.

In the JAX package a network's state is a `NetState` pytree of params,
mutable collections and optax state. Here a network is an `nn.Module`
that holds its parameters and buffers (BatchNorm running statistics,
spectral `u`/`v`) itself, and its optimizer is an `Adam` that holds its
moments and step count as tensors on the same device. Every update is in
place, so the tensors keep their addresses and a captured CUDA graph of
training steps stays valid across replays.
"""

from __future__ import annotations

from typing import Callable, Sequence

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


class Adam:
    """optax's Adam (`scale_by_adam` then `-lr`), written out in its order:

        m <- (1 - b1) g + b1 m;  v <- (1 - b2) g^2 + b2 v;  t <- t + 1
        p <- p + (-lr) (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

    The step count `t` is an int32 tensor on the parameters' device, and
    every update is an in-place `torch._foreach_*` op, so a step reads no
    value on the host and can be captured. GAN betas are 0.5/0.999
    (reference `src/cvae_gan.py:75-97`); the downstream classifier uses
    optax's defaults 0.9/0.999."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32, device=self.params[0].device)

    def tensors(self):
        """Every tensor of the optimizer's state."""
        return [*self.m, *self.v, self.count]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        b1, b2 = self.b1, self.b2
        grads = list(grads)
        torch._foreach_mul_(self.m, b1)
        torch._foreach_add_(self.m, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.v, b2)
        torch._foreach_add_(self.v, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - b2))
        self.count.add_(1)
        t = self.count.to(torch.float32)
        m_hat = torch._foreach_div(self.m, 1.0 - torch.pow(b1, t))
        denom = torch._foreach_sqrt(torch._foreach_div(self.v, 1.0 - torch.pow(b2, t)))
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(m_hat, denom)
        torch._foreach_mul_(update, -self.lr)
        torch._foreach_add_(self.params, update)


def adam(module: nn.Module, lr: float, b1: float = 0.5, b2: float = 0.999) -> Adam:
    """GAN-family Adam over a network's parameters (reference betas
    `src/cvae_gan.py:75-97`)."""
    return Adam(list(module.parameters()), lr, b1, b2)


def grad_update(opt: Adam, loss_fn: Callable[[], tuple]):
    """One optimizer step on one network: `loss_fn() -> (loss, aux)`;
    gradients are taken over `opt.params` only (no `.grad` fields are
    written). Returns (loss, aux)."""
    loss, aux = loss_fn()
    opt.step(torch.autograd.grad(loss, opt.params))
    return loss, aux


def grad_update_pair(opt_a: Adam, opt_b: Adam, loss_fn: Callable[[], tuple]):
    """One joint step on two networks sharing a loss (the encoder +
    generator update, reference `src/cvae_gan.py:159-216`): one backward
    over both parameter lists, two optimizers."""
    loss, aux = loss_fn()
    grads = torch.autograd.grad(loss, [*opt_a.params, *opt_b.params])
    opt_a.step(grads[:len(opt_a.params)])
    opt_b.step(grads[len(opt_a.params):])
    return loss, aux
