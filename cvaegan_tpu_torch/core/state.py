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

from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

from cvaegan_tpu_torch.parallel import mesh as mesh_lib


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
    optax's defaults 0.9/0.999.

    With `replicas=K` every parameter carries a leading axis of K
    independent replicas (a seed bank's stacked networks) and `t` is one
    count per replica, shape `[K]`: the update is elementwise, so it is K
    separate Adams, and a replica whose state is put back after a masked
    step keeps its own count.

    After `parallel.mesh.place` over a mesh's 'model' axis, a sliced
    parameter's moments are the same slice of the whole moments (`place`
    slices them with it) and `t` stays whole: the update is elementwise,
    so each rank steps its slices as the whole Adam would."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 replicas: Optional[int] = None):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros(() if replicas is None else (replicas,),
                                 dtype=torch.int32, device=self.params[0].device)

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
        c1, c2 = 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)
        if self.count.dim():  # one count per replica, on each leading axis
            c1 = [c1.view(-1, *[1] * (p.dim() - 1)) for p in self.params]
            c2 = [c2.view(-1, *[1] * (p.dim() - 1)) for p in self.params]
        m_hat = torch._foreach_div(self.m, c1)
        denom = torch._foreach_sqrt(torch._foreach_div(self.v, c2))
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(m_hat, denom)
        torch._foreach_mul_(update, -self.lr)
        torch._foreach_add_(self.params, update)


def adam(module: nn.Module, lr: float, b1: float = 0.5, b2: float = 0.999) -> Adam:
    """GAN-family Adam over a network's parameters (reference betas
    `src/cvae_gan.py:75-97`)."""
    return Adam(list(module.parameters()), lr, b1, b2)


def _total(loss: torch.Tensor) -> torch.Tensor:
    """The scalar to differentiate: the loss itself, or the sum of a seed
    bank's per-replica losses (each replica's parameters get the gradient
    of its own loss alone)."""
    return loss if loss.dim() == 0 else loss.sum()


def _aux_tensors(aux) -> List[torch.Tensor]:
    if aux is None:
        return []
    if isinstance(aux, dict):
        return list(aux.values())
    return [aux]


def _with_aux(aux, values: List[torch.Tensor]):
    if aux is None:
        return None
    if isinstance(aux, dict):
        return dict(zip(aux, values))
    return values[0]


def _gradients(loss: torch.Tensor, aux, params: List[torch.Tensor]):
    """Gradients of the loss over `params`, and (loss, aux). Inside a
    mesh's `data_parallel` (`parallel/mesh.py`) each rank's loss is the
    mean over its own rows: it is weighed by the rank's share of the batch
    before the backward, and the gradients and the weighed loss and aux
    values are summed over the data axis in one flat all-reduce, so every
    rank steps with the gradient of the global-batch loss and returns its
    values. (The all-reduced loss is never differentiated: the SUM backward
    of the BatchNorm moments' all-reduce already sums over ranks.) The sum
    runs over the 'data' group only: under a 2-D mesh it holds the ranks
    of this rank's model coordinate, so a leaf's slice sums with the same
    slice of its peers, and a replicated leaf's gradient, computed alike
    on every model rank, is not summed over 'model' (that would scale it
    by the axis' size)."""
    layout = mesh_lib.batch_layout()
    if layout is None:
        return torch.autograd.grad(_total(loss), params), loss, aux
    w = layout.weight
    grads = torch.autograd.grad(_total(loss) * w, params)
    values = [loss, *_aux_tensors(aux)]
    out = mesh_lib.reduce_flat([*grads, *(v.detach() * w for v in values)], layout.group)
    grads, values = out[:len(grads)], out[len(grads):]
    return grads, values[0], _with_aux(aux, values[1:])


def grad_update(opt: Adam, loss_fn: Callable[[], tuple]):
    """One optimizer step on one network: `loss_fn() -> (loss, aux)`, aux
    None, a tensor or a dict of tensors; gradients are taken over
    `opt.params` only (no `.grad` fields are written). Returns (loss,
    aux)."""
    loss, aux = loss_fn()
    grads, loss, aux = _gradients(loss, aux, opt.params)
    opt.step(grads)
    return loss, aux


def grad_update_pair(opt_a: Adam, opt_b: Adam, loss_fn: Callable[[], tuple]):
    """One joint step on two networks sharing a loss (the encoder +
    generator update, reference `src/cvae_gan.py:159-216`): one backward
    over both parameter lists, two optimizers."""
    loss, aux = loss_fn()
    grads, loss, aux = _gradients(loss, aux, [*opt_a.params, *opt_b.params])
    opt_a.step(grads[:len(opt_a.params)])
    opt_b.step(grads[len(opt_a.params):])
    return loss, aux


def replicated_gradients(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Gradients of a loss every rank computes alike on the same
    (unsharded) inputs, as TMG-GAN's diversity step: inside a mesh's
    `data_parallel`, each rank's share 1/n, summed over the data axis in
    one flat all-reduce; `grads` as they are otherwise."""
    layout = mesh_lib.batch_layout()
    if layout is None:
        return list(grads)
    n = layout.mesh.shape["data"]
    return mesh_lib.reduce_flat([g / n for g in grads], layout.group)


def capture_graphs(bodies: Sequence[Callable[[], None]], warm_up: Callable[[], None],
                   static: Sequence[torch.Tensor], generators: Sequence[torch.Generator],
                   device: torch.device) -> List["torch.cuda.CUDAGraph"]:
    """Capture each of `bodies` as a CUDA graph with `generators`
    registered, so that each replay draws on from their current states.
    `warm_up` runs first on the capture stream (cuBLAS and the caching
    allocator settle there); its effects on the `static` tensors (every
    tensor the bodies update in place) and on the generators are undone
    before the captures. Raises where this torch cannot register a
    generator with a graph: the caller's plain version needs no capture."""
    if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        raise RuntimeError(
            "this torch cannot register a generator with a CUDA graph "
            "(CUDAGraph.register_generator_state); fit(eager=True) runs the "
            "plain version")
    stream = torch.cuda.Stream(device=device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.no_grad():
        saved = [t.detach().clone() for t in static]
    rng_states = [g.get_state() for g in generators]
    with torch.cuda.stream(stream):
        warm_up()
    torch.cuda.current_stream(device).wait_stream(stream)
    with torch.no_grad():
        for t, s in zip(static, saved):
            t.copy_(s)
    for g, rng_state in zip(generators, rng_states):
        g.set_state(rng_state)
    graphs = []
    for body in bodies:
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        with torch.cuda.graph(graph, stream=stream):
            body()
        graphs.append(graph)
    return graphs
