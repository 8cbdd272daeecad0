"""What the harness takes from the program under test, `cvaegan_tpu_torch`:
its trainers, their settings, and their state as the comparison reads
it. The program is imported here and in the drivers only, never by the
reference.
"""

from __future__ import annotations

from typing import Dict, List

import torch

#: the configuration's keys that are the program's settings
SETTINGS_KEYS = ("batch_size", "z_size", "g_lr", "d_lr", "c_lr", "d_loop_num", "c_loop_num",
                 "g_loop_num", "adam_b1", "adam_b2", "compute_dtype")
TRAINERS = {"cvae_gan": "CVAEGAN"}


def settings(cfg: dict, seed: int):
    """The program's settings for configuration `cfg`."""
    from cvaegan_tpu_torch.core import config as port_config

    s = port_config.Settings()
    s.seed = int(seed)
    for key in SETTINGS_KEYS:
        setattr(s.gan, key, cfg[key])
    return s


def trainer_class(cfg: dict):
    import cvaegan_tpu_torch

    return getattr(cvaegan_tpu_torch, TRAINERS[cfg["model"]])


def check_trainer(trainer, cfg: dict, layout) -> None:
    """Raise where the program's trainer departs from the configuration:
    its loss weights, its Adam's eps, or the leaves of its networks."""
    for key, value in trainer.hparams.items():
        if key.startswith("lambda_") and cfg.get(key) != value:
            raise RuntimeError(f"the program's {key} is {value}, the configuration's "
                               f"{cfg.get(key)}")
    for name, opt in trainer.optimizers.items():
        if opt.eps != cfg["adam_eps"]:
            raise RuntimeError(f"the program's Adam eps of {name} is {opt.eps}")
    for net, leaves in layout.items():
        theirs = [(k, tuple(t.shape)) for k, t in trainer.state[net].state_dict().items()]
        ours = [(k, tuple(s)) for k, s, _ in leaves]
        if theirs != ours:
            raise RuntimeError(f"the program's {net} holds {theirs}, the configuration "
                               f"{ours}")


@torch.no_grad()
def load_leaves(trainer, leaves: Dict[str, Dict[str, torch.Tensor]], k: int) -> None:
    """Copy replica k of the benchmark's leaves into the trainer's
    networks, in place."""
    for net, ls in leaves.items():
        for name, t in trainer.state[net].state_dict(keep_vars=True).items():
            t.copy_(ls[name][k])


@torch.no_grad()
def state_leaves(trainers: List) -> Dict[str, Dict[str, torch.Tensor]]:
    """{net: {leaf: [K, ...]}} of the trainers' networks."""
    nets = trainers[0].state.keys()
    return {net: {name: torch.stack([t.state[net].state_dict()[name].detach().clone()
                                     for t in trainers])
                  for name in trainers[0].state[net].state_dict()}
            for net in nets}


@torch.no_grad()
def adam_moments(trainers: List) -> Dict[str, Dict[str, torch.Tensor]]:
    """{net: {parameter: [K, ...]}}: each optimizer's first moment, by the
    name of the parameter it steps."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for net in trainers[0].optimizers:
        names = [n for n, _ in trainers[0].state[net].named_parameters()]
        out[net] = {n: torch.stack([t.optimizers[net].m[i].detach().clone()
                                    for t in trainers])
                    for i, n in enumerate(names)}
    return out


def loss_history(trainers: List, keys, epochs: int, first: int = 0) -> torch.Tensor:
    """`epochs` recorded losses `[epochs, K, keys]`, from epoch `first`
    of the history (counted from its end where negative)."""
    n = len(trainers[0].loss_history[keys[0]])
    first = first % n if first < 0 else first
    return torch.tensor([[[t.loss_history[key][e] for key in keys] for t in trainers]
                         for e in range(first, first + epochs)], dtype=torch.float64)


def adam_counts(trainers: List) -> Dict[str, torch.Tensor]:
    """{net: [K]}: each optimizer's step count, on the host."""
    return {net: torch.stack([t.optimizers[net].count.detach().cpu().to(torch.int64).reshape(())
                              for t in trainers])
            for net in trainers[0].optimizers}


def _tensors(trainer) -> List[torch.Tensor]:
    out = [t for net in trainer.state.values() for t in net.state_dict(keep_vars=True).values()]
    for opt in trainer.optimizers.values():
        out += [*opt.m, *opt.v, opt.count]
    return out


class Snapshot:
    """The trainers' networks, Adam moments and counts, copied in place
    into buffers of their own, and their generators' states: taken before
    each window call, so that once the window has closed it holds the
    start of the last call, from which the reference follows that call's
    first epoch."""

    def __init__(self, trainers: List):
        self.trainers = trainers
        self.src = [x for t in trainers for x in _tensors(t)]
        self.buf = [x.detach().clone() for x in self.src]
        self.rng = None

    @torch.no_grad()
    def take(self) -> None:
        torch._foreach_copy_(self.buf, self.src)
        self.rng = [t.generator.get_state() for t in self.trainers]

    def start(self) -> dict:
        """{"leaves", "adam_m", "adam_v": {net: {leaf: [K, ...]}}, "t":
        {net: step count}, "rng": [each replica's generator state]}."""
        t0 = self.trainers[0]
        k = len(self.trainers)
        per = len(self.buf) // k
        rows = [self.buf[i * per:(i + 1) * per] for i in range(k)]
        at = 0

        def take(n):
            nonlocal at
            out = [torch.stack([r[at + j] for r in rows]) for j in range(n)]
            at += n
            return out

        leaves = {}
        for net, module in t0.state.items():
            names = list(module.state_dict())
            leaves[net] = dict(zip(names, take(len(names))))
        adam_m, adam_v, counts = {}, {}, {}
        for net in t0.optimizers:
            names = [n for n, _ in t0.state[net].named_parameters()]
            adam_m[net] = dict(zip(names, take(len(names))))
            adam_v[net] = dict(zip(names, take(len(names))))
            (count,) = take(1)
            if bool((count != count.flatten()[0]).any()):
                raise RuntimeError(f"the replicas' {net} step counts differ: {count.tolist()}")
            counts[net] = int(count.flatten()[0])
        return {"leaves": leaves, "adam_m": adam_m, "adam_v": adam_v, "t": counts,
                "rng": [s.clone() for s in self.rng]}
