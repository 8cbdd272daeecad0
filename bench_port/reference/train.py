"""Plain PyTorch training of the CVAE-GAN configuration: the reference
that the fit cells' first epochs are held to.

The published training loop (`src/cvae_gan.py:100-216`) in strict mode:
per epoch, for each class present in order, D steps (Wasserstein critic
loss), C steps (cross entropy on real and generated rows) and E+G steps
(reconstruction, KL, adversarial and progressive class loss), each
network stepped by Adam in optax's order. Every random input is drawn from one
`torch.Generator` per replica, seeded as the trainer's, in the order and
at the shapes the published loop draws them: rows (an int32 draw modulo
the class's size), the prior z, the reparameterisation noise and the
dropout masks.

`fit` runs K replicas at once (a leading axis on every leaf and batch),
from fresh Adams and generators or from a given state, and records what
the comparison reads: each epoch's losses, each Adam's first moment after
the first call, every leaf's gradient scale in the first epoch, and the
state after the last call.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from bench_port.reference import nets

INT32_MAX = 2**31 - 1


class Draws:
    """Each replica's own generator; a draw of `shape` gives `[K, *shape]`,
    replica k's slice drawn from generator k as a single model draws it."""

    def __init__(self, seeds: Sequence[int], device):
        self.device = torch.device(device)
        self.gens = [torch.Generator(device=self.device).manual_seed(int(s)) for s in seeds]

    def _stack(self, fn):
        return torch.stack([fn(g) for g in self.gens])

    def randint(self, high: int, shape) -> torch.Tensor:
        return self._stack(lambda g: torch.randint(0, high, tuple(shape), generator=g,
                                                   device=self.device))

    def normal(self, shape) -> torch.Tensor:
        return self._stack(lambda g: torch.randn(tuple(shape), generator=g, device=self.device))

    def uniform(self, shape) -> torch.Tensor:
        return self._stack(lambda g: torch.rand(tuple(shape), generator=g, device=self.device))


class Data:
    """Each replica's rows `[N, F]` and its rows of each class."""

    def __init__(self, samples: Sequence[torch.Tensor], labels: Sequence[torch.Tensor],
                 label_num: int):
        self.samples = list(samples)
        self.by_class = [[torch.nonzero(y == c).flatten() for c in range(label_num)]
                         for y in labels]
        self.present = [c for c in range(label_num)
                        if any(len(bc[c]) for bc in self.by_class)]

    def batch(self, draws: Draws, c: int, rows: int):
        r = draws.randint(INT32_MAX, (rows,))
        x = torch.stack([s[bc[c][r[k] % max(len(bc[c]), 1)]]
                         for k, (s, bc) in enumerate(zip(self.samples, self.by_class))])
        y = torch.full((len(self.samples), rows), c, dtype=torch.int64, device=x.device)
        return x, y


class AdamState:
    """Adam over one network's parameters, in optax's order:
    m <- (1 - b1) g + b1 m, v <- (1 - b2) g^2 + b2 v, t <- t + 1,
    p <- p - lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr, b1, b2, eps):
        self.params = params
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k] = (1.0 - self.b1) * g + self.b1 * self.m[k]
            self.v[k] = (1.0 - self.b2) * g * g + self.b2 * self.v[k]
            p -= self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps)


def cross_entropy(logits, y):
    """Mean cross entropy over the rows of each replica -> [K]."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, y[..., None])[..., 0].mean(-1)


def progressive_lambda(epoch: int, lam: float, warmup: int, full: int) -> float:
    return lam * min(max((epoch - warmup) / float(max(full - warmup, 1)), 0.0), 1.0)


class Trainer:
    """K replicas of one configuration's four networks, their Adams, and
    the strict training loop."""

    def __init__(self, cfg: dict, leaves: Dict[str, Dict[str, torch.Tensor]],
                 data: Data, draws: Draws, half_batch: bool = False):
        self.cfg = cfg
        self.data, self.draws = data, draws
        self.p = {net: {k: t.clone() for k, t in ls.items()} for net, ls in leaves.items()}
        for ls in self.p.values():
            for k, t in ls.items():
                t.requires_grad_(not nets.is_buffer(k))
        lrs = {"encoder": cfg["g_lr"], "generator": cfg["g_lr"],
               "discriminator": cfg["d_lr"], "classifier": cfg["c_lr"]}
        self.opt = {net: AdamState({k: t for k, t in ls.items() if not nets.is_buffer(k)},
                                   lrs[net], cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"])
                    for net, ls in self.p.items()}
        self.c = cfg["label_num"]
        #: the planted fault of a control run: each loss the mean over the
        #: first half of the rows only
        self.half = half_batch
        self.grad_sq: Dict[str, Dict[str, torch.Tensor]] = {}
        self.grad_steps: Dict[str, int] = {}
        self.recording = False

    def resume(self, start: dict) -> None:
        """Continue from `start`: its Adam moments and step counts, and
        each replica's generator state (the leaves are the constructor's)."""
        for net, o in self.opt.items():
            o.m = {k: start["adam_m"][net][k].clone() for k in o.params}
            o.v = {k: start["adam_v"][net][k].clone() for k in o.params}
            o.t = int(start["t"][net])
        for g, s in zip(self.draws.gens, start["rng"]):
            g.set_state(s.clone())

    @torch.no_grad()
    def state(self) -> dict:
        """{"leaves", "adam_m", "adam_v", "t", "rng"}: what `resume` takes."""
        return {"leaves": {net: {k: t.detach().clone() for k, t in ls.items()}
                           for net, ls in self.p.items()},
                "adam_m": {net: {k: m.clone() for k, m in o.m.items()}
                           for net, o in self.opt.items()},
                "adam_v": {net: {k: v.clone() for k, v in o.v.items()}
                           for net, o in self.opt.items()},
                "t": {net: o.t for net, o in self.opt.items()},
                "rng": [g.get_state() for g in self.draws.gens]}

    # ------------------------------------------------------------ helpers
    def _rows(self, t):
        return t[:, : t.shape[1] // 2] if self.half else t

    def _update(self, nets_: List[str], total: torch.Tensor) -> None:
        params = [(n, k, t) for n in nets_ for k, t in self.opt[n].params.items()]
        grads = torch.autograd.grad(total.sum(), [t for _, _, t in params])
        by_net: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in nets_}
        for (n, k, _), g in zip(params, grads):
            by_net[n][k] = g
            if self.recording:
                acc = self.grad_sq.setdefault(n, {})
                acc[k] = acc.get(k, 0.0) + g.detach().square()
        for n in nets_:
            if self.recording:
                self.grad_steps[n] = self.grad_steps.get(n, 0) + 1
            self.opt[n].step(by_net[n])

    def _wass_d(self, scores, rows):
        real, fake = scores[:, :rows], scores[:, rows:]
        return -self._rows(real).mean(dim=(-2, -1)) + self._rows(fake).mean(dim=(-2, -1))

    # -------------------------------------------------------------- steps
    def _gen(self, z, y):
        return nets.cvae_generator(self.p["generator"], z, y, self.c)

    def d_step(self, x, y, z):
        cfg, rows = self.cfg, x.shape[1]
        with torch.no_grad():
            fake = self._gen(z, y)
        xx, yy = torch.cat([x, fake], dim=1), torch.cat([y, y], dim=1)
        scores = nets.cvae_discriminator(self.p["discriminator"], xx, yy, self.c, self.draws)
        self._update(["discriminator"], self._wass_d(scores, rows))

    def c_step(self, x, y, z):
        rows = x.shape[1]
        with torch.no_grad():
            fake = self._gen(z, y)
        logits = nets.cvae_classifier(self.p["classifier"], torch.cat([x, fake], dim=1),
                                      self.draws)
        loss = (cross_entropy(self._rows(logits[:, :rows]), self._rows(y))
                + cross_entropy(self._rows(logits[:, rows:]), self._rows(y)))
        self._update(["classifier"], loss)

    def g_step(self, x, y, zp, eps, lam_class):
        cfg, c, p = self.cfg, self.c, self.p
        mu, lv = nets.cvae_encoder(p["encoder"], x, y, c)
        z_enc = mu + eps * torch.exp(0.5 * lv)
        recon = self._gen(z_enc, y)
        fake = self._gen(zp, y)
        d_fake = nets.cvae_discriminator(p["discriminator"], fake, y, c, self.draws)
        logits = nets.cvae_classifier(p["classifier"], fake, self.draws)
        r = self._rows
        parts = {
            "recon_loss": (r(recon) - r(x)).square().mean(dim=(-2, -1)),
            "kl_loss": -0.5 * (1.0 + r(lv) - r(mu).square() - torch.exp(r(lv))).sum(
                dim=(-2, -1)) / r(mu).shape[1],
            "adv_loss": -r(d_fake).mean(dim=(-2, -1)),
            "class_loss": cross_entropy(r(logits), r(y)),
        }
        total = (cfg["lambda_recon"] * parts["recon_loss"] + cfg["lambda_kl"] * parts["kl_loss"]
                 + cfg["lambda_adv"] * parts["adv_loss"] + lam_class * parts["class_loss"])
        self._update(["encoder", "generator"], total)
        return {k: v.detach() for k, v in parts.items()}

    def epoch(self, number: int) -> Dict[str, torch.Tensor]:
        cfg, bs = self.cfg, self.cfg["batch_size"]
        lam = progressive_lambda(number, cfg["lambda_class"], cfg["lambda_class_warmup"],
                                 cfg["lambda_class_full"])
        out = None
        for c in self.data.present:
            for _ in range(cfg["d_loop_num"]):
                x, y = self.data.batch(self.draws, c, bs)
                self.d_step(x, y, self.draws.normal((bs, cfg["z_size"])))
            for _ in range(cfg["c_loop_num"]):
                x, y = self.data.batch(self.draws, c, bs)
                self.c_step(x, y, self.draws.normal((bs, cfg["z_size"])))
            for _ in range(cfg["g_loop_num"]):
                x, y = self.data.batch(self.draws, c, bs)
                zp = self.draws.normal((bs, cfg["z_size"]))
                eps = self.draws.normal((bs, cfg["z_size"]))
                out = self.g_step(x, y, zp, eps, lam)
        return out


def loss_keys(cfg: dict) -> List[str]:
    return ["recon_loss", "kl_loss", "adv_loss", "class_loss"]


def fit(cfg: dict, leaves, data: Data, seeds: Sequence[int], calls: Sequence[int],
        device, half_batch: bool = False, start: dict = None) -> dict:
    """Train K replicas through `calls` fit calls of that many epochs each
    (each call numbers its epochs from 0, as a trainer's `fit` does), from
    `leaves` with fresh Adams and generators seeded `seeds`, or, given
    `start` (`Trainer.state`'s keys), from that state.
    Returns {"losses": [epochs, K, keys], "adam_m": {net: {leaf: [K,
    ...]}}, each Adam's first moment after the first call, "grad_rms":
    {net: {leaf: [K, ...]}}, each element's root-mean-square gradient over
    the first epoch's steps, "leaves": {net: {leaf: [K, ...]}} at the end,
    and "end", the whole state at the end}."""
    tr = Trainer(cfg, leaves, data, Draws(seeds, device), half_batch=half_batch)
    if start is not None:
        tr.resume(start)
    keys = loss_keys(cfg)
    losses, adam_m = [], None
    for i, n in enumerate(calls):
        for e in range(n):
            tr.recording = i == 0 and e == 0
            out = tr.epoch(e)
            losses.append(torch.stack([out[k] for k in keys], dim=-1))
        if i == 0:
            adam_m = {net: {k: m.detach().clone() for k, m in o.m.items()}
                      for net, o in tr.opt.items()}
    grad_rms = {net: {k: torch.sqrt(sq / tr.grad_steps[net]) for k, sq in acc.items()}
                for net, acc in tr.grad_sq.items()}
    end = tr.state()
    return {"losses": torch.stack(losses), "adam_m": adam_m, "grad_rms": grad_rms,
            "leaves": end["leaves"], "end": end}
