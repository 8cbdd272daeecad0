"""Plain PyTorch training of the RAIN-GAN configuration: the reference
that the RAIN-GAN fit cell's epochs are held to.

The published training loop (`src/rain_gan.py`) in strict mode: per
epoch, for each class present in order, D steps (Wasserstein critic
loss), C steps (cross entropy on real and generated rows) and E+G steps
(reconstruction, KL, adversarial and progressive class loss), every loss
plus `lambda_attention` times the mean attention entropy of the networks
it runs (eps 1e-9; `:137-140,168-171,216-237,269-289`): the critic's over
concat(real, fake) in D, the classifier's in C, the encoder's and the
generator's (on the prior z) in E+G. Each network is stepped by Adam in
optax's order, every random input drawn as `train.py` draws it: rows,
the prior z, then, in E+G, the reparameterisation noise. The networks
hold no dropout, so nothing else is drawn.

Departure, noted: the reconstruction runs the generator on z_enc = mu +
eps exp(log_var / 2), where the published E+G step redraws a prior z for
it (`src/rain_gan.py:194-201`); this is the documented fix that the
configuration records under `assumed`.

The loop, the Adams, the draws and the data are `train.py`'s; only the
networks and the losses differ. `fit` returns what `train.fit` returns,
with `attention_loss` among the loss keys.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from bench_port.reference import rain_nets
from bench_port.reference import train as base
from bench_port.reference.train import Data, Draws, cross_entropy


class Trainer(base.Trainer):
    """K replicas of RAIN-GAN's four networks, their Adams, and the strict
    training loop of `train.Trainer`."""

    def _entropy(self, probs: torch.Tensor) -> torch.Tensor:
        return rain_nets.attention_entropy(self._rows(probs))

    def _gen(self, z, y):
        return rain_nets.generator(self.p["generator"], z, y, self.c)[0]

    def d_step(self, x, y, z):
        rows = x.shape[1]
        with torch.no_grad():
            fake = self._gen(z, y)
        scores, probs = rain_nets.discriminator(
            self.p["discriminator"], torch.cat([x, fake], dim=1), torch.cat([y, y], dim=1),
            self.c)
        loss = self._wass_d(scores, rows) + self.cfg["lambda_attention"] * self._entropy(probs)
        self._update(["discriminator"], loss)

    def c_step(self, x, y, z):
        rows = x.shape[1]
        with torch.no_grad():
            fake = self._gen(z, y)
        logits, probs = rain_nets.classifier(self.p["classifier"], torch.cat([x, fake], dim=1))
        loss = (cross_entropy(self._rows(logits[:, :rows]), self._rows(y))
                + cross_entropy(self._rows(logits[:, rows:]), self._rows(y))
                + self.cfg["lambda_attention"] * self._entropy(probs))
        self._update(["classifier"], loss)

    def g_step(self, x, y, zp, eps, lam_class):
        cfg, c, p = self.cfg, self.c, self.p
        (mu, lv), e_probs = rain_nets.encoder(p["encoder"], x, y, c)
        z_enc = mu + eps * torch.exp(0.5 * lv)
        recon = self._gen(z_enc, y)
        fake, g_probs = rain_nets.generator(p["generator"], zp, y, c)
        d_fake, _ = rain_nets.discriminator(p["discriminator"], fake, y, c)
        logits, _ = rain_nets.classifier(p["classifier"], fake)
        r = self._rows
        parts = {
            "recon_loss": (r(recon) - r(x)).square().mean(dim=(-2, -1)),
            "kl_loss": -0.5 * (1.0 + r(lv) - r(mu).square() - torch.exp(r(lv))).sum(
                dim=(-2, -1)) / r(mu).shape[1],
            "adv_loss": -r(d_fake).mean(dim=(-2, -1)),
            "class_loss": cross_entropy(r(logits), r(y)),
            "attention_loss": self._entropy(e_probs) + self._entropy(g_probs),
        }
        total = (cfg["lambda_recon"] * parts["recon_loss"] + cfg["lambda_kl"] * parts["kl_loss"]
                 + cfg["lambda_adv"] * parts["adv_loss"] + lam_class * parts["class_loss"]
                 + cfg["lambda_attention"] * parts["attention_loss"])
        self._update(["encoder", "generator"], total)
        return {k: v.detach() for k, v in parts.items()}


def loss_keys(cfg: dict) -> List[str]:
    return ["recon_loss", "kl_loss", "adv_loss", "class_loss", "attention_loss"]


def fit(cfg: dict, leaves, data: Data, seeds: Sequence[int], calls: Sequence[int],
        device, half_batch: bool = False, start: dict = None) -> dict:
    """`train.fit` for RAIN-GAN: K replicas through `calls` fit calls from
    `leaves` (or from `start`), returning the same keys."""
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
    grad_rms: Dict[str, Dict[str, torch.Tensor]] = {
        net: {k: torch.sqrt(sq / tr.grad_steps[net]) for k, sq in acc.items()}
        for net, acc in tr.grad_sq.items()}
    end = tr.state()
    return {"losses": torch.stack(losses), "adam_m": adam_m, "grad_rms": grad_rms,
            "leaves": end["leaves"], "end": end}
