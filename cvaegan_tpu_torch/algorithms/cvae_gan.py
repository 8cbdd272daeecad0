"""CVAE-GAN, the flagship 4-network conditional VAE-GAN, the counterpart
of `cvaegan_tpu/algorithms/cvae_gan.py`.

Capability parity with reference `src/cvae_gan.py` +
`src/models/cvae_gan_models.py`:
  * per-class round-robin training: D x5 (Wasserstein sign loss), C x5
    (CE on real + fake), E+G x3 (recon MSE + KL + adversarial + CE) per
    class per epoch (`src/cvae_gan.py:100-216`), or one mixed round in
    `balanced_mode`;
  * strict z_enc (recon/KL) vs z_prior (adv/class) separation (`:159-216`);
  * progressive lambda_class: 0 for e < 200, linear ramp 200 -> 500;
  * prior sampling, confidence-filtered sampling, reconstruction
    (`:339-397`).

Each step takes its random inputs (x_real, y, z, eps) from the caller,
which draws them from the trainer's generator; only the dropout masks are
drawn inside, from the same generator. So the epoch can be captured as
one CUDA graph (see the base class), and a test can feed the port and the
JAX package the same inputs.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from cvaegan_tpu_torch import convert
from cvaegan_tpu_torch.algorithms.base import GenerativeTrainer
from cvaegan_tpu_torch.core import losses
from cvaegan_tpu_torch.core.schedules import progressive_lambda
from cvaegan_tpu_torch.core.state import (
    Adam,
    adam,
    apply_eval,
    apply_train,
    grad_update,
    grad_update_pair,
    init_net,
)
from cvaegan_tpu_torch.models import mlp


class CVAEGAN(GenerativeTrainer):
    name = "cvae_gan"
    config_key = "cvae_gan"
    loss_keys = ("recon_loss", "kl_loss", "adv_loss", "class_loss")

    # ------------------------------------------------------------- build
    def _build(self, init_generator: torch.Generator) -> Dict[str, nn.Module]:
        z_size = self.gan_cfg.z_size
        nets = {
            "encoder": mlp.GaussianEncoder(
                self.feature_num, self.label_num, latent_dim=z_size),
            "generator": mlp.Generator(
                z_size, self.feature_num, num_classes=self.label_num),
            "discriminator": mlp.Discriminator(
                self.feature_num, self.label_num, spectral=True),
            "classifier": mlp.Classifier(self.feature_num, self.label_num),
        }
        return {k: init_net(v, init_generator, self.device) for k, v in nets.items()}

    def _build_optimizers(self, nets: Dict[str, nn.Module]) -> Dict[str, Adam]:
        cfg = self.gan_cfg
        lrs = {"encoder": cfg.g_lr, "generator": cfg.g_lr,
               "discriminator": cfg.d_lr, "classifier": cfg.c_lr}
        return {k: adam(nets[k], lr, cfg.adam_b1, cfg.adam_b2) for k, lr in lrs.items()}

    _jax_dims = staticmethod(convert.cvaegan_dims)

    # ------------------------------------------------------------- steps
    def _fake(self, z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Generator output in train mode under no-grad: its BatchNorm
        statistics update (torch `.train()` + `no_grad`,
        `src/cvae_gan.py:110-113`)."""
        x_fake, _ = apply_train(self.state["generator"], z, y)
        return x_fake

    def _d_step(self, x_real, y, z) -> torch.Tensor:
        """Critic update: -E[D(x,y)] + E[D(G(z,y),y)] (reference
        `src/cvae_gan.py:104-128`), one forward over concat(real, fake)
        with one spectral power iteration, as in the JAX package."""
        x_fake = self._fake(z, y)
        dis = self.state["discriminator"].train()

        def loss_fn():
            scores, _ = dis(torch.cat([x_real, x_fake]), torch.cat([y, y]),
                            self.generator)
            d_real, d_fake = scores.chunk(2)
            return losses.wasserstein_d_loss(d_real, d_fake), None

        loss, _ = grad_update(self.optimizers["discriminator"], loss_fn)
        return loss.detach()

    def _c_step(self, x_real, y, z) -> torch.Tensor:
        """Companion-classifier update: CE(real) + CE(fake) over one fused
        forward (reference `src/cvae_gan.py:131-157`)."""
        x_fake = self._fake(z, y)
        clf = self.state["classifier"].train()

        def loss_fn():
            logits = clf(torch.cat([x_real, x_fake]), self.generator)
            real_logits, fake_logits = logits.chunk(2)
            return (losses.cross_entropy(real_logits, y)
                    + losses.cross_entropy(fake_logits, y)), None

        loss, _ = grad_update(self.optimizers["classifier"], loss_fn)
        return loss.detach()

    def _g_step(self, x_real, y, z_prior, eps, lam_class) -> Dict[str, torch.Tensor]:
        """Joint encoder + generator update (reference
        `src/cvae_gan.py:159-216`): recon MSE + KL on z_enc = mu + eps
        exp(log_var / 2); adversarial + CE on z_prior. The generator runs
        on z_enc, then on z_prior, each updating its BatchNorm statistics;
        D and C run in train mode (dropout, D's spectral u/v updating) but
        only E and G are stepped."""
        hp = self.hparams
        enc, gen = self.state["encoder"].train(), self.state["generator"].train()
        dis, clf = self.state["discriminator"].train(), self.state["classifier"].train()

        def loss_fn():
            mu, log_var = enc(x_real, y)
            z_enc = mu + eps * torch.exp(0.5 * log_var)
            x_recon, _ = gen(z_enc, y)
            x_fake, _ = gen(z_prior, y)
            d_fake, _ = dis(x_fake, y, self.generator)
            logits = clf(x_fake, self.generator)
            parts = {"recon_loss": losses.mse(x_recon, x_real),
                     "kl_loss": losses.kl_standard_normal(mu, log_var),
                     "adv_loss": losses.wasserstein_g_loss(d_fake),
                     "class_loss": losses.cross_entropy(logits, y)}
            total = (hp["lambda_recon"] * parts["recon_loss"]
                     + hp["lambda_kl"] * parts["kl_loss"]
                     + hp["lambda_adv"] * parts["adv_loss"]
                     + lam_class * parts["class_loss"])
            return total, parts

        _, parts = grad_update_pair(self.optimizers["encoder"],
                                    self.optimizers["generator"], loss_fn)
        return {k: v.detach() for k, v in parts.items()}

    # ------------------------------------------------------------- epoch
    def _g_inputs(self, class_id: Optional[int]):
        x_real, y = self._sample_batch(class_id)
        z_prior = self._prior(self.gan_cfg.batch_size)
        eps = self._prior(self.gan_cfg.batch_size)
        return x_real, y, z_prior, eps

    def _lambda_class(self, epoch: torch.Tensor) -> torch.Tensor:
        return progressive_lambda(epoch, self.hparams["lambda_class"], 200, 500)

    def _epoch_body(self, epoch: torch.Tensor) -> Dict[str, torch.Tensor]:
        """D x5, C x5, G x3 per class round (`cvae_gan.py:230-262` of the
        JAX package); every batch, z and eps drawn from the trainer's
        generator. The losses are the last round's last G step's."""
        cfg = self.gan_cfg
        bs = cfg.batch_size
        lam = self._lambda_class(epoch)
        out = None
        for class_id in self._class_rounds():
            for _ in range(cfg.d_loop_num):
                self._d_step(*self._sample_batch(class_id), self._prior(bs))
            for _ in range(cfg.c_loop_num):
                self._c_step(*self._sample_batch(class_id), self._prior(bs))
            for _ in range(cfg.g_loop_num):
                out = self._g_step(*self._g_inputs(class_id), lam)
        return out

    def _warm_up(self) -> None:
        class_id = self._class_rounds()[0]
        bs = self.gan_cfg.batch_size
        self._d_step(*self._sample_batch(class_id), self._prior(bs))
        self._c_step(*self._sample_batch(class_id), self._prior(bs))
        self._g_step(*self._g_inputs(class_id), self._lambda_class(self._epoch_t))

    # --------------------------------------------------------- generation
    def _generator_forward(self, state, z, labels):
        x, _ = apply_eval(state["generator"], z, labels)
        return x

    def _classifier_logits(self, state, x):
        return apply_eval(state["classifier"], x)

    @torch.no_grad()
    def reconstruct_samples(self, samples, labels) -> np.ndarray:
        """Encode with reparameterisation, then decode (reference
        `src/cvae_gan.py:380-397`)."""
        self._require_state()
        x = torch.as_tensor(np.asarray(samples, np.float32), device=self.device)
        y = torch.as_tensor(np.asarray(labels, np.int64), device=self.device)
        mu, log_var = apply_eval(self.state["encoder"], x, y)
        z = mlp.reparameterize(mu, log_var, self.generator)
        out, _ = apply_eval(self.state["generator"], z, y)
        return out.cpu().numpy()
