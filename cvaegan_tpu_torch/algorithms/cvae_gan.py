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
from cvaegan_tpu_torch.core.state import grad_update_pair, init_net
from cvaegan_tpu_torch.models import mlp
from cvaegan_tpu_torch.utils import profiling


class CVAEGAN(GenerativeTrainer):
    name = "cvae_gan"
    config_key = "cvae_gan"
    loss_keys = ("recon_loss", "kl_loss", "adv_loss", "class_loss")
    loops = ("d", "c", "g")

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

    _jax_dims = staticmethod(convert.cvaegan_dims)

    # ------------------------------------------------------------- steps
    @profiling.spanned("step.eg")
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
            # eps in the encoder's output dtype, as JAX's `reparameterize`
            # draws it (bf16 under the bf16 policy)
            z_enc = mu + eps.to(log_var.dtype) * torch.exp(0.5 * log_var)
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
        z_prior = self._z_batch()
        eps = self._eps_batch()
        return x_real, y, z_prior, eps

    def _round(self, class_id, epoch, counts):
        """D, C, then G steps on the class (`cvae_gan.py:230-262` of the
        JAX package); every batch, z and eps drawn from the trainer's
        generator."""
        lam = self._lambda_class(epoch)
        for _ in range(counts["d"]):
            self._d_step(*self._sample_batch(class_id), self._z_batch())
        for _ in range(counts["c"]):
            self._c_step(*self._sample_batch(class_id), self._z_batch())
        for _ in range(counts["g"]):
            out = self._g_step(*self._g_inputs(class_id), lam)
        return out

    # --------------------------------------------------------- generation
    def reconstruct_samples(self, samples, labels) -> np.ndarray:
        """Encode with reparameterisation, then decode (reference
        `src/cvae_gan.py:380-397`)."""
        return self._reconstruct(samples, labels)
