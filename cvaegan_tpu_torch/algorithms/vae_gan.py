"""VAE-GAN, an unconditional encoder, generator and critic: the
counterpart of `cvaegan_tpu/algorithms/vae_gan.py`.

Capability parity with reference `src/vae_gan.py` + `src/models/
vae_gan_models.py`: per epoch, D x5 (Wasserstein sign loss,
`src/vae_gan.py:77-100`) then E+G x3 on `1.0*MSE + 0.01*KL + 0.1*adv`
with strict z_enc/z_prior separation (`:103-141`), on uniform batches over
the whole train set. In the G step the generator runs on z_enc, then on
z_prior from the BatchNorm statistics the first forward left
(`vae_gan.py:106-111` of the JAX package). There is NO companion
classifier and hence NO qualified-sample filter: only `generate_samples`
and `reconstruct_samples` (`:241-262`); the pipeline's generation mode is
"unconditional".
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from cvaegan_tpu_torch import convert
from cvaegan_tpu_torch.algorithms.base import UnconditionalTrainer
from cvaegan_tpu_torch.core import losses
from cvaegan_tpu_torch.core.state import grad_update_pair, init_net
from cvaegan_tpu_torch.models import mlp


class VAEGAN(UnconditionalTrainer):
    name = "vae_gan"
    config_key = "vae_gan"
    loss_keys = ("recon_loss", "kl_loss", "adv_loss")
    loops = ("d", "g")

    def _build(self, init_generator: torch.Generator) -> Dict[str, nn.Module]:
        z_size = self.gan_cfg.z_size
        nets = {
            "encoder": mlp.GaussianEncoder(self.feature_num, 0, latent_dim=z_size),
            "generator": mlp.Generator(z_size, self.feature_num),
            "discriminator": mlp.Discriminator(self.feature_num, spectral=True),
        }
        return {k: init_net(v, init_generator, self.device) for k, v in nets.items()}

    @staticmethod
    def _jax_dims(tree):
        return convert.unconditional_dims(tree, "generator")

    def _g_step(self, x_real, z_prior, eps) -> Dict[str, torch.Tensor]:
        """Joint encoder + generator update with z_enc (recon/KL) vs
        z_prior (adv) separation (`src/vae_gan.py:103-141`); D runs in
        train mode (dropout, spectral u/v updating), only E and G are
        stepped."""
        hp = self.hparams
        enc, gen = self.state["encoder"].train(), self.state["generator"].train()
        dis = self.state["discriminator"].train()

        def loss_fn():
            mu, log_var = enc(x_real)
            x_recon, _ = gen(mu + eps.to(log_var.dtype) * torch.exp(0.5 * log_var))
            x_fake, _ = gen(z_prior)
            d_fake, _ = dis(x_fake, None, self.generator)
            parts = {"recon_loss": losses.mse(x_recon, x_real),
                     "kl_loss": losses.kl_standard_normal(mu, log_var),
                     "adv_loss": losses.wasserstein_g_loss(d_fake)}
            total = (hp["lambda_recon"] * parts["recon_loss"]
                     + hp["lambda_kl"] * parts["kl_loss"]
                     + hp["lambda_adv"] * parts["adv_loss"])
            return total, parts

        _, parts = grad_update_pair(self.optimizers["encoder"],
                                    self.optimizers["generator"], loss_fn)
        return {k: v.detach() for k, v in parts.items()}

    def _round(self, class_id, epoch, counts):
        for _ in range(counts["d"]):
            x_real, _ = self._random_batch()
            self._d_step(x_real, None, self._z_batch())
        for _ in range(counts["g"]):
            x_real, _ = self._random_batch()
            out = self._g_step(x_real, self._z_batch(), self._eps_batch())
        return out

    def generate_qualified_samples(self, *args, **kwargs):
        raise NotImplementedError(
            "VAE-GAN has no companion classifier and therefore no "
            "qualified-sample filter (reference `src/vae_gan.py` defines "
            "only generate_samples/reconstruct_samples)")

    def reconstruct_samples(self, samples) -> np.ndarray:  # type: ignore[override]
        """Unconditional encode -> decode (`src/vae_gan.py:246-262`)."""
        return self._reconstruct(samples, None)
