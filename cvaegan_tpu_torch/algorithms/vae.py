"""VAE, an unconditional encoder and decoder with an auxiliary classifier:
the counterpart of `cvaegan_tpu/algorithms/vae.py`.

Capability parity with reference `src/vae.py` + `src/models/vae_models.py`:
per epoch, the auxiliary classifier takes `c_loop_num` CE steps on real
data and the encoder/decoder take `g_loop_num` joint steps on
`lambda_recon*MSE + lambda_kl*KL` over uniform random batches
(`src/vae.py:94-117`). `generate_samples(num)` and
`reconstruct_samples(samples)` are unconditional;
`generate_qualified_samples(label, num)` filters via the auxiliary
classifier.

Divergence kept from the JAX package (its documented fix): the reference
VAE cannot be constructed at all, since it references
`models.ClassifierModel`, which does not exist (`src/vae.py:24`); the
standard classifier architecture (`src/models/vae_models.py:110-151`) is
built instead.
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


class VAE(UnconditionalTrainer):
    name = "vae"
    config_key = "vae"
    loss_keys = ("recon_loss", "kl_loss")
    loops = ("c", "g")
    decoder_name = "decoder"

    def _build(self, init_generator: torch.Generator) -> Dict[str, nn.Module]:
        z_size = self.gan_cfg.z_size
        nets = {
            "encoder": mlp.GaussianEncoder(self.feature_num, 0, latent_dim=z_size),
            "decoder": mlp.Generator(z_size, self.feature_num),
            "classifier": mlp.Classifier(self.feature_num, self.label_num),
        }
        return {k: init_net(v, init_generator, self.device) for k, v in nets.items()}

    @staticmethod
    def _jax_dims(tree):
        return convert.unconditional_dims(tree, "decoder")

    def _g_step(self, x_real, eps) -> Dict[str, torch.Tensor]:
        """Joint encoder/decoder update on MSE + KL (`src/vae.py:94-117`)."""
        hp = self.hparams
        enc, dec = self.state["encoder"].train(), self.state["decoder"].train()

        def loss_fn():
            mu, log_var = enc(x_real)
            x_recon, _ = dec(mu + eps.to(log_var.dtype) * torch.exp(0.5 * log_var))
            parts = {"recon_loss": losses.mse(x_recon, x_real),
                     "kl_loss": losses.kl_standard_normal(mu, log_var)}
            return (hp["lambda_recon"] * parts["recon_loss"]
                    + hp["lambda_kl"] * parts["kl_loss"]), parts

        _, parts = grad_update_pair(self.optimizers["encoder"],
                                    self.optimizers["decoder"], loss_fn)
        return {k: v.detach() for k, v in parts.items()}

    def _round(self, class_id, epoch, counts):
        for _ in range(counts["c"]):
            self._c_step(*self._random_batch())
        for _ in range(counts["g"]):
            x_real, _ = self._random_batch()
            out = self._g_step(x_real, self._eps_batch())
        return out

    def reconstruct_samples(self, samples) -> np.ndarray:  # type: ignore[override]
        """Unconditional encode -> decode (`src/vae.py:reconstruct_samples`)."""
        return self._reconstruct(samples, None)
