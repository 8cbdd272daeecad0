"""CVAE, the CVAE-GAN without the critic: the counterpart of
`cvaegan_tpu/algorithms/cvae.py`.

Capability parity with reference `src/cvae.py` + `src/models/
cvae_models.py`: per class per epoch, the companion classifier takes
`c_loop_num` CE(real)+CE(fake) steps, with the generator's BatchNorm
statistics kept (`cvae.py:72-76` of the JAX package), and encoder +
generator take `g_loop_num` joint steps on `lambda_recon*MSE +
lambda_kl*KL + progressive_lambda_class*CE(C(x_recon))`: the class loss
is on the RECONSTRUCTION, not a prior sample (`src/cvae.py:137-154`).
One mixed round per epoch in `balanced_mode`.

Each step takes its random inputs from the caller; only the dropout
masks are drawn inside, from the trainer's generator.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from cvaegan_tpu_torch import convert
from cvaegan_tpu_torch.algorithms.base import GenerativeTrainer
from cvaegan_tpu_torch.core import losses
from cvaegan_tpu_torch.core.state import grad_update_pair, init_net
from cvaegan_tpu_torch.models import mlp


class CVAE(GenerativeTrainer):
    name = "cvae"
    config_key = "cvae"
    loss_keys = ("recon_loss", "kl_loss", "class_loss")
    loops = ("c", "g")

    def _build(self, init_generator: torch.Generator) -> Dict[str, nn.Module]:
        z_size = self.gan_cfg.z_size
        nets = {
            "encoder": mlp.GaussianEncoder(
                self.feature_num, self.label_num, latent_dim=z_size),
            "generator": mlp.Generator(
                z_size, self.feature_num, num_classes=self.label_num),
            "classifier": mlp.Classifier(self.feature_num, self.label_num),
        }
        return {k: init_net(v, init_generator, self.device) for k, v in nets.items()}

    _jax_dims = staticmethod(convert.cvaegan_dims)

    def _g_step(self, x_real, y, eps, lam_class) -> Dict[str, torch.Tensor]:
        """Joint encoder + generator update on MSE + KL + progressive CE of
        the reconstruction (`src/cvae.py:115-154`); C runs in train mode
        (dropout), only E and G are stepped."""
        hp = self.hparams
        enc, gen = self.state["encoder"].train(), self.state["generator"].train()
        clf = self.state["classifier"].train()

        def loss_fn():
            mu, log_var = enc(x_real, y)
            x_recon, _ = gen(mu + eps.to(log_var.dtype) * torch.exp(0.5 * log_var), y)
            logits = clf(x_recon, self.generator)
            parts = {"recon_loss": losses.mse(x_recon, x_real),
                     "kl_loss": losses.kl_standard_normal(mu, log_var),
                     "class_loss": losses.cross_entropy(logits, y)}
            total = (hp["lambda_recon"] * parts["recon_loss"]
                     + hp["lambda_kl"] * parts["kl_loss"]
                     + lam_class * parts["class_loss"])
            return total, parts

        _, parts = grad_update_pair(self.optimizers["encoder"],
                                    self.optimizers["generator"], loss_fn)
        return {k: v.detach() for k, v in parts.items()}

    def _round(self, class_id, epoch, counts):
        lam = self._lambda_class(epoch)
        for _ in range(counts["c"]):
            self._c_step(*self._sample_batch(class_id), self._z_batch())
        for _ in range(counts["g"]):
            out = self._g_step(*self._sample_batch(class_id), self._eps_batch(), lam)
        return out

    def reconstruct_samples(self, samples, labels) -> np.ndarray:
        """Conditional encode -> decode (`src/cvae.py:302-320`)."""
        return self._reconstruct(samples, labels)
