"""CVAE-GAN, the flagship 4-network conditional VAE-GAN: the serving half
of `cvaegan_tpu/algorithms/cvae_gan.py`.

Capability parity with reference `src/cvae_gan.py` +
`src/models/cvae_gan_models.py`: prior sampling, confidence-filtered
sampling and reconstruction (`:339-397`). All four networks are built,
so a state converted from the JAX package loads whole. The D, C and G
steps and the epoch body belong to the training slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from cvaegan_tpu_torch import convert
from cvaegan_tpu_torch.algorithms.base import GenerativeTrainer
from cvaegan_tpu_torch.core.state import apply_eval, init_net
from cvaegan_tpu_torch.models import mlp


class CVAEGAN(GenerativeTrainer):
    name = "cvae_gan"
    config_key = "cvae_gan"

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
