"""RAIN-GAN, the residual-attention CVAE-GAN: the serving half of
`cvaegan_tpu/algorithms/rain_gan.py`.

Capability parity with reference `src/rain_gan.py` +
`src/models/rain_gan_models.py`: prior sampling, confidence-filtered
sampling (both from the base class), reconstruction through z_enc (the JAX
package's documented fix of the reference, whose reconstruction redraws a
prior z) and `visualize_attention` (`:482-502`). The four networks are
pre-LN residual self-attention stacks over singleton sequences, so every
attention runs the dense path and its probabilities are all 1.
`generate_samples_fast` raises: the generator is not an MLP stack. The D,
C and G steps, `fit` and the attention history's recording and plot
belong to the training slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from cvaegan_tpu_torch import convert
from cvaegan_tpu_torch.algorithms.base import GenerativeTrainer
from cvaegan_tpu_torch.core.state import apply_eval, init_net
from cvaegan_tpu_torch.models.attention import (
    RAINClassifier,
    RAINDiscriminator,
    RAINEncoder,
    RAINGenerator,
)
from cvaegan_tpu_torch.models.mlp import reparameterize


class RAIN_GAN(GenerativeTrainer):
    name = "rain_gan"
    config_key = "rain_gan"
    _jax_dims = staticmethod(convert.rain_gan_dims)

    def _build(self, init_generator: torch.Generator) -> Dict[str, nn.Module]:
        z_size = self.gan_cfg.z_size
        nets = {
            "encoder": RAINEncoder(self.feature_num, self.label_num, latent_dim=z_size),
            "generator": RAINGenerator(z_size, self.feature_num, self.label_num),
            "discriminator": RAINDiscriminator(self.feature_num, self.label_num),
            "classifier": RAINClassifier(self.feature_num, self.label_num),
        }
        #: mean attention weight per network, recorded by `fit` every 50
        #: epochs (training slice)
        self.attention_history = {name: [] for name in nets}
        return {k: init_net(v, init_generator, self.device) for k, v in nets.items()}

    # --------------------------------------------------------- generation
    def _classifier_logits(self, state, x):
        logits, _ = apply_eval(state["classifier"], x)
        return logits

    def _inputs(self, samples, labels):
        return (torch.as_tensor(np.asarray(samples, np.float32), device=self.device),
                torch.as_tensor(np.asarray(labels, np.int64), device=self.device))

    @torch.no_grad()
    def reconstruct_samples(self, samples, labels) -> np.ndarray:
        """Encode with reparameterisation (z_enc), then decode (reference
        `src/rain_gan.py:456-480`)."""
        self._require_state()
        x, y = self._inputs(samples, labels)
        (mu, log_var), _ = apply_eval(self.state["encoder"], x, y)
        z = reparameterize(mu, log_var, self.generator)
        return self._generator_forward(self.state, z, y).cpu().numpy()

    def visualize_attention(self, samples, labels) -> Dict[str, np.ndarray]:
        """Eval-mode encoder and classifier attention maps `[n, heads, 1,
        1]` (reference `src/rain_gan.py:482-502`)."""
        self._require_state()
        x, y = self._inputs(samples, labels)
        _, enc_attn = apply_eval(self.state["encoder"], x, y)
        _, clf_attn = apply_eval(self.state["classifier"], x)
        return {"encoder_attention": enc_attn.cpu().numpy(),
                "classifier_attention": clf_attn.cpu().numpy()}
