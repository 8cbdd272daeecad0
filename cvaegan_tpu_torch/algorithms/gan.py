"""GAN, an unconditional generator and critic with an auxiliary
classifier: the counterpart of `cvaegan_tpu/algorithms/gan.py`.

Capability parity with reference `src/gan.py` + `src/models/gan_models.py`:
per epoch, D x5 (Wasserstein sign loss), the auxiliary classifier x5 on
REAL data only, G x3 on `lambda_adv*(-E[D(G(z))])` (`src/gan.py:75-134`),
on uniform batches over the whole train set. The D step keeps the
generator's BatchNorm statistics (`gan.py:66-71` of the JAX package), the
G step the critic's spectral u/v (`:116-126`). `generate_samples(num)`
takes no label; `generate_qualified_samples(label, num)` filters the
generator's output through the auxiliary classifier
(`src/gan.py:235-266`).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from cvaegan_tpu_torch import convert
from cvaegan_tpu_torch.algorithms.base import UnconditionalTrainer
from cvaegan_tpu_torch.core import losses
from cvaegan_tpu_torch.core.state import grad_update, init_net
from cvaegan_tpu_torch.models import mlp


class GAN(UnconditionalTrainer):
    name = "gan"
    config_key = "gan"
    loss_keys = ("adv_loss",)
    loops = ("d", "c", "g")

    def _build(self, init_generator: torch.Generator) -> Dict[str, nn.Module]:
        nets = {
            "generator": mlp.Generator(self.gan_cfg.z_size, self.feature_num),
            "discriminator": mlp.Discriminator(self.feature_num, spectral=True),
            "classifier": mlp.Classifier(self.feature_num, self.label_num),
        }
        return {k: init_net(v, init_generator, self.device) for k, v in nets.items()}

    @staticmethod
    def _jax_dims(tree):
        return convert.unconditional_dims(tree, "generator")

    def _g_step(self, z) -> Dict[str, torch.Tensor]:
        """Generator update on the adversarial loss (`src/gan.py:116-134`);
        D runs in train mode (dropout, spectral u/v updating)."""
        gen = self.state["generator"].train()
        dis = self.state["discriminator"].train()

        def loss_fn():
            x_fake, _ = gen(z)
            d_fake, _ = dis(x_fake, None, self.generator)
            adv = losses.wasserstein_g_loss(d_fake)
            return self.hparams["lambda_adv"] * adv, {"adv_loss": adv}

        _, parts = grad_update(self.optimizers["generator"], loss_fn)
        return {k: v.detach() for k, v in parts.items()}

    def _round(self, class_id, epoch, counts):
        for _ in range(counts["d"]):
            x_real, _ = self._random_batch()
            self._d_step(x_real, None, self._z_batch())
        for _ in range(counts["c"]):
            self._c_step(*self._random_batch())
        for _ in range(counts["g"]):
            out = self._g_step(self._z_batch())
        return out
