"""CGAN, the CVAE-GAN without the encoder: the counterpart of
`cvaegan_tpu/algorithms/cgan.py`.

Capability parity with reference `src/cgan.py` + `src/models/
cgan_models.py`: per class per epoch, D x5 (Wasserstein sign loss), C x5
(CE on real + fake), G x3 on `lambda_adv*(-E[D(G)]) +
progressive_lambda_class*CE(C(G))` (`src/cgan.py:83-178`), or one mixed
round in `balanced_mode`. The D and C steps run the generator in train
mode and keep its BatchNorm statistics (`cgan.py:68-72,97-101` of the
JAX package); the G step keeps the critic's spectral u/v.

Each step takes its random inputs from the caller; only the dropout
masks are drawn inside, from the trainer's generator.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from cvaegan_tpu_torch import convert
from cvaegan_tpu_torch.algorithms.base import GenerativeTrainer
from cvaegan_tpu_torch.core import losses
from cvaegan_tpu_torch.core.state import grad_update, init_net
from cvaegan_tpu_torch.models import mlp


class CGAN(GenerativeTrainer):
    name = "cgan"
    config_key = "cgan"
    loss_keys = ("adv_loss", "class_loss")
    loops = ("d", "c", "g")

    def _build(self, init_generator: torch.Generator) -> Dict[str, nn.Module]:
        nets = {
            "generator": mlp.Generator(
                self.gan_cfg.z_size, self.feature_num, num_classes=self.label_num),
            "discriminator": mlp.Discriminator(
                self.feature_num, self.label_num, spectral=True),
            "classifier": mlp.Classifier(self.feature_num, self.label_num),
        }
        return {k: init_net(v, init_generator, self.device) for k, v in nets.items()}

    _jax_dims = staticmethod(convert.cgan_dims)

    def _g_step(self, y, z, lam_class) -> Dict[str, torch.Tensor]:
        """Generator update on adversarial + progressive CE
        (`src/cgan.py:141-178`); D and C run in train mode (dropout, D's
        spectral u/v updating), only G is stepped."""
        hp = self.hparams
        gen = self.state["generator"].train()
        dis, clf = self.state["discriminator"].train(), self.state["classifier"].train()

        def loss_fn():
            x_fake, _ = gen(z, y)
            d_fake, _ = dis(x_fake, y, self.generator)
            logits = clf(x_fake, self.generator)
            parts = {"adv_loss": losses.wasserstein_g_loss(d_fake),
                     "class_loss": losses.cross_entropy(logits, y)}
            return (hp["lambda_adv"] * parts["adv_loss"]
                    + lam_class * parts["class_loss"]), parts

        _, parts = grad_update(self.optimizers["generator"], loss_fn)
        return {k: v.detach() for k, v in parts.items()}

    def _round(self, class_id, epoch, counts):
        lam = self._lambda_class(epoch)
        for _ in range(counts["d"]):
            self._d_step(*self._sample_batch(class_id), self._z_batch())
        for _ in range(counts["c"]):
            self._c_step(*self._sample_batch(class_id), self._z_batch())
        for _ in range(counts["g"]):
            out = self._g_step(self._sample_labels(class_id), self._z_batch(), lam)
        return out
