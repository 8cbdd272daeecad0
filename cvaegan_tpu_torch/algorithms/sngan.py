"""SNGAN, the conditional GAN with hinge loss and spectral norm everywhere:
the counterpart of `cvaegan_tpu/algorithms/sngan.py`.

Capability parity with reference `src/sngan.py` + `src/models/
sngan_models.py`: per class per epoch, D x5 on the hinge loss
`E[relu(1-D(x))] + E[relu(1+D(G))]` (`src/sngan.py:100-110`), C x5 on
CE(real) + CE(fake), G x3 on `lambda_adv * (-E[D(G)])` + progressive CE
(`:141-176`), or one mixed round in `balanced_mode`. Spectral norm is on
the generator and the companion classifier too. The history records
d_loss (the last D step's), g_loss and class_loss (`:179-181`).

Every train-mode forward commits its state, as the JAX package commits
each forward's mutables: the D and C steps' generator forward its
BatchNorm statistics and u/v; the G step's generator, critic and
classifier forwards their own (`sngan.py:150-158` of the JAX package).
Each step takes its random inputs from the caller.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from cvaegan_tpu_torch import convert
from cvaegan_tpu_torch.algorithms.base import GenerativeTrainer
from cvaegan_tpu_torch.core import losses
from cvaegan_tpu_torch.core.state import grad_update, init_net
from cvaegan_tpu_torch.models import sngan as sngan_models


class SNGAN(GenerativeTrainer):
    name = "sngan"
    config_key = "sngan"
    loss_keys = ("d_loss", "g_loss", "class_loss")
    loops = ("d", "c", "g")
    _jax_dims = staticmethod(convert.sngan_dims)

    def _build(self, init_generator: torch.Generator) -> Dict[str, nn.Module]:
        nets = {
            "generator": sngan_models.SNGANGenerator(
                self.gan_cfg.z_size, self.feature_num, self.label_num,
                spectral=bool(self.hparams.get("spectral_g", True))),
            "discriminator": sngan_models.SNGANDiscriminator(
                self.feature_num, self.label_num),
            "classifier": sngan_models.SNGANClassifier(self.feature_num, self.label_num),
        }
        return {k: init_net(v, init_generator, self.device) for k, v in nets.items()}

    def _d_step(self, x_real, y, z) -> torch.Tensor:
        """Hinge critic update (`src/sngan.py:100-113`), one forward of
        concat(real, fake) with one power iteration."""
        x_fake = self._fake(z, y)
        dis = self.state["discriminator"].train()

        def loss_fn():
            scores, _ = dis(torch.cat([x_real, x_fake], dim=-2), torch.cat([y, y], dim=-1))
            d_real, d_fake = scores.chunk(2, dim=-2)
            return losses.hinge_d_loss(d_real, d_fake), None

        loss, _ = grad_update(self.optimizers["discriminator"], loss_fn)
        return loss.detach()

    def _g_step(self, y, z, lam_class) -> Dict[str, torch.Tensor]:
        """Generator update on hinge `-E[D(G)]` + progressive CE
        (`src/sngan.py:141-176`); the generator's BatchNorm statistics and
        u/v and the critic's and classifier's u/v update, only G is
        stepped."""
        hp = self.hparams
        gen = self.state["generator"].train()
        dis, clf = self.state["discriminator"].train(), self.state["classifier"].train()

        def loss_fn():
            x_fake, _ = gen(z, y)
            d_fake, _ = dis(x_fake, y)
            parts = {"g_loss": losses.wasserstein_g_loss(d_fake),
                     "class_loss": losses.cross_entropy(clf(x_fake), y)}
            return (hp["lambda_adv"] * parts["g_loss"]
                    + lam_class * parts["class_loss"]), parts

        _, parts = grad_update(self.optimizers["generator"], loss_fn)
        return {k: v.detach() for k, v in parts.items()}

    def _round(self, class_id, epoch, counts):
        """D, C, then G steps on the class (`sngan.py:161-183` of the JAX
        package); G's labels come from `_sample_labels`, not a batch."""
        lam = self._lambda_class(epoch)
        for _ in range(counts["d"]):
            d_loss = self._d_step(*self._sample_batch(class_id), self._z_batch())
        for _ in range(counts["c"]):
            self._c_step(*self._sample_batch(class_id), self._z_batch())
        for _ in range(counts["g"]):
            out = self._g_step(self._sample_labels(class_id), self._z_batch(), lam)
        return {"d_loss": d_loss, **out}
