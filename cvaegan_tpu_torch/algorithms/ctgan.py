"""CTGAN, the tabular WGAN-GP with residual blocks and column masks: the
counterpart of `cvaegan_tpu/algorithms/ctgan.py`.

Capability parity with reference `src/ctgan.py` + `src/models/
ctgan_models.py`: per class per epoch, D x5 whatever the config (the
WGAN-GP standard, `src/ctgan.py:93`) on `-E[D(x)] + E[D(G)] + GP`, C x
`c_loop_num` on CE(real) + CE(fake), G x1 on `lambda_adv * (-E[D(G)])` +
progressive CE (`:144-174`). The history records d, g, gp and class
losses (`:175-179`); `calculate_metrics` gives the mean, covariance and
RBF-MMD diagnostics (`:338-376`). Eval generation uses the round-robin
column mask.

The gradient penalty is the JAX package's (`ctgan.py:96-126` there):
the gradient, with respect to the interpolates x_hat, of the SUM of the
critic's train-mode scores over the batch, whose BatchNorm couples the
rows, so it is not the per-example `core.losses.gradient_penalty`. Its
forward draws its own column mask and dropout, and leaves no state
behind: JAX commits only the first forward's mutables, and both of its
forwards start from the same u/v, so the second sees the first one's
sigma. Here the first forward has already updated u/v in place, so the
penalty's forward runs under `state_frozen`: no second power iteration,
no running-statistics update. The double backward holds no host sync,
so it is captured with the rest of the epoch.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from cvaegan_tpu_torch import convert
from cvaegan_tpu_torch.algorithms.base import GenerativeTrainer
from cvaegan_tpu_torch.core import losses
from cvaegan_tpu_torch.core.state import apply_eval, apply_train, grad_update, init_net
from cvaegan_tpu_torch.models import ctgan as ctgan_models
from cvaegan_tpu_torch.models.layers import state_frozen
from cvaegan_tpu_torch.parallel.mesh import local_rows


class CTGAN(GenerativeTrainer):
    name = "ctgan"
    config_key = "ctgan"
    loss_keys = ("d_loss", "g_loss", "gp_loss", "class_loss")
    loops = ("d", "c", "g")
    #: the reference hard-codes 5 critic steps (`src/ctgan.py:93`)
    d_loop_fixed = 5
    _jax_dims = staticmethod(convert.ctgan_dims)

    def _build(self, init_generator: torch.Generator) -> Dict[str, nn.Module]:
        nets = {
            "generator": ctgan_models.CTGANGenerator(
                self.gan_cfg.z_size, self.feature_num, self.label_num),
            "discriminator": ctgan_models.CTGANDiscriminator(
                self.feature_num, self.label_num),
            "classifier": ctgan_models.CTGANClassifier(self.feature_num, self.label_num),
        }
        return {k: init_net(v, init_generator, self.device) for k, v in nets.items()}

    def _loop_counts(self) -> Dict[str, int]:
        return {"d": self.d_loop_fixed, "c": self.gan_cfg.c_loop_num, "g": 1}

    def _mask(self, rows: int) -> torch.Tensor:
        """A training column mask of `rows` (one or two batches) drawn from
        the trainer's generator: this data rank's rows of each batch under
        a mesh (`local_rows`)."""
        mask = ctgan_models.random_column_mask(self.generator, rows, self.feature_num,
                                               self.device)
        return local_rows(mask, rows // self.gan_cfg.batch_size)

    # ------------------------------------------------------------- steps
    def _fake(self, z, y, mask) -> torch.Tensor:
        """Train-mode generation under no-grad with a column mask; the
        generator's BatchNorm statistics update (`:71-84`)."""
        return apply_train(self.state["generator"], z, y, mask)

    def _d_step(self, x_real, y, z, g_mask, d_mask, gp_mask, alpha) -> Dict[str, torch.Tensor]:
        """WGAN-GP critic update (`src/ctgan.py:93-117`): the critic on
        concat(real, fake) under `d_mask`, which commits its BatchNorm
        statistics and u/v, and the penalty at x_hat = alpha x_real + (1 -
        alpha) x_fake under `gp_mask`, which commits nothing."""
        lam_gp = self.hparams["lambda_gp"]
        x_fake = self._fake(z, y, g_mask)
        x_hat = (alpha * x_real + (1.0 - alpha) * x_fake).requires_grad_(True)
        dis = self.state["discriminator"].train()

        def loss_fn():
            scores = dis(torch.cat([x_real, x_fake], dim=-2), torch.cat([y, y], dim=-1),
                         d_mask, self.generator)
            d_real, d_fake = scores.chunk(2, dim=-2)
            with state_frozen(dis):
                score_sum = dis(x_hat, y, gp_mask, self.generator).sum()
            (grads,) = torch.autograd.grad(score_sum, x_hat, create_graph=True)
            norms = torch.sqrt(torch.sum(torch.square(grads), dim=-1) + 1e-12)
            gp = torch.mean(torch.square(norms - 1.0), dim=-1) * lam_gp
            return losses.wasserstein_d_loss(d_real, d_fake) + gp, gp

        loss, gp = grad_update(self.optimizers["discriminator"], loss_fn)
        return {"d_loss": loss.detach(), "gp_loss": gp.detach()}

    def _c_step(self, x_real, y, z, g_mask) -> torch.Tensor:
        """Companion-classifier update on CE(real) + CE(fake), its
        BatchNorm statistics committed (`:132-151`)."""
        x = torch.cat([x_real, self._fake(z, y, g_mask)], dim=-2)
        clf = self.state["classifier"].train()

        def loss_fn():
            real_logits, fake_logits = clf(x, self.generator).chunk(2, dim=-2)
            return (losses.cross_entropy(real_logits, y)
                    + losses.cross_entropy(fake_logits, y)), None

        loss, _ = grad_update(self.optimizers["classifier"], loss_fn)
        return loss.detach()

    def _g_step(self, y, z, g_mask, d_mask, lam_class) -> Dict[str, torch.Tensor]:
        """Generator update (`src/ctgan.py:144-174`): the generator's,
        critic's and classifier's train-mode forwards all commit their
        state (`:186-196`); only G is stepped."""
        hp = self.hparams
        gen = self.state["generator"].train()
        dis, clf = self.state["discriminator"].train(), self.state["classifier"].train()

        def loss_fn():
            x_fake = gen(z, y, g_mask)
            d_fake = dis(x_fake, y, d_mask, self.generator)
            parts = {"g_loss": losses.wasserstein_g_loss(d_fake),
                     "class_loss": losses.cross_entropy(clf(x_fake, self.generator), y)}
            return (hp["lambda_adv"] * parts["g_loss"]
                    + lam_class * parts["class_loss"]), parts

        _, parts = grad_update(self.optimizers["generator"], loss_fn)
        return {k: v.detach() for k, v in parts.items()}

    def _round(self, class_id, epoch, counts):
        """D, C, then G steps on the class (`ctgan.py:198-222` of the JAX
        package)."""
        bs = self.gan_cfg.batch_size
        lam = self._lambda_class(epoch)
        for _ in range(counts["d"]):
            x_real, y = self._sample_batch(class_id)
            alpha = local_rows(self._uniform((bs, 1)))
            d_out = self._d_step(x_real, y, self._z_batch(), self._mask(bs),
                                 self._mask(2 * bs), self._mask(bs), alpha)
        for _ in range(counts["c"]):
            self._c_step(*self._sample_batch(class_id), self._z_batch(), self._mask(bs))
        for _ in range(counts["g"]):
            out = self._g_step(self._sample_labels(class_id), self._z_batch(),
                               self._mask(bs), self._mask(bs), lam)
        return {**d_out, **out}

    # --------------------------------------------------------- generation
    def _generator_forward(self, state, z, labels):
        """Eval-mode generation under the round-robin column mask
        (`src/models/ctgan_models.py:94-95`)."""
        mask = ctgan_models.round_robin_column_mask(z.shape[0], self.feature_num, z.device)
        return apply_eval(state["generator"], z, labels, mask)

    def calculate_metrics(self, real_samples, fake_samples) -> Dict[str, float]:
        """Generation-quality diagnostics (`src/ctgan.py:338-376`): the L2
        distance of the feature means, the Frobenius distance of the
        covariances and the RBF-MMD^2 on at most 100 rows per side."""
        real = torch.as_tensor(np.asarray(real_samples, np.float32), device=self.device)
        fake = torch.as_tensor(np.asarray(fake_samples, np.float32), device=self.device)
        return {"mean_difference": float(losses.mean_difference(real, fake)),
                "cov_difference": float(losses.cov_difference(real, fake)),
                "mmd_approx": float(losses.mmd_rbf(real, fake))}
