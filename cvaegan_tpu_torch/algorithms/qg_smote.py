"""QG-SMOTE, the quantile-GAN/SMOTE hybrid, the counterpart of
`cvaegan_tpu/algorithms/qg_smote.py`.

Capability parity with reference `src/qg_smote.py` + `src/models/
qg_smote_models.py`: per class per epoch, D x5 (Wasserstein sign loss on
quantile-sampled fakes), C x5 (CE real + fake), the quantile regressor x1
(pinball loss at levels 0.25, 0.5, 0.75, `src/qg_smote.py:272-294`), E+G
x3 on `lambda_recon MSE(G(z_quantile)) + lambda_adv (-E[D(G(z_prior))]) +
progressive CE`: the reference zeroes its quantile term there
(`src/qg_smote.py:220`). Latent sampling interpolates between adjacent
encoder quantiles at a random alpha, the SMOTE analogy
(`models/quantile.py::sample_from_quantiles`).

Generation by method='quantile' (the default: encoder quantiles of the
class's real rows) or method='prior' (`src/qg_smote.py:392-426`);
`analyze_quantiles` reports per-class quantile statistics (`:462-479`).
`generate_samples_fast` is the base's prior path through the fused
generator kernel.

As in the JAX package, the history's `quantile_loss` is the regressor's
own pinball loss, not the reference's zeroed E+G term. Every train-mode
forward commits its state as JAX commits each forward's mutables: the
D and C steps' no-grad E -> G forward the encoder's and generator's
BatchNorm statistics; the E+G step's encoder and both generator forwards
theirs, chained, and the critic's u/v (`qg_smote.py:97-225` of the JAX
package). Each step takes its random inputs (batches, alpha, z) from the
caller, which draws them from the trainer's generator.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from cvaegan_tpu_torch import convert
from cvaegan_tpu_torch.algorithms.base import GenerativeTrainer, under_policy
from cvaegan_tpu_torch.core import losses
from cvaegan_tpu_torch.core.state import (
    apply_eval,
    apply_train,
    grad_update,
    grad_update_pair,
    init_net,
)
from cvaegan_tpu_torch.models import mlp
from cvaegan_tpu_torch.models.quantile import (
    QuantileEncoder,
    QuantileRegressor,
    sample_from_quantiles,
)
from cvaegan_tpu_torch.parallel.mesh import local_rows

QUANTILE_LEVELS = (0.25, 0.5, 0.75)


class QG_SMOTE(GenerativeTrainer):
    name = "qg_smote"
    config_key = "qg_smote"
    loss_keys = ("recon_loss", "quantile_loss", "adv_loss", "class_loss")
    #: D, C, the quantile regressor (q), then E+G
    loops = ("d", "c", "q", "g")
    _jax_dims = staticmethod(convert.qg_smote_dims)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        #: the pinball levels on the device: a captured epoch copies
        #: nothing from the host
        self._levels = torch.tensor(QUANTILE_LEVELS, device=self.device)

    def _build(self, init_generator: torch.Generator) -> Dict[str, nn.Module]:
        z_size, nq = self.gan_cfg.z_size, int(self.hparams.get("num_quantiles", 3))
        nets = {
            "encoder": QuantileEncoder(self.feature_num, self.label_num,
                                       latent_dim=z_size, num_quantiles=nq),
            "generator": mlp.Generator(z_size, self.feature_num, num_classes=self.label_num),
            "discriminator": mlp.Discriminator(self.feature_num, self.label_num,
                                               spectral=True),
            "regressor": QuantileRegressor(self.feature_num, self.label_num,
                                           num_quantiles=nq),
            "classifier": mlp.Classifier(self.feature_num, self.label_num),
        }
        return {k: init_net(v, init_generator, self.device) for k, v in nets.items()}

    def _loop_counts(self) -> Dict[str, int]:
        """`settings.gan` has no loop count for the regressor: one step per
        round (`qg_smote.py:244` of the JAX package)."""
        cfg = self.gan_cfg
        return {"d": cfg.d_loop_num, "c": cfg.c_loop_num, "q": 1, "g": cfg.g_loop_num}

    def _alpha(self, rows: int) -> torch.Tensor:
        """Interpolation points `[rows, 1]`, uniform in [0, 1)."""
        return self._uniform((rows, 1))

    # ------------------------------------------------------------- steps
    def _quantile_z(self, x_real, y, alpha) -> torch.Tensor:
        """Quantile-sampled z from the encoder in train mode under no-grad,
        which commits its BatchNorm statistics (reference D/C steps,
        `src/qg_smote.py:125-135`). The base D and C steps then run the
        generator on it, which commits the generator's."""
        return sample_from_quantiles(apply_train(self.state["encoder"], x_real, y), alpha)

    def _qr_step(self, x_real, y) -> torch.Tensor:
        """Quantile-regressor update on the pinball loss of its `[batch,
        features, nq]` prediction, transposed to `[batch, nq, features]`
        (`src/qg_smote.py:176-190`)."""
        reg = self.state["regressor"].train()

        def loss_fn():
            pred = reg(x_real, y, self.generator)
            return losses.pinball(pred.transpose(-1, -2), x_real, self._levels), None

        loss, _ = grad_update(self.optimizers["regressor"], loss_fn)
        return loss.detach()

    def _g_step(self, x_real, y, alpha, z_prior, lam_class) -> Dict[str, torch.Tensor]:
        """Joint encoder + generator update (`src/qg_smote.py:192-249`):
        recon MSE on the quantile z, adversarial and CE on z_prior; the
        generator runs on each, its BatchNorm statistics chained; the
        critic's and classifier's train forwards drop out and the critic's
        u/v update, but only E and G are stepped."""
        hp = self.hparams
        enc, gen = self.state["encoder"].train(), self.state["generator"].train()
        dis, clf = self.state["discriminator"].train(), self.state["classifier"].train()

        def loss_fn():
            x_recon, _ = gen(sample_from_quantiles(enc(x_real, y), alpha), y)
            x_fake, _ = gen(z_prior, y)
            d_fake, _ = dis(x_fake, y, self.generator)
            logits = clf(x_fake, self.generator)
            parts = {"recon_loss": losses.mse(x_recon, x_real),
                     "adv_loss": losses.wasserstein_g_loss(d_fake),
                     "class_loss": losses.cross_entropy(logits, y)}
            # lambda_quantile * 0, faithful to `src/qg_smote.py:220`.
            total = (hp["lambda_recon"] * parts["recon_loss"]
                     + hp["lambda_adv"] * parts["adv_loss"]
                     + lam_class * parts["class_loss"])
            return total, parts

        _, parts = grad_update_pair(self.optimizers["encoder"],
                                    self.optimizers["generator"], loss_fn)
        return {k: v.detach() for k, v in parts.items()}

    def _round(self, class_id: Optional[int], epoch, counts):
        """D, C, one regressor step, then E+G steps on the class
        (`qg_smote.py:227-251` of the JAX package); the losses are the
        regressor's and the last E+G step's."""
        bs = self.gan_cfg.batch_size
        lam = self._lambda_class(epoch)
        for _ in range(counts["d"]):
            x_real, y = self._sample_batch(class_id)
            self._d_step(x_real, y, self._quantile_z(x_real, y, local_rows(self._alpha(bs))))
        for _ in range(counts["c"]):
            x_real, y = self._sample_batch(class_id)
            self._c_step(x_real, y, self._quantile_z(x_real, y, local_rows(self._alpha(bs))))
        for _ in range(counts["q"]):
            q_loss = self._qr_step(*self._sample_batch(class_id))
        for _ in range(counts["g"]):
            x_real, y = self._sample_batch(class_id)
            out = self._g_step(x_real, y, local_rows(self._alpha(bs)), self._z_batch(), lam)
        return {"quantile_loss": q_loss, **out}

    # --------------------------------------------------------- generation
    def _class_rows(self, target_label: int, num: int) -> torch.Tensor:
        """`num` train rows of the class, cycling through its rows in
        table order (a class without rows gives its table's padding)."""
        index = self._data["index"]
        count = max(int(index.host_counts[target_label]), 1)
        idx = torch.arange(num, device=self.device) % count
        return self._data["samples"][index.table[target_label][idx].long()]

    @torch.no_grad()
    def _quantile_latents(self, target_label: int, num: int) -> torch.Tensor:
        """Encode `num` real rows of the class (eval mode) and sample z
        between their quantiles (`src/qg_smote.py:400-421`)."""
        labels = self._labels(target_label, num)
        quantiles = apply_eval(self.state["encoder"], self._class_rows(target_label, num),
                               labels)
        return sample_from_quantiles(quantiles, self._alpha(num))

    @torch.no_grad()
    @under_policy
    def generate_samples(self, target_label: int, num: int,
                         method: str = "quantile") -> np.ndarray:
        """method='quantile' decodes z interpolated between the encoder's
        quantiles of the class's real rows; method='prior' draws z ~ N(0,
        I) (`src/qg_smote.py:392-426`)."""
        self._require_state()
        if method == "prior":
            return super().generate_samples(target_label, num)
        z = self._quantile_latents(target_label, num)
        out = self._generator_forward(self.state, z, self._labels(target_label, num))
        return out.to(torch.float32).cpu().numpy()

    @torch.no_grad()
    @under_policy
    def generate_qualified_samples(self, target_label: int, num: int,
                                   confidence_threshold: Optional[float] = None,
                                   method: str = "quantile") -> np.ndarray:
        """The confidence filter over either generation method
        (`src/qg_smote.py:428-460`). method='prior' is the base's;
        method='quantile' draws candidate batches of max(256, min(4096,
        2 num)) rows and gives up after 20 batches without a survivor,
        never refunded."""
        if method == "prior":
            return super().generate_qualified_samples(target_label, num,
                                                      confidence_threshold)
        self._require_state()
        if confidence_threshold is None:
            confidence_threshold = self.hparams.get("confidence_threshold", 0.5)
        return self._filtered(target_label, num, confidence_threshold,
                              max(256, min(4096, 2 * num)),
                              lambda cand: self._quantile_latents(target_label, cand))

    @torch.no_grad()
    @under_policy
    def analyze_quantiles(self, target_label: int,
                          num_samples: int = 100) -> Dict[str, np.ndarray]:
        """Statistics over the first min(num_samples, count) rows of the
        class of their latent quantiles `[latent_dim, nq]` (eval mode):
        mean, std, min and max (`src/qg_smote.py:462-479`)."""
        self._require_state()
        index = self._data["index"]
        n = min(num_samples, max(int(index.host_counts[target_label]), 1))
        x = self._data["samples"][index.table[target_label][:n].long()]
        q = apply_eval(self.state["encoder"], x, self._labels(target_label, n)).float()
        return {"mean": q.mean(0).cpu().numpy(),
                "std": q.std(0, unbiased=False).cpu().numpy(),
                "min": q.amin(0).cpu().numpy(),
                "max": q.amax(0).cpu().numpy()}
