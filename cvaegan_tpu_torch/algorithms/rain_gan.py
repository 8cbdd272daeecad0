"""RAIN-GAN, the residual-attention CVAE-GAN, the counterpart of
`cvaegan_tpu/algorithms/rain_gan.py`.

Capability parity with reference `src/rain_gan.py` +
`src/models/rain_gan_models.py`: per class per epoch D x5 (Wasserstein
sign loss), C x5 (CE on real + fake), E+G x3 (recon + KL + adversarial +
progressive CE), every loss plus `lambda_attention` times the attention
entropy (`:137-140,168-171,216-237,269-289`); the mean attention weight
of each network recorded every 50 epochs (`epoch_chunk`, `:291-316`) and
plotted (`:396-415`); prior and confidence-filtered sampling (from the
base class), reconstruction and `visualize_attention` (`:482-502`).

The reconstruction runs the generator on z_enc: the JAX package's
documented fix of the reference, whose E+G step and reconstruction redraw
a prior z (`src/rain_gan.py:194-201`). The four networks are pre-LN
residual self-attention stacks over singleton sequences, so every
attention runs the dense path, its probabilities are all 1 and the
entropy terms are exactly 0. The block-attention kernels are
forward-only; a network run at sequences long enough for them cannot be
trained (their wrapper raises under autograd). `generate_samples_fast`
raises: the generator is not an MLP stack.

Each step takes its random inputs from the caller, as the CVAE-GAN's do,
so the epoch is captured as one CUDA graph and a test can feed both
packages the same inputs. The D, C and E+G steps are the spans `step.d`,
`step.c` and `step.eg`, as the CVAE-GAN's are, and each attention forward
inside them is `net.attention` (`utils/profiling.py`).
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
    grad_update,
    grad_update_pair,
    init_net,
)
from cvaegan_tpu_torch.models.attention import (
    RAINClassifier,
    RAINDiscriminator,
    RAINEncoder,
    RAINGenerator,
)
from cvaegan_tpu_torch.models.mlp import reparameterize
from cvaegan_tpu_torch.utils import profiling


class RAIN_GAN(GenerativeTrainer):
    name = "rain_gan"
    config_key = "rain_gan"
    loss_keys = ("recon_loss", "kl_loss", "adv_loss", "class_loss", "attention_loss")
    loops = ("d", "c", "g")
    #: the reference records the attention history every 50 epochs (10
    #: points per 500-epoch fit); the hook runs at each chunk's end
    epoch_chunk = 50
    _jax_dims = staticmethod(convert.rain_gan_dims)

    def _build(self, init_generator: torch.Generator) -> Dict[str, nn.Module]:
        z_size = self.gan_cfg.z_size
        nets = {
            "encoder": RAINEncoder(self.feature_num, self.label_num, latent_dim=z_size),
            "generator": RAINGenerator(z_size, self.feature_num, self.label_num),
            "discriminator": RAINDiscriminator(self.feature_num, self.label_num),
            "classifier": RAINClassifier(self.feature_num, self.label_num),
        }
        #: mean attention weight per network, recorded by `fit` every
        #: `epoch_chunk` epochs
        self.attention_history = {name: [] for name in nets}
        return {k: init_net(v, init_generator, self.device) for k, v in nets.items()}

    # ------------------------------------------------------------- steps
    @profiling.spanned("step.d")
    def _d_step(self, x_real, y, z) -> torch.Tensor:
        """Critic update (`rain_gan.py:101-124` of the JAX package):
        -E[D(x)] + E[D(G(z))] + lambda_att H, one forward of concat(real,
        fake) with one spectral power iteration."""
        lam_att = self.hparams["lambda_attention"]
        x_fake = self._fake(z, y)
        dis = self.state["discriminator"].train()

        def loss_fn():
            scores, attn = dis(torch.cat([x_real, x_fake], dim=-2), torch.cat([y, y], dim=-1))
            d_real, d_fake = scores.chunk(2, dim=-2)
            return (losses.wasserstein_d_loss(d_real, d_fake)
                    + lam_att * losses.attention_entropy(attn)), None

        loss, _ = grad_update(self.optimizers["discriminator"], loss_fn)
        return loss.detach()

    @profiling.spanned("step.c")
    def _c_step(self, x_real, y, z) -> torch.Tensor:
        """Companion-classifier update (`:126-145`): CE(real) + CE(fake) +
        lambda_att H. The classifier has no state and no dropout."""
        lam_att = self.hparams["lambda_attention"]
        x = torch.cat([x_real, self._fake(z, y)], dim=-2)
        clf = self.state["classifier"].train()

        def loss_fn():
            logits, attn = clf(x)
            real_logits, fake_logits = logits.chunk(2, dim=-2)
            return (losses.cross_entropy(real_logits, y)
                    + losses.cross_entropy(fake_logits, y)
                    + lam_att * losses.attention_entropy(attn)), None

        loss, _ = grad_update(self.optimizers["classifier"], loss_fn)
        return loss.detach()

    @profiling.spanned("step.eg")
    def _g_step(self, x_real, y, z_prior, eps, lam_class) -> Dict[str, torch.Tensor]:
        """Joint encoder + generator update (`:147-199`): recon MSE and KL
        on z_enc = mu + eps exp(log_var / 2), adversarial and CE on
        z_prior, and lambda_att (H_enc + H_gen). The critic's train-mode
        forward updates its u/v; only E and G are stepped."""
        hp = self.hparams
        enc, gen = self.state["encoder"].train(), self.state["generator"].train()
        dis, clf = self.state["discriminator"].train(), self.state["classifier"].train()

        def loss_fn():
            (mu, log_var), e_attn = enc(x_real, y)
            z_enc = mu + eps.to(log_var.dtype) * torch.exp(0.5 * log_var)
            x_recon, _ = gen(z_enc, y)
            x_fake, g_attn = gen(z_prior, y)
            d_fake, _ = dis(x_fake, y)
            logits, _ = clf(x_fake)
            parts = {"recon_loss": losses.mse(x_recon, x_real),
                     "kl_loss": losses.kl_standard_normal(mu, log_var),
                     "adv_loss": losses.wasserstein_g_loss(d_fake),
                     "class_loss": losses.cross_entropy(logits, y),
                     "attention_loss": (losses.attention_entropy(e_attn)
                                        + losses.attention_entropy(g_attn))}
            total = (hp["lambda_recon"] * parts["recon_loss"]
                     + hp["lambda_kl"] * parts["kl_loss"]
                     + hp["lambda_adv"] * parts["adv_loss"]
                     + lam_class * parts["class_loss"]
                     + hp["lambda_attention"] * parts["attention_loss"])
            return total, parts

        _, parts = grad_update_pair(self.optimizers["encoder"],
                                    self.optimizers["generator"], loss_fn)
        return {k: v.detach() for k, v in parts.items()}

    def _round(self, class_id: Optional[int], epoch, counts):
        """D, C, then E+G steps on the class (`:201-221`); the losses are
        the last G step's."""
        lam = self._lambda_class(epoch)
        for _ in range(counts["d"]):
            self._d_step(*self._sample_batch(class_id), self._z_batch())
        for _ in range(counts["c"]):
            self._c_step(*self._sample_batch(class_id), self._z_batch())
        for _ in range(counts["g"]):
            x_real, y = self._sample_batch(class_id)
            out = self._g_step(x_real, y, self._z_batch(), self._eps_batch(), lam)
        return out

    @torch.no_grad()
    def _attention_means(self) -> Dict[str, torch.Tensor]:
        """Each network's mean attention weight on a fixed probe
        (`:223-260`): the encoder and classifier on the first min(32,
        rows) train rows, the generator on z = 0 with labels 0, the
        critic on the generator's output with labels 0; eval mode, so
        nothing is updated."""
        n = min(32, int(self._data["samples"].shape[0]))
        x, y = self._data["samples"][:n], self._data["labels"][:n].long()
        zeros = torch.zeros_like(y)
        _, e_attn = apply_eval(self.state["encoder"], x, y)
        _, c_attn = apply_eval(self.state["classifier"], x)
        x_fake, g_attn = apply_eval(
            self.state["generator"],
            torch.zeros((n, self.gan_cfg.z_size), device=self.device), zeros)
        _, d_attn = apply_eval(self.state["discriminator"], x_fake, zeros)
        return {"encoder": e_attn.mean(), "generator": g_attn.mean(),
                "discriminator": d_attn.mean(), "classifier": c_attn.mean()}

    def _on_chunk_end(self, epochs_done: int) -> None:
        """Append each network's mean attention weight to
        `attention_history`: one point per `epoch_chunk` epochs."""
        for name, value in self._attention_means().items():
            self.attention_history[name].append(float(value))

    def plot_attention_history(self):
        """Attention-weight history curves (`src/rain_gan.py:396-415`),
        saved under gan_outs. Needs matplotlib."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if not any(self.attention_history.values()):
            return None
        plt.figure(figsize=(12, 8))
        for model_name, weights in self.attention_history.items():
            if weights:
                plt.plot(weights, label=f"{model_name} attention")
        plt.xlabel(f"Epoch (recorded every {self.epoch_chunk})")
        plt.ylabel("Mean attention weight")
        plt.title("RAIN-GAN attention history")
        plt.legend()
        plt.grid(True, alpha=0.3)
        out = self.settings.paths.gan_outs / "rain_gan_attention_history.jpg"
        plt.savefig(out)
        plt.close()
        return out

    # --------------------------------------------------------- generation
    def _classifier_logits(self, state, x):
        logits, _ = apply_eval(state["classifier"], x)
        return logits

    def _inputs(self, samples, labels):
        return (torch.as_tensor(np.asarray(samples, np.float32), device=self.device),
                torch.as_tensor(np.asarray(labels, np.int64), device=self.device))

    @torch.no_grad()
    @under_policy
    def reconstruct_samples(self, samples, labels) -> np.ndarray:
        """Encode with reparameterisation (z_enc), then decode (reference
        `src/rain_gan.py:456-480`)."""
        self._require_state()
        x, y = self._inputs(samples, labels)
        (mu, log_var), _ = apply_eval(self.state["encoder"], x, y)
        z = reparameterize(mu, log_var, self.generator)
        return self._generator_forward(self.state, z, y).float().cpu().numpy()

    @under_policy
    def visualize_attention(self, samples, labels) -> Dict[str, np.ndarray]:
        """Eval-mode encoder and classifier attention maps `[n, heads, 1,
        1]` (reference `src/rain_gan.py:482-502`)."""
        self._require_state()
        x, y = self._inputs(samples, labels)
        _, enc_attn = apply_eval(self.state["encoder"], x, y)
        _, clf_attn = apply_eval(self.state["classifier"], x)
        return {"encoder_attention": enc_attn.float().cpu().numpy(),
                "classifier_attention": clf_attn.float().cpu().numpy()}
