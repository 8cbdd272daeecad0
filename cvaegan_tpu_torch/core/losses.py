"""Loss primitives, the counterparts of `cvaegan_tpu/core/losses.py`.

Each is shape-polymorphic over the batch axis and promotes its inputs to
float32, as the JAX package does. None of them reads a tensor's value on
the host, so every one can run inside a captured CUDA graph.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F


class AttentionRowEntropy(NamedTuple):
    """Per-row attention entropy `[..., seq]` produced by the blockwise
    attention kernel, which never materialises the probability matrix
    (`cvaegan_tpu_torch.kernels.block_attention`). `attention_entropy`
    accepts it in place of a dense probability tensor."""

    value: torch.Tensor


def _f32(*xs):
    out = tuple(torch.as_tensor(x).to(torch.float32) for x in xs)
    return out[0] if len(out) == 1 else out


def mse(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Mean-squared-error reconstruction loss (reference
    `src/cvae_gan.py:190`, `F.mse_loss` with mean reduction)."""
    x_hat, x = _f32(x_hat, x)
    return torch.mean(torch.square(x_hat - x))


def kl_standard_normal(mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """KL(q(z|x) || N(0, I)) summed over latent dims, averaged over the
    batch (reference `src/cvae_gan.py:191`)."""
    mu, log_var = _f32(mu, log_var)
    kl = -0.5 * torch.sum(1.0 + log_var - torch.square(mu) - torch.exp(log_var))
    return kl / mu.shape[0]


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    log_probs = F.log_softmax(_f32(logits), dim=-1)
    return -torch.take_along_dim(log_probs, labels.long()[:, None], dim=-1)[:, 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels."""
    return torch.mean(_nll(logits, labels))


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """Cross entropy with per-example weights, normalised by
    max(sum of weights, 1); padding rows carry weight 0."""
    weights = _f32(weights)
    return torch.sum(_nll(logits, labels) * weights) / torch.clamp_min(
        torch.sum(weights), 1.0)


def wasserstein_d_loss(d_real: torch.Tensor, d_fake: torch.Tensor) -> torch.Tensor:
    """Critic loss `-E[D(x)] + E[D(G(z))]` (reference `src/cvae_gan.py:117-127`)."""
    d_real, d_fake = _f32(d_real, d_fake)
    return -torch.mean(d_real) + torch.mean(d_fake)


def wasserstein_g_loss(d_fake: torch.Tensor) -> torch.Tensor:
    """Generator adversarial term `-E[D(G(z))]` (reference `src/cvae_gan.py:195-196`)."""
    return -torch.mean(_f32(d_fake))


def hinge_d_loss(d_real: torch.Tensor, d_fake: torch.Tensor) -> torch.Tensor:
    """Hinge critic loss `E[relu(1-D(x))] + E[relu(1+D(G))]` (reference
    `src/sngan.py:100-110`)."""
    d_real, d_fake = _f32(d_real, d_fake)
    return torch.mean(torch.relu(1.0 - d_real)) + torch.mean(torch.relu(1.0 + d_fake))


def pinball(pred: torch.Tensor, target: torch.Tensor,
            quantiles: torch.Tensor) -> torch.Tensor:
    """Pinball loss of `pred [batch, n_quantiles, dims]` against `target
    [batch, dims]` at levels `quantiles [n_quantiles]` (reference
    `src/qg_smote.py:272-294`)."""
    pred, target = _f32(pred, target)
    diff = target[:, None, :] - pred
    q = torch.as_tensor(quantiles, dtype=torch.float32, device=pred.device)[None, :, None]
    return torch.mean(torch.maximum(q * diff, (q - 1.0) * diff))


def attention_entropy(attn_probs, eps: float = 1e-9) -> torch.Tensor:
    """Mean attention entropy `mean(-sum a log(a + eps))` over the last
    axis (reference `src/rain_gan.py:269-289`), or the mean of an
    `AttentionRowEntropy`'s precomputed row entropies."""
    if isinstance(attn_probs, AttentionRowEntropy):
        return attn_probs.value.to(torch.float32).mean()
    p = attn_probs.to(torch.float32)
    return (-(p * torch.log(p + eps)).sum(-1)).mean()


def gradient_penalty(d_apply: Callable[[torch.Tensor], torch.Tensor],
                     x_real: torch.Tensor, x_fake: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """WGAN-GP penalty `E[(|grad_x D(x_hat)| - 1)^2]` at random interpolates
    (reference `src/models/ctgan_models.py:212-237`). `d_apply` maps
    `[batch, dim]` to per-example scores that depend on their own row
    only, so the gradient of their sum gives each row's own gradient.
    `alpha [batch, 1]` is drawn from `generator` unless given."""
    if alpha is None:
        alpha = torch.rand((x_real.shape[0], 1), generator=generator,
                           device=x_real.device)
    x_hat = (alpha * x_real + (1.0 - alpha) * x_fake).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(d_apply(x_hat).sum(), x_hat, create_graph=True)
    norms = torch.sqrt(torch.sum(torch.square(grads), dim=-1) + 1e-12)
    return torch.mean(torch.square(norms - 1.0))


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Row-wise cosine similarity, mean over the batch (reference TMG-GAN
    hidden-feature term, `src/tmg_gan.py:89-119`)."""
    a, b = _f32(a, b)
    na = torch.sqrt(torch.sum(a * a, dim=-1) + eps)
    nb = torch.sqrt(torch.sum(b * b, dim=-1) + eps)
    return torch.mean(torch.sum(a * b, dim=-1) / (na * nb))


# Generation-quality diagnostics (reference `src/ctgan.py:338-376`).

def mean_difference(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """L2 distance between feature means."""
    return torch.linalg.vector_norm(real.mean(0) - fake.mean(0))


def cov_difference(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """Frobenius distance between feature covariance matrices."""
    return torch.linalg.matrix_norm(torch.cov(real.T) - torch.cov(fake.T))


def mmd_rbf(real: torch.Tensor, fake: torch.Tensor, sigma: float = 1.0,
            max_samples: int = 100) -> torch.Tensor:
    """RBF-kernel MMD^2 estimate on at most `max_samples` rows per side."""
    r, f = real[:max_samples], fake[:max_samples]

    def k(a, b):
        d2 = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * a @ b.T
        return torch.exp(-d2 / (2.0 * sigma ** 2))

    return k(r, r).mean() + k(f, f).mean() - 2.0 * k(r, f).mean()
