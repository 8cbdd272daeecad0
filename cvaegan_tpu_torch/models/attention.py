"""The RAIN-GAN model family, the counterparts of
`cvaegan_tpu/models/attention.py`: pre-LN residual self-attention blocks
(`src/models/rain_gan_models.py`).

The reference feeds every network a singleton sequence (inputs
`unsqueeze(1)`'d, seq_len 1, `:139,222,300,349`); the blocks are written
seq-length-generic (inputs `[..., batch, seq, dim]`: a seed bank's
networks (`models/banked.py`) run `[K, batch, seq, dim]`), and each forward returns
the last block's attention statistics for the entropy regulariser and
`visualize_attention`. With seq_len 1 the softmax is over a single key, so
the probabilities are all 1 and the entropy is exactly 0, as in the
reference.

As in `models/mlp.py`, each constructor takes its input width first, and
modules take integer labels and one-hot them. Spectral layers update their
u/v in a train-mode forward, even under `torch.no_grad()`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cvaegan_tpu_torch.core.losses import AttentionRowEntropy
from cvaegan_tpu_torch.kernels import block_attention as ba
from cvaegan_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    SpectralDense,
    leaky_relu,
    one_hot,
)
from cvaegan_tpu_torch.utils import profiling

#: the blockwise kernels' sequence tile in the JAX package; auto dispatch
#: takes the kernel only for whole multiples of it, as there
KERNEL_SEQ_MULTIPLE = 128


class MultiHeadSelfAttention(nn.Module):
    """Self-attention returning (output, attention statistics)
    (`src/models/rain_gan_models.py:55-89`).

    For sequences of at least `kernel_min_seq` (and a multiple of 128) on
    CUDA, or when `use_kernel=True` forces it, the contraction runs the
    blockwise kernel `block_attention_with_entropy`: O(seq) memory, no
    probability matrix, and the statistics are an `AttentionRowEntropy`
    of exact row entropies `[b, h, s]`. Otherwise they are the dense
    probabilities `[b, h, s, s]`. Leading axes in front of `[b, s, dim]`
    (a seed bank's replica axis) are kept: `[..., b, h, s(, s)]`; on the
    kernel path they are folded into the kernel's batch with the heads.
    The kernel path is forward-only.

    The forward, from the Q, K and V projections to the out projection,
    is the span `net.attention` (`utils/profiling.py`): in a captured
    epoch its kernel nodes count to that phase, and the backward's to the
    step that runs it.
    """

    def __init__(self, embed_dim: int, num_heads: int = 4,
                 kernel_min_seq: int = 128, use_kernel: Optional[bool] = None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.kernel_min_seq = kernel_min_seq
        #: None = auto (CUDA + seq >= kernel_min_seq); True/False forces.
        self.use_kernel = use_kernel
        self.query, self.key, self.value, self.out = (
            Dense(embed_dim, embed_dim) for _ in range(4))

    def _kernel_path(self, x: torch.Tensor) -> bool:
        if self.use_kernel is not None:
            return self.use_kernel
        s = x.shape[-2]
        return x.is_cuda and s >= self.kernel_min_seq and s % KERNEL_SEQ_MULTIPLE == 0

    @profiling.spanned("net.attention")
    def forward(self, x: torch.Tensor):
        *lead, s, _ = x.shape
        h, hd = self.num_heads, self.embed_dim // self.num_heads

        def split_heads(t):
            return t.reshape(*lead, s, h, hd).transpose(-3, -2)

        q, k, v = (split_heads(layer(x)) for layer in (self.query, self.key, self.value))
        if self._kernel_path(x):
            out, ent = ba.block_attention_with_entropy(
                q.reshape(-1, s, hd), k.reshape(-1, s, hd), v.reshape(-1, s, hd))
            out = out.reshape(*lead, h, s, hd)
            stats = AttentionRowEntropy(ent.reshape(*lead, h, s))
        else:
            scores = torch.einsum("...hqd,...hkd->...hqk", q, k) * (hd ** -0.5)
            stats = torch.softmax(scores, dim=-1)
            out = torch.einsum("...hqk,...hkd->...hqd", stats, v)
        out = out.transpose(-3, -2).reshape(*lead, s, self.embed_dim)
        return self.out(out), stats


class ResidualAttentionBlock(nn.Module):
    """Pre-LN attention + 2-layer feed-forward + shortcut
    (`src/models/rain_gan_models.py:8-52`). The shortcut is a projection
    only when the width changes; `spectral` puts spectral norm on the
    feed-forward and shortcut layers (the attention's stay plain)."""

    def __init__(self, input_dim: int, output_dim: int, num_heads: int = 4,
                 spectral: bool = False):
        super().__init__()
        dense = SpectralDense if spectral else Dense
        self.norm1 = LayerNorm(input_dim)
        self.attention = MultiHeadSelfAttention(input_dim, num_heads)
        self.norm2 = LayerNorm(input_dim)
        self.ff1 = dense(input_dim, output_dim)
        self.ff2 = dense(output_dim, output_dim)
        self.shortcut = dense(input_dim, output_dim) if input_dim != output_dim else None

    def forward(self, x: torch.Tensor):
        attn_out, stats = self.attention(self.norm1(x))
        x = x + attn_out
        ff = self.ff2(leaky_relu(self.ff1(self.norm2(x))))
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return shortcut + ff, stats


def _blocks(widths, spectral: bool = False) -> nn.ModuleList:
    return nn.ModuleList(ResidualAttentionBlock(widths[i], widths[i + 1], spectral=spectral)
                         for i in range(len(widths) - 1))


class RAINEncoder(nn.Module):
    """Projection -> 2 attention blocks -> (mu, log_var)
    (`src/models/rain_gan_models.py:93-163`). Returns
    ((mu, log_var), attention statistics)."""

    def __init__(self, input_dim: int, num_classes: int, latent_dim: int = 128):
        super().__init__()
        self.num_classes = num_classes
        self.proj = Dense(input_dim + num_classes, 256)
        self.norm = LayerNorm(256)
        self.blocks = _blocks((256, 256, 128))
        self.mu = Dense(128, latent_dim)
        self.log_var = Dense(128, latent_dim)

    def forward(self, x: torch.Tensor, labels: torch.Tensor):
        h = torch.cat([x, one_hot(labels, self.num_classes)], dim=-1)[..., None, :]
        h = leaky_relu(self.norm(self.proj(h)))
        for block in self.blocks:
            h, stats = block(h)
            h = leaky_relu(h)
        h = h[..., 0, :]
        return (self.mu(h), self.log_var(h)), stats


class RAINGenerator(nn.Module):
    """Projection -> 3 attention blocks -> Sigmoid output. Takes an
    explicit z, so the reconstruction path uses z_enc: the JAX package's
    documented fix of the reference, whose generator redraws a prior z
    (`src/models/rain_gan_models.py:215-224`). Returns (samples, attention
    statistics)."""

    def __init__(self, latent_dim: int, output_dim: int, num_classes: int):
        super().__init__()
        self.num_classes = num_classes
        self.proj = Dense(latent_dim + num_classes, 256)
        self.norm = LayerNorm(256)
        self.blocks = _blocks((256, 256, 128, 64))
        self.head = Dense(64, output_dim)

    def forward(self, z: torch.Tensor, labels: torch.Tensor):
        h = torch.cat([z, one_hot(labels, self.num_classes)], dim=-1)[..., None, :]
        h = leaky_relu(self.norm(self.proj(h)))
        for block in self.blocks:
            h, stats = block(h)
            h = leaky_relu(h)
        return torch.sigmoid(self.head(h[..., 0, :])), stats


class RAINDiscriminator(nn.Module):
    """Spectral-norm attention critic (`src/models/rain_gan_models.py:
    240-313`). Without labels a zero condition vector is concatenated.
    Returns (score, attention statistics)."""

    def __init__(self, input_dim: int, num_classes: int):
        super().__init__()
        self.num_classes = num_classes
        self.proj = SpectralDense(input_dim + num_classes, 256)
        self.blocks = _blocks((256, 256, 128), spectral=True)
        self.head = SpectralDense(128, 1)

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None):
        cond = (one_hot(labels, self.num_classes) if labels is not None else
                torch.zeros(*x.shape[:-1], self.num_classes, dtype=x.dtype, device=x.device))
        h = leaky_relu(self.proj(torch.cat([x, cond], dim=-1)[..., None, :]))
        for block in self.blocks:
            h, stats = block(h)
            h = leaky_relu(h)
        return self.head(h[..., 0, :]), stats


class RAINClassifier(nn.Module):
    """Attention classifier with ReLU activations
    (`src/models/rain_gan_models.py:316-372`). Returns (logits, attention
    statistics)."""

    def __init__(self, input_dim: int, num_classes: int):
        super().__init__()
        self.proj = Dense(input_dim, 256)
        self.norm = LayerNorm(256)
        self.blocks = _blocks((256, 256, 128))
        self.head = Dense(128, num_classes)

    def forward(self, x: torch.Tensor):
        h = F.relu(self.norm(self.proj(x[..., None, :])))
        for block in self.blocks:
            h, stats = block(h)
            h = F.relu(h)
        return self.head(h[..., 0, :]), stats
