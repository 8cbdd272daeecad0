"""Loss primitives, the counterparts of `cvaegan_tpu/core/losses.py`.

Only the attention-entropy regulariser is here so far: it is what the
RAIN-GAN networks' attention statistics feed. The other losses come with
the training slice. Inputs are promoted to float32, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AttentionRowEntropy(NamedTuple):
    """Per-row attention entropy `[..., seq]` produced by the blockwise
    attention kernel, which never materialises the probability matrix
    (`cvaegan_tpu_torch.kernels.block_attention`). `attention_entropy`
    accepts it in place of a dense probability tensor."""

    value: torch.Tensor


def attention_entropy(attn_probs, eps: float = 1e-9) -> torch.Tensor:
    """Mean attention entropy `mean(-sum a log(a + eps))` over the last
    axis (reference `src/rain_gan.py:269-289`), or the mean of an
    `AttentionRowEntropy`'s precomputed row entropies."""
    if isinstance(attn_probs, AttentionRowEntropy):
        return attn_probs.value.to(torch.float32).mean()
    p = attn_probs.to(torch.float32)
    return (-(p * torch.log(p + eps)).sum(-1)).mean()
