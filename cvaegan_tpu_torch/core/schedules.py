"""Loss-weight schedules, the counterpart of `cvaegan_tpu/core/schedules.py`.

The GAN family enables the generator's classification loss progressively:
0 before `warmup` epochs, a linear ramp to `lam` between `warmup` and
`full`, then constant (reference `src/cvae_gan.py:198-204`). The epoch may
be a Python number or a device scalar tensor: a captured training epoch
reads λ from a tensor that is updated before each replay.
"""

from __future__ import annotations

import torch


def progressive_lambda(epoch, lam: float, warmup: int = 200, full: int = 500):
    """λ_class(e): 0 for e < warmup, linear ramp on [warmup, full), lam after.
    Returns a float32 scalar tensor on the epoch's device."""
    e = torch.as_tensor(epoch, dtype=torch.float32)
    progress = torch.clamp((e - warmup) / float(max(full - warmup, 1)), 0.0, 1.0)
    return lam * progress
