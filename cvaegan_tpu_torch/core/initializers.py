"""Parameter initializers matching the reference's `init_weights`
(`src/utils.py:95-102`): Linear weights ~ N(0, 0.02), biases 0;
BatchNorm scale ~ N(1, 0.02), bias 0.

Each fills a tensor in place from an explicit `torch.Generator`, which
lies on the tensor's device."""

from __future__ import annotations

import torch


@torch.no_grad()
def dense_kernel_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return t.normal_(0.0, 0.02, generator=generator)


@torch.no_grad()
def bn_scale_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return t.normal_(1.0, 0.02, generator=generator)


@torch.no_grad()
def zeros_(t: torch.Tensor) -> torch.Tensor:
    return t.zero_()
