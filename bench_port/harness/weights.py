"""Initial weights made from the seed, on the device, in one draw per
replica: the same leaves are handed to the program and to the reference.

Each leaf is drawn as the published `init_weights` draws it
(`src/utils.py:95-102`): dense kernels N(0, 0.02), BatchNorm scales
N(1, 0.02), biases 0, LayerNorm scales 1, spectral u and v unit vectors.
Running BatchNorm statistics start at 0 and 1, or, where the traffic
serves a generator that is never trained (`drawn_stats`), are drawn:
means N(0, 0.1), variances exp(N(0, 0.3)), so that the eval-mode fold of
the statistics into the layers does real work.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

#: what every kind takes from the replica's one standard-normal draw
_DRAWN = ("dense", "bn_scale", "unit")


def _seed(seed: int) -> int:
    """The weights' generator seed for replica seed `seed` (apart from the
    trainer's own generator, which the program seeds with `seed`)."""
    return (int(seed) * 1_000_003 + 0x5EED) % (2**63 - 1)


def make(layout: Dict[str, List[Tuple[str, tuple, str]]], seeds: Sequence[int], device,
         drawn_stats: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """{net: {leaf: [K, *shape] float32}} for replicas `seeds`."""
    device = torch.device(device)
    kinds = set(_DRAWN) | ({"running_mean", "running_var"} if drawn_stats else set())
    total = sum(math.prod(s) for leaves in layout.values() for _, s, k in leaves if k in kinds)
    draws = torch.stack([
        torch.randn(total, generator=torch.Generator(device=device).manual_seed(_seed(s)),
                    device=device) for s in seeds])
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    at = 0
    k = len(seeds)
    for net, leaves in layout.items():
        out[net] = {}
        for name, shape, kind in leaves:
            if kind in kinds:
                n = math.prod(shape)
                d = draws[:, at:at + n].reshape(k, *shape)
                at += n
            if kind == "dense":
                t = 0.02 * d
            elif kind == "bn_scale":
                t = 1.0 + 0.02 * d
            elif kind == "unit":
                t = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-12)
            elif kind == "running_mean":
                t = 0.1 * d if drawn_stats else torch.zeros((k, *shape), device=device)
            elif kind == "running_var":
                t = torch.exp(0.3 * d) if drawn_stats else torch.ones((k, *shape), device=device)
            elif kind == "ones":
                t = torch.ones((k, *shape), device=device)
            elif kind == "zeros":
                t = torch.zeros((k, *shape), device=device)
            else:
                raise ValueError(f"unknown leaf kind {kind!r} of {net}.{name}")
            out[net][name] = t.contiguous()
    return out
