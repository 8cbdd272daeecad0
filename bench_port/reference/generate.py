"""Plain PyTorch prior sampling of a conditional MLP generator: the
reference that the generation cells' rows are held to.

Rows of class c from the prior: z ~ N(0, I) drawn from a generator seeded
as the trainer's, one draw of `[num, z_size]` per call in call order,
then the generator's eval-mode forward on concat(z, onehot(c)): three
Dense -> BatchNorm (running statistics) -> LeakyReLU(0.2) layers and a
Dense head with a sigmoid, in float32.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import torch

from bench_port.reference import nets

BLOCK_ROWS = 1 << 18


@torch.no_grad()
def rows(cfg: dict, generator: Dict[str, torch.Tensor], z: torch.Tensor,
         label: int) -> torch.Tensor:
    """Eval-mode forward of replica 0 of `generator`'s leaves on z, in
    blocks of rows."""
    p = {k: t[:1] for k, t in generator.items()}
    out = []
    for i in range(0, z.shape[0], BLOCK_ROWS):
        zb = z[i:i + BLOCK_ROWS][None]
        y = torch.full(zb.shape[:2], label, dtype=torch.int64, device=z.device)
        out.append(nets.cvae_generator(p, zb, y, cfg["label_num"], train=False)[0])
    return torch.cat(out)


@torch.no_grad()
def replay(cfg: dict, generator: Dict[str, torch.Tensor], seed: int,
           calls: Sequence[Tuple[int, int]], wanted: Iterable[int], device,
           relabel: Dict[int, int] = None) -> Dict[int, torch.Tensor]:
    """The reference's rows of the calls `wanted` (indices into `calls`,
    each (class, num) in the order they were made), drawing every call's
    z in turn from one generator seeded `seed`. `relabel` {call: class}
    plants a fault for the harness's controls: that call's rows are
    another class's."""
    wanted, relabel = set(wanted), relabel or {}
    g = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for i, (label, num) in enumerate(calls):
        z = torch.randn((num, cfg["z_size"]), generator=g, device=device)
        if i in wanted:
            out[i] = rows(cfg, generator, z, relabel.get(i, label))
    return out
