"""The numbers that decide `correct` for a training cell, and the rule on
which parts of the state count.

A quantity per leaf (an Adam moment, a leaf's change over the first
epoch) is compared by its norm: for each replica and leaf, the gap
between the program's norm and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf. The number is the
worst gap over the leaves that count and every replica.

What counts: a parameter element whose gradient is nought to rounding in
the reference moves under Adam by round-off alone, by up to the learning
rate a step and with a sign of its own in any two programs: a bias in
front of a BatchNorm, the critic's output bias under a Wasserstein loss,
and, in strict mode, where every row of a batch has the same label, the
one-hot column in front of a BatchNorm. Such elements are left out by
their gradient in the reference's first epoch: a root-mean-square under
a thousandth of the median parameter leaf's. A leaf with no element left
is left out whole; the running mean of a BatchNorm whose dense bias is
left out reads that bias's round-off walk, and goes with it. Every other
buffer counts whole.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

GRAD_FLOOR = 1e-3

Tree = Dict[str, Dict[str, torch.Tensor]]


def counted(grad_rms: Tree, leaves: Tree) -> Tree:
    """{net: {leaf: bool mask [K, ...]}} of the elements that count."""
    scale = torch.stack([g.flatten(1).square().mean(1).sqrt()
                         for net in grad_rms.values() for g in net.values()])  # [L, K]
    floor = GRAD_FLOOR * scale.median(dim=0).values  # [K]
    masks: Tree = {}
    for net, ls in leaves.items():
        g = grad_rms.get(net, {})
        masks[net] = {}
        for name, t in ls.items():
            if name in g:
                m = g[name] >= floor.view(-1, *[1] * (t.dim() - 1))
            elif name.endswith("running_mean"):
                bias = name.replace(".bn.", ".dense.").replace(".running_mean", ".bias")
                whole = bias not in masks[net] or bool(masks[net][bias].any())
                m = torch.full_like(t, whole, dtype=torch.bool)
            else:
                m = torch.ones_like(t, dtype=torch.bool)
            if bool(m.any()):
                masks[net][name] = m
    return masks


def left_out(masks: Tree, leaves: Tree) -> Dict[str, float]:
    """{net.leaf: share of its elements left out}, for the leaves that
    lose any."""
    out = {}
    for net, ls in leaves.items():
        for name, t in ls.items():
            m = masks[net].get(name)
            share = 1.0 if m is None else 1.0 - float(m.float().mean())
            if share:
                out[f"{net}.{name}"] = round(share, 4)
    return out


def norm_gaps(prog: Tree, ref: Tree, masks: Tree):
    """(gaps [L, K], leaf names): each counted leaf's gap, per replica,
    over the counted elements of the leaves in both `ref` and `masks`."""
    names = [(net, k) for net in masks for k in sorted(masks[net]) if k in ref.get(net, {})]
    if not names:
        raise ValueError("no leaf counts")

    def norms(tree):
        return torch.stack([(tree[n][k].double() * masks[n][k]).flatten(1).norm(dim=1)
                            for n, k in names])  # [L, K]

    p_norm, r_norm = norms(prog), norms(ref)
    scale = torch.maximum(r_norm, r_norm.median(dim=0).values[None, :])
    return (p_norm - r_norm).abs() / torch.clamp_min(scale, 1e-30), names


def by_net(gaps: torch.Tensor, names) -> Dict[str, Tuple[float, float]]:
    """{net: (its worst leaf's gap, its median leaf's), worst over the
    replicas}, for the record."""
    rows: Dict[str, list] = {}
    for (net, _), row in zip(names, gaps):
        rows.setdefault(net, []).append(row)
    return {net: (float(torch.stack(r).max()), float(torch.stack(r).median(dim=0).values.max()))
            for net, r in rows.items()}


def worst_gap(gaps: torch.Tensor, names) -> Tuple[float, str]:
    """(the worst leaf's gap over every replica, "net.leaf[k]")."""
    leaf, k = divmod(int(gaps.argmax()), gaps.shape[1])
    return float(gaps.max()), f"{names[leaf][0]}.{names[leaf][1]}[{k}]"


def median_gap(gaps: torch.Tensor) -> Tuple[float, str]:
    """(the median leaf's gap, worst over the replicas, "replica k")."""
    med = gaps.median(dim=0).values
    return float(med.max()), f"replica {int(med.argmax())}"


def loss_gap(prog: torch.Tensor, ref: torch.Tensor) -> Tuple[float, str]:
    """Worst gap of the recorded losses `[epochs, K, keys]`, each over the
    larger of its reference value and the median over the keys of the
    reference's values in that epoch and replica."""
    prog, ref = prog.detach().cpu().double(), ref.detach().cpu().double()
    scale = torch.maximum(ref.abs(), ref.abs().median(dim=-1, keepdim=True).values)
    gaps = (prog - ref).abs() / torch.clamp_min(scale, 1e-30)
    flat = int(gaps.argmax())
    e, rest = divmod(flat, gaps.shape[1] * gaps.shape[2])
    k, key = divmod(rest, gaps.shape[2])
    return float(gaps.max()), f"epoch {e} replica {k} key {key}"


def change(after: Tree, before: Tree) -> Tree:
    return {net: {k: after[net][k] - before[net][k] for k in after[net]} for net in after}
