"""Ring (context-parallel) attention over a mesh axis, the counterpart of
`cvaegan_tpu/kernels/ring_attention.py`.

The sequence axis is split over an axis of a `parallel.mesh.Mesh`: each
rank holds one Q shard `[bh, seq/N, d]` and one KV shard of the same
length. In N steps each rank attends its Q shard to the KV shard it holds
and folds the partial result into running (max, sum, accumulator)
statistics, the same (m, l, acc) recurrence as the block-attention
kernels, while it passes the KV shard on to rank (r + 1) % N and takes
the next from rank (r - 1) % N (`torch.distributed.batch_isend_irecv`,
started before the merge and waited for after it). After N steps every
rank has attended to the whole sequence and normalises locally; the
per-row attention entropy is carried the same way (a running sum of
p * s). Every step is in float32.

There is no kernel here, as there is no Pallas kernel in the JAX module:
the per-shard products are `torch.einsum`, as JAX computes them outside
any kernel (`cvaegan_tpu/kernels/ring_attention.py:61-71`). The rotation
runs at every ring size, 1 included (NCCL sends to its own rank; gloo
does not, so a 1-rank gloo ring raises).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.distributed as dist

NEG_INF = -1e30


def _merge_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float, carry, with_entropy: bool):
    """Fold one KV shard into the running online-softmax statistics:
    carry = (m, l, acc[, sl]), m, l and sl `[bh, sq, 1]`, acc `[bh, sq, d]`."""
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    m_cur = s.amax(-1, keepdim=True)
    if with_entropy:
        m_prev, l_prev, acc, sl_prev = carry
    else:
        m_prev, l_prev, acc = carry
    m_new = torch.maximum(m_prev, m_cur)
    p = torch.exp(s - m_new)
    alpha = torch.exp(m_prev - m_new)
    l_new = alpha * l_prev + p.sum(-1, keepdim=True)
    acc = alpha * acc + torch.einsum("bqk,bkd->bqd", p, v)
    if with_entropy:
        sl_new = alpha * sl_prev + (p * s).sum(-1, keepdim=True)
        return m_new, l_new, acc, sl_new
    return m_new, l_new, acc


def _ring_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
               with_entropy: bool):
    """Attention of this rank's Q shard over every rank's KV shard of the
    ring `group`: q, k, v are the LOCAL shards, float32."""
    bh, sq, d = q.shape
    scale = d ** -0.5
    n, r = dist.get_world_size(group), dist.get_rank(group)
    to = dist.get_global_rank(group, (r + 1) % n)
    frm = dist.get_global_rank(group, (r - 1) % n)
    carry = (torch.full((bh, sq, 1), NEG_INF, device=q.device),
             torch.zeros((bh, sq, 1), device=q.device),
             torch.zeros((bh, sq, d), device=q.device))
    if with_entropy:
        carry = (*carry, torch.zeros((bh, sq, 1), device=q.device))
    kv = torch.stack([k, v])
    for _ in range(n):
        # the shard travels on while it is merged; after n rotations every
        # shard is back where it started, as in the JAX loop
        nxt = torch.empty_like(kv)
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, kv, to, group),
                                        dist.P2POp(dist.irecv, nxt, frm, group)])
        carry = _merge_step(q, kv[0], kv[1], scale, carry, with_entropy)
        for work in works:
            work.wait()
        kv = nxt
    if with_entropy:
        m, l, acc, sl = carry
        return acc / l, (m + torch.log(l) - sl / l)[..., 0]
    m, l, acc = carry
    return acc / l


def _gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's shard of the sequence axis (axis 1), in ring order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis: str = "data", with_entropy: bool = False
                   ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Exact softmax(q k^T / sqrt(d)) v with the sequence axis split over
    `axis` of `mesh`. q, k, v are the global `[bh, seq, d]` tensors, as
    the JAX entry takes them (seq a multiple of the ring size); every rank
    of the axis calls it, computes its shard and gets the global result
    `[bh, seq, d]` (and the per-row entropy `[bh, seq]` with
    `with_entropy`), float32."""
    bh, seq, d = q.shape
    n = mesh.shape[axis]
    if seq % n:
        raise ValueError(f"ring size {n} must divide seq {seq} — pad seq to a "
                         f"multiple of {n}")
    group = mesh.group(axis)
    lo = mesh.local_rank(axis) * (seq // n)
    q, k, v = (t[:, lo:lo + seq // n].float() for t in (q, k, v))
    out = _ring_body(q, k, v, group, with_entropy)
    if with_entropy:
        return _gather_seq(out[0], group), _gather_seq(out[1], group)
    return _gather_seq(out, group)
