"""Blockwise (flash-style) self-attention forward, the counterpart of
`cvaegan_tpu/kernels/block_attention.py`.

Layout: q, k, v are `[batch*heads, seq, head_dim]`, as in the JAX
package, all float32 or all bfloat16 (the bf16 compute policy's q, k, v);
the outputs are float32 either way, as the JAX kernels return them.
`block_attention` computes softmax(q k^T / sqrt(d)) v;
`block_attention_with_entropy` also returns each row's attention entropy
`[batch*heads, seq]` without materialising the probability matrix, which
is what `MultiHeadSelfAttention` uses at long sequences. Both run
hand-written CUDA kernels (design and bound in each source's header):
float32 inputs those of `cvaegan_tpu_torch/csrc/block_attention.cu`
(`mma.sync`), bf16 inputs those of `csrc/block_attention_sm90.cu` (TMA
and `wgmma`; they replace the same TPU kernels,
`cvaegan_tpu/kernels/block_attention.py:30,56`, run on bf16 operands),
for head dims 16, 32, 64 and 128 and any seq >= 1, ragged or not: the
kernels mask the ragged tails themselves.

The wrappers take their plain PyTorch versions,
`block_attention_reference` and `block_attention_with_entropy_reference`,
only for tensors that lie on the CPU; they take bf16 inputs by widening
them to float32 (exact), which is what the JAX kernels compute on them.
For CUDA tensors the wrappers launch a kernel or raise; `LAUNCHES` and
`ENTROPY_LAUNCHES` count the float32 kernels' launches,
`BF16_LAUNCHES` and `BF16_ENTROPY_LAUNCHES` the bf16 kernels'.
The JAX entries' `interpret`, `block_q` and `block_k` are TPU tiling and
emulation knobs and have no counterpart here. Like the TPU kernels, these
are forward-only: a call that would need a gradient raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from cvaegan_tpu_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)
#: input dtype -> the source of its kernels and their C entry (each
#: library also exports `block_attention_error_string`)
SOURCES = {torch.float32: "block_attention.cu", torch.bfloat16: "block_attention_sm90.cu"}
ENTRIES = {torch.float32: "block_attention_f32", torch.bfloat16: "block_attention_sm90_bf16"}
#: score-matrix elements per chunk of heads in the plain versions (1 GiB
#: of float32), so that a long sequence fits on the card
PLAIN_CHUNK_ELEMENTS = 1 << 28

#: kernel launches since the count was last set to 0, per wrapper and
#: input dtype
LAUNCHES = 0
ENTROPY_LAUNCHES = 0
BF16_LAUNCHES = 0
BF16_ENTROPY_LAUNCHES = 0

_libs: Dict[torch.dtype, ctypes.CDLL] = {}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bqd,bkd->bqk", q, k) * (q.shape[-1] ** -0.5)


def reference_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Dense softmax attention (counterpart of the JAX oracle)."""
    p = torch.softmax(_scores(q, k), dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v)


def reference_attention_entropy(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Dense per-row softmax entropy `[bh, seq]` (counterpart of the JAX
    oracle)."""
    s = _scores(q, k)
    return -(torch.softmax(s, dim=-1) * torch.log_softmax(s, dim=-1)).sum(-1)


def _widened(*ts: torch.Tensor):
    """bf16 tensors as float32 (exact); others as they are."""
    return tuple(t.float() if t.dtype == torch.bfloat16 else t for t in ts)


def _heads_per_chunk(q: torch.Tensor) -> int:
    seq = q.shape[1]
    return max(1, PLAIN_CHUNK_ELEMENTS // max(1, seq * seq))


def block_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Plain version of `block_attention`: `reference_attention` over
    chunks of heads, each holding at most `PLAIN_CHUNK_ELEMENTS` scores;
    bf16 inputs are widened to float32."""
    q, k, v = _widened(q, k, v)
    n = _heads_per_chunk(q)
    return torch.cat([reference_attention(q[i:i + n], k[i:i + n], v[i:i + n])
                      for i in range(0, q.shape[0], n)])


def block_attention_with_entropy_reference(
        q: torch.Tensor, k: torch.Tensor,
        v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `block_attention_with_entropy`: (dense attention,
    dense row entropy) over chunks of heads, one score matrix per chunk;
    bf16 inputs are widened to float32."""
    q, k, v = _widened(q, k, v)
    n = _heads_per_chunk(q)
    outs, ents = [], []
    for i in range(0, q.shape[0], n):
        s = _scores(q[i:i + n], k[i:i + n])
        p, logp = torch.softmax(s, dim=-1), torch.log_softmax(s, dim=-1)
        outs.append(torch.einsum("bqk,bkd->bqd", p, v[i:i + n]))
        ents.append(-(p * logp).sum(-1))
    return torch.cat(outs), torch.cat(ents)


def float64_rule(got: torch.Tensor, plain: torch.Tensor, exact: torch.Tensor,
                 atol: float = 2e-5) -> Tuple[float, float]:
    """FlashAttention's test rule for inputs where float32 itself is not
    accurate: `got` passes if max|got - exact| <= 3 max|plain - exact| +
    atol, where `plain` is the plain version in float32 and `exact` the
    same plain version run on float64 copies of the inputs. Returns
    (max|got - exact|, the worst error over that limit); passes at <= 1.

    At inputs of scale 10 the scores reach thousands before the d^-0.5
    scale, and rows with near-ties swing with float32 rounding: the plain
    float32 version itself misses a float64 run by far more than the
    unit-scale tolerance 2e-5. A kernel that sums each score in d order with
    one FMA after another, as cuBLAS's float32 GEMM does, happens to
    follow the plain version's rounding; any other order of summation
    (tensor cores, tiling over d) does not, however accurate. So at such
    scales a kernel is held to the float64 run, with the plain version's
    own error as the yardstick."""
    exact = exact.double()
    err = float((got.double() - exact).abs().max())
    limit = 3.0 * float((plain.double() - exact).abs().max()) + atol
    return err, err / limit


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on anything the kernels do not take, whatever the device."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must share one [bh, seq, d] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim must be one of {HEAD_DIMS}, got {q.shape[-1]}")
    if q.dtype not in ENTRIES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("block attention takes q, k and v all float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError("q, k and v must lie on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"block attention runs on cpu or cuda, not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("block attention is forward-only (no backward, as "
                           "in the JAX package); call it under torch.no_grad()")


def build(dtype: torch.dtype) -> ctypes.CDLL:
    """Build (at first use) and load the library of the kernels that take
    `dtype` inputs."""
    if dtype not in _libs:
        lib = _build.load(SOURCES[dtype])
        p, i = ctypes.c_void_p, ctypes.c_int
        entry = getattr(lib, ENTRIES[dtype])
        entry.argtypes = [p] * 5 + [i] * 3 + [p]
        entry.restype = i
        lib.block_attention_error_string.argtypes = [i]
        lib.block_attention_error_string.restype = ctypes.c_char_p
        _libs[dtype] = lib
    return _libs[dtype]


def _launch(q, k, v, with_entropy: bool):
    """Launch the kernel for q's dtype on CUDA tensors checked by `_check`
    and count the launch; returns (out, entropy or None), float32."""
    global LAUNCHES, ENTROPY_LAUNCHES, BF16_LAUNCHES, BF16_ENTROPY_LAUNCHES
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("block attention takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("block attention takes 16-byte aligned tensors")
    bh, seq, d = q.shape
    out = torch.empty_like(q, dtype=torch.float32)
    ent = torch.empty((bh, seq), device=q.device, dtype=torch.float32) \
        if with_entropy else None
    if out.numel() == 0:
        return out, ent
    lib = build(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, ENTRIES[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if ent is None else ent.data_ptr(), bh, seq, d, stream)
    if rc != 0:
        raise RuntimeError("block attention launch failed: "
                           f"{lib.block_attention_error_string(rc).decode()}")
    bf16 = q.dtype == torch.bfloat16
    if with_entropy and bf16:
        BF16_ENTROPY_LAUNCHES += 1
    elif with_entropy:
        ENTROPY_LAUNCHES += 1
    elif bf16:
        BF16_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out, ent


def block_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over `[bh, seq, d]` float32 or bf16
    inputs, as float32. CPU tensors take `block_attention_reference`; CUDA
    tensors launch the kernel for their dtype (contiguous inputs only)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return block_attention_reference(q, k, v)
    out, _ = _launch(q, k, v, with_entropy=False)
    return out


def block_attention_with_entropy(
        q: torch.Tensor, k: torch.Tensor,
        v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """As `block_attention`, and also each row's attention entropy
    `[bh, seq]`. CPU tensors take `block_attention_with_entropy_reference`;
    CUDA tensors launch the kernel."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return block_attention_with_entropy_reference(q, k, v)
    return _launch(q, k, v, with_entropy=True)
