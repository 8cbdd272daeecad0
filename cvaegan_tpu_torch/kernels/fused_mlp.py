"""Fused 4-layer MLP forward for the generation/serving path, the
counterpart of `cvaegan_tpu/kernels/fused_mlp.py`.

The zoo's generators are 3x[Dense+BN+LeakyReLU] + Dense+Sigmoid stacks
(`src/models/cvae_gan_models.py:90-110`). In eval mode BatchNorm is an
affine transform, so it folds into the preceding Dense and the whole
generator becomes 4 matmuls and activations. `fused_mlp4` runs all four
layers in one launch of a hand-written CUDA kernel of
`cvaegan_tpu_torch/csrc/fused_mlp4.cu` (design and bound in its header):
the tensor-core kernel (three TF32 passes, float32-accurate) where every
layer is at most 256 wide and its shared memory fits, which the serving
widths do, else the float32 SIMT kernel. `kernel_variant` makes that
choice from the widths alone, before any launch.

`fused_mlp4` takes its plain PyTorch version, `mlp4_reference`, only for
a tensor that lies on the CPU. For a CUDA tensor it launches a kernel or
raises; `TC_LAUNCHES` and `SIMT_LAUNCHES` count each kernel's launches,
`LAUNCHES` both.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from cvaegan_tpu_torch.kernels import _build
from cvaegan_tpu_torch.models.layers import LEAKY_SLOPE, Dense, MLPTrunk

SOURCE = "fused_mlp4.cu"
FINALS = {"sigmoid": 0, "tanh": 1, "none": 2}

#: launches of the tensor-core kernel, of the SIMT kernel, and of both,
#: since each count was last set to 0
TC_LAUNCHES = 0
SIMT_LAUNCHES = 0
LAUNCHES = 0

#: shared memory one block can opt into on an H100 (227 KB)
SMEM_LIMIT = 232_448
#: the tensor-core kernel's rows per block, widest layer, weights per
#: k-chunk and k per chunk at most: `kTcRows`, `kTcMaxN`, `kChunk` and
#: `kMaxChunkRows` of the source, whose launch takes the activation
#: pitches and shared-memory size `tc_layout` derives from them
TC_ROWS = 64
TC_MAX_WIDTH = 256
TC_CHUNK = 4096
TC_MAX_CHUNK_ROWS = 128
#: the split weight tiles (two stages of hi/lo pairs), the landing area
#: (rows padded by 8) and the 4 layers' biases, in floats
_TC_FIXED_FLOATS = 2 * 2 * TC_CHUNK + (TC_CHUNK + 8 * TC_MAX_CHUNK_ROWS) + 4 * TC_MAX_WIDTH
#: rows per block the SIMT kernel tries, widest first; its launch takes
#: the one `simt_tile_rows` picks
SIMT_TILES = (32, 16, 8)

_lib: Optional[ctypes.CDLL] = None


def _final_act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "sigmoid":
        return torch.sigmoid(x)
    if kind == "tanh":
        return torch.tanh(x)
    return x


def mlp4_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                   biases: Sequence[torch.Tensor],
                   final: str = "sigmoid") -> torch.Tensor:
    """Plain PyTorch version of the kernel (counterpart of `xla_mlp4`):
    y = final(L4(lrelu(L3(lrelu(L2(lrelu(L1(x))))))))."""
    h = x
    for w, b in zip(weights[:3], biases[:3]):
        h = F.leaky_relu(h @ w + b, LEAKY_SLOPE)
    return _final_act(h @ weights[3] + biases[3], final)


def _check(x, weights, biases, final) -> List[int]:
    if final not in FINALS:
        raise ValueError(f"final must be one of {sorted(FINALS)}, got {final!r}")
    if len(weights) != 4 or len(biases) != 4:
        raise ValueError("fused_mlp4 takes exactly 4 weights and 4 biases")
    if x.dim() != 2:
        raise ValueError(f"x must be [n, in], got shape {tuple(x.shape)}")
    dims = [x.shape[1]]
    for w, b in zip(weights, biases):
        if w.dim() != 2 or w.shape[0] != dims[-1] or b.shape != (w.shape[1],):
            raise ValueError(
                f"layer shapes do not chain: x {tuple(x.shape)}, weights "
                f"{[tuple(w.shape) for w in weights]}, biases "
                f"{[tuple(b.shape) for b in biases]}")
        dims.append(w.shape[1])
    for t in (x, *weights, *biases):
        if t.device != x.device:
            raise ValueError("x, weights and biases must lie on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_mlp4 takes float32, got {t.dtype}")
    return dims


def _round8(v: int) -> int:
    return (v + 7) // 8 * 8


def tc_layout(dims: Sequence[int]) -> Tuple[int, int, int]:
    """(pa, pb, bytes) of one tensor-core block for layer widths `dims`
    (d0 .. d4): the pitches of its two activation buffers (x and layer
    2's output, then layers 1 and 3's), each its widest layer rounded up
    to 8, plus 4, and its shared memory: the fixed weight tiles and 64
    rows of each buffer."""
    pa = max(_round8(dims[0]), _round8(dims[2])) + 4
    pb = max(_round8(dims[1]), _round8(dims[3])) + 4
    return pa, pb, 4 * (_TC_FIXED_FLOATS + TC_ROWS * (pa + pb))


def tc_smem_bytes(dims: Sequence[int]) -> int:
    """Shared memory of one tensor-core block for layer widths `dims`."""
    return tc_layout(dims)[2]


def simt_tile_rows(dims: Sequence[int]) -> int:
    """Rows per block of the SIMT kernel for layer widths `dims`: the most
    of `SIMT_TILES` whose two float32 activation buffers fit, or 0."""
    per_row = 4 * (max(dims[0], dims[2]) + max(dims[1], dims[3]))
    return next((t for t in SIMT_TILES if t * per_row <= SMEM_LIMIT), 0)


def kernel_variant(dims: Sequence[int]) -> str:
    """"tensor_core" or "simt": the kernel that runs layer widths `dims`.
    Raises ValueError for widths that neither fits."""
    if max(dims[1:]) <= TC_MAX_WIDTH and tc_smem_bytes(dims) <= SMEM_LIMIT:
        return "tensor_core"
    if simt_tile_rows(dims) > 0:
        return "simt"
    raise ValueError(f"layer widths {list(dims)} exceed one block's shared memory")


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        # x, 4 x (w, b), out; n, d0 .. d4, final; the layout; the stream
        lib.fused_mlp4_tc_f32.argtypes = [p] * 10 + [i] * 7 + [i] * 3 + [p]
        lib.fused_mlp4_simt_f32.argtypes = [p] * 10 + [i] * 7 + [i] + [p]
        for fn in (lib.fused_mlp4_tc_f32, lib.fused_mlp4_simt_f32):
            fn.restype = i
        lib.fused_mlp4_error_string.argtypes = [i]
        lib.fused_mlp4_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(variant: str, x: torch.Tensor, weights: Sequence[torch.Tensor],
            biases: Sequence[torch.Tensor], final: str) -> torch.Tensor:
    """Launch one kernel on checked contiguous CUDA tensors with n > 0 and
    count it. `fused_mlp4` calls it with `kernel_variant`'s choice;
    `chip_smoke.py` also times the SIMT kernel at the serving widths."""
    global TC_LAUNCHES, SIMT_LAUNCHES, LAUNCHES
    lib = build()
    dims = [x.shape[1], *(w.shape[1] for w in weights)]
    if variant == "tensor_core":
        fn, layout = lib.fused_mlp4_tc_f32, tc_layout(dims)
    else:
        fn, layout = lib.fused_mlp4_simt_f32, (simt_tile_rows(dims),)
    out = torch.empty((x.shape[0], dims[4]), device=x.device, dtype=torch.float32)
    tensors = [x]
    for w, b in zip(weights, biases):
        tensors += [w, b]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in tensors), out.data_ptr(), x.shape[0], *dims,
                FINALS[final], *layout, stream)
    if rc != 0:
        raise RuntimeError(f"fused_mlp4 ({variant}) launch failed: "
                           f"{lib.fused_mlp4_error_string(rc).decode()}")
    if variant == "tensor_core":
        TC_LAUNCHES += 1
    else:
        SIMT_LAUNCHES += 1
    LAUNCHES += 1
    return out


def fused_mlp4(x: torch.Tensor, weights: Sequence[torch.Tensor],
               biases: Sequence[torch.Tensor],
               final: str = "sigmoid") -> torch.Tensor:
    """y = final(L4(lrelu(L3(lrelu(L2(lrelu(L1(x)))))))) on float32
    `[in, out]` weights. CPU tensors take `mlp4_reference`; CUDA tensors
    launch the kernel `kernel_variant` picks (contiguous float32 inputs
    only)."""
    dims = _check(x, weights, biases, final)
    if x.device.type == "cpu":
        return mlp4_reference(x, weights, biases, final)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp4 runs on cpu or cuda, not {x.device}")
    if not all(t.is_contiguous() for t in (x, *weights, *biases)):
        raise ValueError("fused_mlp4 takes contiguous tensors")
    variant = kernel_variant(dims)
    if x.shape[0] == 0:
        return torch.empty((0, dims[4]), device=x.device, dtype=torch.float32)
    return _launch(variant, x, weights, biases, final)


# ---------------------------------------------------------------------------
# BN folding: eval-mode [Dense -> BatchNorm] == one affine layer.
# ---------------------------------------------------------------------------


def fold_dense_bn(kernel, bias, bn_scale, bn_bias, bn_mean, bn_var,
                  eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold eval-mode BatchNorm into the preceding dense layer; `kernel` is
    in the `[in, out]` layout."""
    inv = bn_scale / torch.sqrt(bn_var + eps)
    return kernel * inv[None, :], (bias - bn_mean) * inv + bn_bias


@torch.no_grad()
def generator_fast_params(gen) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Folded contiguous `[in, out]` (weights, biases) of a standard
    `mlp.Generator` (MLPTrunk with BatchNorm + output Dense). Raises
    NotImplementedError for any other generator."""
    trunk, head = getattr(gen, "trunk", None), getattr(gen, "head", None)
    if not (isinstance(trunk, MLPTrunk) and len(trunk.dense) == 3
            and isinstance(head, Dense)):
        raise NotImplementedError(
            f"{type(gen).__name__} is not the standard MLP generator stack")
    weights, biases = [], []
    for dense, bn in zip(trunk.dense, trunk.bn):
        w, b = fold_dense_bn(dense.weight.t(), dense.bias, bn.weight, bn.bias,
                             bn.running_mean, bn.running_var, bn.eps)
        weights.append(w.contiguous())
        biases.append(b.contiguous())
    weights.append(head.weight.detach().t().contiguous())
    biases.append(head.bias.detach().contiguous())
    return weights, biases


def fast_generator_forward(gen, z: torch.Tensor, onehot_labels: torch.Tensor,
                           final: str = "sigmoid") -> torch.Tensor:
    """Fused eval-mode generator forward: concat(z, onehot) -> the 4-layer
    fused kernel. Equal to the module's eval forward up to the rounding of
    the BatchNorm fold."""
    weights, biases = generator_fast_params(gen)
    x = torch.cat([z, onehot_labels], dim=-1)
    return fused_mlp4(x, weights, biases, final=final)
