"""Fused 4-layer MLP forward for the generation/serving path, the
counterpart of `cvaegan_tpu/kernels/fused_mlp.py`.

The zoo's generators are 3x[Dense+BN+LeakyReLU] + Dense+Sigmoid stacks
(`src/models/cvae_gan_models.py:90-110`). In eval mode BatchNorm is an
affine transform, so it folds into the preceding Dense and the whole
generator becomes 4 matmuls and activations. `fused_mlp4` runs all four
layers in one launch of the hand-written CUDA kernel
`cvaegan_tpu_torch/csrc/fused_mlp4.cu` (design and bound in its header).

`fused_mlp4` takes its plain PyTorch version, `mlp4_reference`, only for
a tensor that lies on the CPU. For a CUDA tensor it launches the kernel
or raises; `LAUNCHES` counts the launches.
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

#: kernel launches since the count was last set to 0
LAUNCHES = 0

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


def build() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_mlp4_f32.argtypes = [p] * 10 + [i] * 7 + [p]
        lib.fused_mlp4_f32.restype = i
        lib.fused_mlp4_tile_rows.argtypes = [i] * 4
        lib.fused_mlp4_tile_rows.restype = i
        lib.fused_mlp4_error_string.argtypes = [i]
        lib.fused_mlp4_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def fused_mlp4(x: torch.Tensor, weights: Sequence[torch.Tensor],
               biases: Sequence[torch.Tensor],
               final: str = "sigmoid") -> torch.Tensor:
    """y = final(L4(lrelu(L3(lrelu(L2(lrelu(L1(x)))))))) on float32
    `[in, out]` weights. CPU tensors take `mlp4_reference`; CUDA tensors
    launch the kernel (contiguous float32 inputs only)."""
    global LAUNCHES
    dims = _check(x, weights, biases, final)
    if x.device.type == "cpu":
        return mlp4_reference(x, weights, biases, final)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp4 runs on cpu or cuda, not {x.device}")
    tensors = (x, weights[0], biases[0], weights[1], biases[1],
               weights[2], biases[2], weights[3], biases[3])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_mlp4 takes contiguous tensors")
    lib = build()
    n = x.shape[0]
    out = torch.empty((n, dims[4]), device=x.device, dtype=torch.float32)
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        if lib.fused_mlp4_tile_rows(*dims[:4]) == 0:
            raise ValueError(f"layer widths {dims} exceed one block's shared memory")
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fused_mlp4_f32(*(t.data_ptr() for t in tensors),
                                out.data_ptr(), n, *dims, FINALS[final], stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_mlp4 launch failed: {lib.fused_mlp4_error_string(rc).decode()}")
    LAUNCHES += 1
    return out


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
