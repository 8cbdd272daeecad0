"""Plain PyTorch networks of the CVAE-GAN configuration, for the
comparison that decides `correct`.

Written from the published model (the reference repository's
`src/models/cvae_gan_models.py`) in
the numerics the configuration states: float32, BatchNorm with Flax's
statistics (momentum 0.9 on the running averages, biased variance),
spectral normalisation by one power-iteration step per train forward,
LayerNorm eps 1e-5, LeakyReLU 0.2, dropout 0.3. Nothing here imports the
program: the leaf names follow the published module layout, and the
benchmark checks that the program's state holds exactly these leaves.

Every leaf carries a leading axis of K independent replicas (K = 1 for a
single model), so one set of functions serves a trainer and a seed bank;
a product is one batched matmul over K. Activations are `[K, rows, ...]`.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Leaves = Dict[str, torch.Tensor]

#: the precision of every product: "float32", or "tf32" inside `tf32_products()`
_PRODUCTS = ["float32"]


# ------------------------------------------------------------------ layout
def hidden_sizes(d: int, pin_h3: bool = False) -> Tuple[int, int, int]:
    """max(256, d), max(128, d // 2), max(64, d // 4); 64 where pinned
    (`src/models/cvae_gan_models.py:16-18`, `:173-175`)."""
    return max(256, d), max(128, d // 2), 64 if pin_h3 else max(64, d // 4)


def _dense(out: List, name: str, n_in: int, n_out: int, spectral: bool = False) -> None:
    out.append((f"{name}.weight", (n_out, n_in), "dense"))
    out.append((f"{name}.bias", (n_out,), "zeros"))
    if spectral:
        out.append((f"{name}.u", (n_out,), "unit"))
        out.append((f"{name}.v", (n_in,), "unit"))


def _bn(out: List, name: str, n: int) -> None:
    out += [(f"{name}.weight", (n,), "bn_scale"), (f"{name}.bias", (n,), "zeros"),
            (f"{name}.running_mean", (n,), "running_mean"),
            (f"{name}.running_var", (n,), "running_var")]


def _ln(out: List, name: str, n: int) -> None:
    out += [(f"{name}.weight", (n,), "ones"), (f"{name}.bias", (n,), "zeros")]


def _trunk(out: List, name: str, d: int) -> int:
    dims = [d, *hidden_sizes(d)]
    for i in range(3):
        _dense(out, f"{name}.dense.{i}", dims[i], dims[i + 1])
    for i in range(3):
        _bn(out, f"{name}.bn.{i}", dims[i + 1])
    return dims[-1]


def layout(cfg: dict) -> Dict[str, List[Tuple[str, tuple, str]]]:
    """Per network, its leaves in order: (name, shape without the replica
    axis, how it is drawn). Parameters come before buffers within a
    layer, as the published modules register them."""
    f, c, z = cfg["feature_num"], cfg["label_num"], cfg["z_size"]
    nets: Dict[str, List] = {}
    if cfg["model"] == "cvae_gan":
        enc: List = []
        h = _trunk(enc, "trunk", f + c)
        _dense(enc, "mu", h, z)
        _dense(enc, "log_var", h, z)
        gen: List = []
        h = _trunk(gen, "generator_trunk", z + c)
        gen = [(n.replace("generator_trunk", "trunk"), s, k) for n, s, k in gen]
        _dense(gen, "head", h, f)
        dis: List = []
        dims = [f + c, *hidden_sizes(f + c, pin_h3=True), 1]
        for i in range(4):
            _dense(dis, f"layers.{i}", dims[i], dims[i + 1], spectral=True)
        clf: List = []
        dims = [f, *hidden_sizes(f, pin_h3=True), c]
        for i in range(4):
            _dense(clf, f"layers.{i}", dims[i], dims[i + 1])
        _ln(clf, "norm", dims[2])
        nets = {"encoder": enc, "generator": gen, "discriminator": dis, "classifier": clf}
    else:
        raise ValueError(f"no reference for model {cfg['model']!r}")
    return nets


def is_buffer(name: str) -> bool:
    """Whether a leaf is state that no optimizer steps."""
    return name.rsplit(".", 1)[-1] in ("running_mean", "running_var", "u", "v")


# ---------------------------------------------------------------- products
def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to TF32 (10-bit mantissa, to nearest, ties away from
    zero), as the tensor cores take a float32 operand."""
    bits = t.detach().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).view_as(t)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32 and the sums in float32,
    forward and backward (the gradient's products alike)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(to_tf32(a), to_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return (torch.matmul(g, to_tf32(b).transpose(-1, -2)),
                torch.matmul(to_tf32(a).transpose(-1, -2), g))


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's one product: a @ b (batched over the leading axes)
    in the precision in force."""
    if _PRODUCTS[0] == "tf32":
        return _TF32MatMul.apply(a, b)
    return torch.matmul(a, b)


@contextlib.contextmanager
def tf32_products():
    """Inside the block every product of the reference takes TF32
    operands: the control of the comparison, one precision below the
    configuration's float32 (`control.py`)."""
    old, _PRODUCTS[0] = _PRODUCTS[0], "tf32"
    try:
        yield
    finally:
        _PRODUCTS[0] = old


# ------------------------------------------------------------------ layers
def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """x [K, ..., in] times each replica's W [K, out, in]^T, plus b [K, out]."""
    flat = x.reshape(x.shape[0], -1, x.shape[-1])
    y = mm(flat, w.transpose(1, 2))
    if b is not None:
        y = y + b[:, None, :]
    return y.reshape(*x.shape[:-1], w.shape[1])


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)


def spectral_weight(p: Leaves, name: str, train: bool) -> torch.Tensor:
    """W / sigma; in train mode one power-iteration step first, which
    updates u and v in place (no gradient reaches them)."""
    w = p[f"{name}.weight"]
    u, v = p[f"{name}.u"], p[f"{name}.v"]
    if train:
        with torch.no_grad():
            v_new = _unit(mm(u[:, None, :], w)[:, 0])
            u_new = _unit(mm(w, v_new[:, :, None])[:, :, 0])
            u.copy_(u_new)
            v.copy_(v_new)
    sigma = (u * mm(w, v[:, :, None])[:, :, 0]).sum(-1)
    return w / sigma[:, None, None]


def dense(p: Leaves, name: str, x: torch.Tensor, spectral: bool = False,
          train: bool = True) -> torch.Tensor:
    w = spectral_weight(p, name, train) if spectral else p[f"{name}.weight"]
    return linear(x, w, p[f"{name}.bias"])


def _per_feature(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return t.view(t.shape[0], *[1] * (x.dim() - 2), t.shape[-1])


def batch_norm(p: Leaves, name: str, x: torch.Tensor, train: bool,
               momentum: float = 0.9, eps: float = 1e-5) -> torch.Tensor:
    """Over the rows of each replica: batch moments (biased variance) in
    train mode, which move the running averages; running ones in eval."""
    rm, rv = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    if train:
        mean = x.mean(dim=-2)
        var = (x - mean[:, None, :]).square().mean(dim=-2)
        with torch.no_grad():
            rm.copy_(momentum * rm + (1.0 - momentum) * mean)
            rv.copy_(momentum * rv + (1.0 - momentum) * var)
    else:
        mean, var = rm, rv
    scale = p[f"{name}.weight"] / torch.sqrt(var + eps)
    return (x - mean[:, None, :]) * scale[:, None, :] + p[f"{name}.bias"][:, None, :]


def layer_norm(p: Leaves, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    return y * _per_feature(p[f"{name}.weight"], x) + _per_feature(p[f"{name}.bias"], x)


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def dropout(x: torch.Tensor, draws, rate: float = 0.3) -> torch.Tensor:
    """Inverted dropout; `draws.uniform(shape)` gives each replica's mask
    draws `[K, *shape]` from its own generator."""
    keep = draws.uniform(tuple(x.shape[1:])) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def one_hot(labels: torch.Tensor, n: int) -> torch.Tensor:
    return F.one_hot(labels.long(), n).to(torch.float32)


# ------------------------------------------------------- CVAE-GAN networks
def _trunk_forward(p: Leaves, x: torch.Tensor, train: bool) -> torch.Tensor:
    for i in range(3):
        x = leaky(batch_norm(p, f"trunk.bn.{i}", dense(p, f"trunk.dense.{i}", x), train))
    return x


def cvae_encoder(p, x, y, c, train=True):
    h = _trunk_forward(p, torch.cat([x, one_hot(y, c)], dim=-1), train)
    return dense(p, "mu", h), dense(p, "log_var", h)


def cvae_generator(p, z, y, c, train=True):
    h = _trunk_forward(p, torch.cat([z, one_hot(y, c)], dim=-1), train)
    return torch.sigmoid(dense(p, "head", h))


def cvae_discriminator(p, x, y, c, draws, train=True):
    h = torch.cat([x, one_hot(y, c)], dim=-1)
    h = leaky(dense(p, "layers.0", h, True, train))
    h = dropout(h, draws) if train else h
    h = leaky(dense(p, "layers.1", h, True, train))
    h = dropout(h, draws) if train else h
    h = leaky(dense(p, "layers.2", h, True, train))
    return dense(p, "layers.3", h, True, train)


def cvae_classifier(p, x, draws, train=True):
    h = torch.relu(dense(p, "layers.0", x))
    h = dropout(h, draws) if train else h
    h = torch.relu(layer_norm(p, "norm", dense(p, "layers.1", h)))
    h = dropout(h, draws) if train else h
    h = torch.relu(dense(p, "layers.2", h))
    return dense(p, "layers.3", h)
