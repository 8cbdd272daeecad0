"""Plain PyTorch networks of the RAIN-GAN configuration, the residual-
attention CVAE-GAN, for the comparison that decides `correct`.

Written from the published model (the reference repository's
`src/models/rain_gan_models.py`) in the numerics the configuration
states: float32, LayerNorm eps 1e-5 (biased variance, two passes),
LeakyReLU 0.2, spectral normalisation by one power-iteration step per
train forward. Every network is a stack of pre-LN residual self-attention
blocks (`:8-52`): LayerNorm, multi-head self-attention (Q, K, V and O
projections, `:55-89`), a residual add, LayerNorm, a two-layer
feed-forward with LeakyReLU, and a shortcut that is a projection where
the width changes. Every input is a singleton sequence (`unsqueeze(1)`),
so each softmax runs over one key. The critic's input projection,
feed-forward, shortcut and head are spectral-normed; its attention
projections are not. Each network returns its last block's attention
probabilities beside its output, for the entropy term of the losses.

Departure, noted: the generator takes its z from the caller, so that the
reconstruction can run on z_enc (`rain_train.py`).

As in `nets.py`, every leaf carries a leading axis of K replicas,
activations are `[K, rows, ...]`, and every product goes through
`nets.linear` or `nets.mm`, so that `nets.tf32_products()` reaches it.
Nothing here imports the program: the leaf names and their order are the
published modules', and the benchmark checks that the program's state
holds exactly these leaves.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from bench_port.reference import nets
from bench_port.reference.nets import Leaves, dense, layer_norm, leaky, one_hot

NUM_HEADS = 4
#: each network's input projection width, then its blocks' output widths
WIDTHS = {"encoder": (256, 256, 128), "generator": (256, 256, 128, 64),
          "discriminator": (256, 256, 128), "classifier": (256, 256, 128)}


# ------------------------------------------------------------------ layout
def _block(out: List, name: str, d_in: int, d_out: int, spectral: bool) -> None:
    nets._ln(out, f"{name}.norm1", d_in)
    for proj in ("query", "key", "value", "out"):
        nets._dense(out, f"{name}.attention.{proj}", d_in, d_in)
    nets._ln(out, f"{name}.norm2", d_in)
    nets._dense(out, f"{name}.ff1", d_in, d_out, spectral)
    nets._dense(out, f"{name}.ff2", d_out, d_out, spectral)
    if d_in != d_out:
        nets._dense(out, f"{name}.shortcut", d_in, d_out, spectral)


def _stack(out: List, widths, spectral: bool = False) -> None:
    for i in range(len(widths) - 1):
        _block(out, f"blocks.{i}", widths[i], widths[i + 1], spectral)


def layout(cfg: dict) -> Dict[str, List[Tuple[str, tuple, str]]]:
    """Per network, its leaves in order: (name, shape without the replica
    axis, how it is drawn), as `nets.layout` gives them."""
    if cfg["model"] != "rain_gan":
        raise ValueError(f"no RAIN-GAN reference for model {cfg['model']!r}")
    f, c, z = cfg["feature_num"], cfg["label_num"], cfg["z_size"]
    enc: List = []
    nets._dense(enc, "proj", f + c, WIDTHS["encoder"][0])
    nets._ln(enc, "norm", WIDTHS["encoder"][0])
    _stack(enc, WIDTHS["encoder"])
    nets._dense(enc, "mu", WIDTHS["encoder"][-1], z)
    nets._dense(enc, "log_var", WIDTHS["encoder"][-1], z)
    gen: List = []
    nets._dense(gen, "proj", z + c, WIDTHS["generator"][0])
    nets._ln(gen, "norm", WIDTHS["generator"][0])
    _stack(gen, WIDTHS["generator"])
    nets._dense(gen, "head", WIDTHS["generator"][-1], f)
    dis: List = []
    nets._dense(dis, "proj", f + c, WIDTHS["discriminator"][0], spectral=True)
    _stack(dis, WIDTHS["discriminator"], spectral=True)
    nets._dense(dis, "head", WIDTHS["discriminator"][-1], 1, spectral=True)
    clf: List = []
    nets._dense(clf, "proj", f, WIDTHS["classifier"][0])
    nets._ln(clf, "norm", WIDTHS["classifier"][0])
    _stack(clf, WIDTHS["classifier"])
    nets._dense(clf, "head", WIDTHS["classifier"][-1], c)
    return {"encoder": enc, "generator": gen, "discriminator": dis, "classifier": clf}


# --------------------------------------------------------------- the block
def attention(p: Leaves, name: str, x: torch.Tensor):
    """Multi-head self-attention over `x [K, rows, seq, d]` -> (out, the
    probabilities `[K, rows, heads, seq, seq]`)."""
    k_, rows, s, d = x.shape
    hd = d // NUM_HEADS

    def heads(t):
        return t.reshape(k_, rows, s, NUM_HEADS, hd).transpose(2, 3)

    q, k, v = (heads(dense(p, f"{name}.{proj}", x)) for proj in ("query", "key", "value"))
    scores = nets.mm(q, k.transpose(-1, -2)) * (hd ** -0.5)
    probs = torch.softmax(scores, dim=-1)
    out = nets.mm(probs, v).transpose(2, 3).reshape(k_, rows, s, d)
    return dense(p, f"{name}.out", out), probs


def block(p: Leaves, name: str, x: torch.Tensor, spectral: bool, train: bool):
    a, probs = attention(p, f"{name}.attention", layer_norm(p, f"{name}.norm1", x))
    x = x + a
    ff = dense(p, f"{name}.ff1", layer_norm(p, f"{name}.norm2", x), spectral, train)
    ff = dense(p, f"{name}.ff2", leaky(ff), spectral, train)
    if f"{name}.shortcut.weight" in p:
        x = dense(p, f"{name}.shortcut", x, spectral, train)
    return x + ff, probs


def _blocks(p: Leaves, h: torch.Tensor, n: int, act, spectral: bool = False,
            train: bool = True):
    probs = None
    for i in range(n):
        h, probs = block(p, f"blocks.{i}", h, spectral, train)
        h = act(h)
    return h[:, :, 0], probs


# ---------------------------------------------------------------- networks
def encoder(p, x, y, c, train=True):
    """((mu, log_var), probabilities) of `x [K, rows, F]`, labels `y`."""
    h = torch.cat([x, one_hot(y, c)], dim=-1)[:, :, None]
    h = leaky(layer_norm(p, "norm", dense(p, "proj", h)))
    h, probs = _blocks(p, h, len(WIDTHS["encoder"]) - 1, leaky)
    return (dense(p, "mu", h), dense(p, "log_var", h)), probs


def generator(p, z, y, c, train=True):
    """(rows in [0, 1], probabilities) of `z [K, rows, Z]`, labels `y`."""
    h = torch.cat([z, one_hot(y, c)], dim=-1)[:, :, None]
    h = leaky(layer_norm(p, "norm", dense(p, "proj", h)))
    h, probs = _blocks(p, h, len(WIDTHS["generator"]) - 1, leaky)
    return torch.sigmoid(dense(p, "head", h)), probs


def discriminator(p, x, y, c, train=True):
    """(scores `[K, rows, 1]`, probabilities); in train mode every
    spectral layer takes one power-iteration step."""
    h = torch.cat([x, one_hot(y, c)], dim=-1)[:, :, None]
    h = leaky(dense(p, "proj", h, True, train))
    h, probs = _blocks(p, h, len(WIDTHS["discriminator"]) - 1, leaky, True, train)
    return dense(p, "head", h, True, train), probs


def classifier(p, x, train=True):
    """(logits, probabilities); ReLU between its blocks."""
    h = torch.relu(layer_norm(p, "norm", dense(p, "proj", x[:, :, None])))
    h, probs = _blocks(p, h, len(WIDTHS["classifier"]) - 1, torch.relu)
    return dense(p, "head", h), probs


def attention_entropy(probs: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Mean over rows, heads and queries of -sum p log(p + eps) -> [K]
    (`src/rain_gan.py:269-289`)."""
    return -(probs * torch.log(probs + eps)).sum(-1).flatten(1).mean(-1)
