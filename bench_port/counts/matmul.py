"""Matmul FLOPs of a network's passes, counted once: 2 M K N per product,
whatever precision or number of passes an implementation takes.

A network is a list of layers: `("dense", n_in, n_out, spectral, first)`
(`first`: it reads the network's input). Only matmuls are counted: normalisation, activations,
losses and the optimizer are left out, so a share of a peak made from
these counts reads low, never high.

- forward over `rows` rows: 2 rows n_in n_out per dense layer; in train
  mode a spectral layer adds its power iteration's three matrix-vector
  products, 6 n_in n_out.
- backward: the weight gradient (2 rows n_in n_out) where the network is
  stepped, the input gradient (the same) of every layer but the first,
  and of the first too where the network's input needs a gradient.
"""

from __future__ import annotations


def forward(net, rows: int, train: bool = False) -> int:
    total = 0
    for _, n_in, n_out, spectral, _ in net:
        total += 2 * rows * n_in * n_out
        if spectral and train:
            total += 6 * n_in * n_out
    return total


def backward(net, rows: int, weights: bool, input_grad: bool) -> int:
    total = 0
    for _, n_in, n_out, _, first in net:
        product = 2 * rows * n_in * n_out
        if weights:
            total += product
        if input_grad or not first:
            total += product
    return total


def hidden(d: int, pin: bool = False):
    """The reference's hidden-size rule: max(256, d), max(128, d // 2),
    max(64, d // 4), or 64 where pinned."""
    return max(256, d), max(128, d // 2), 64 if pin else max(64, d // 4)


def mlp(dims, spectral: bool = False):
    return [("dense", dims[i], dims[i + 1], spectral, i == 0) for i in range(len(dims) - 1)]


def strict_steps(nets: dict, batch: int) -> dict:
    """FLOPs of one step of each kind of the CVAE-GAN family's strict
    round (`src/cvae_gan.py:100-216`): D on concat(real, fake), C on
    concat(real, fake), E+G through D and C."""
    e, g, d, c = nets["encoder"], nets["generator"], nets["discriminator"], nets["classifier"]
    b = batch
    return {
        "d": forward(g, b, True) + forward(d, 2 * b, True) + backward(d, 2 * b, True, False),
        "c": forward(g, b, True) + forward(c, 2 * b, True) + backward(c, 2 * b, True, False),
        "g": (forward(e, b, True) + 2 * forward(g, b, True) + forward(d, b, True)
              + forward(c, b, True)
              + backward(d, b, False, True) + backward(c, b, False, True)
              + backward(g, b, True, True) + backward(g, b, True, False)
              + backward(e, b, True, False)),
    }


def epoch(cfg: dict, steps: dict) -> int:
    """FLOPs of one strict epoch over every class: per class d_loop_num D,
    c_loop_num C and g_loop_num E+G steps."""
    return cfg["label_num"] * (cfg["d_loop_num"] * steps["d"] + cfg["c_loop_num"] * steps["c"]
                               + cfg["g_loop_num"] * steps["g"])
