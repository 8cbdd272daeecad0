"""Counts of RAIN-GAN, the residual-attention CVAE-GAN, on the Car-Hacking
schema (`src/models/rain_gan_models.py`): every network an input
projection, a stack of pre-LN residual self-attention blocks at the
published widths, and its heads; the critic's projection, feed-forward,
shortcut and head spectral-normed, its attention projections plain.

Matmul FLOPs, counted once, as `matmul.py` counts them: every dense
product (Q, K, V and O included) and the spectral power iteration's by
`matmul.forward` and `matmul.backward`. Besides, each block's two
attention contractions over a singleton sequence, QK^T and PV: 2 d
FLOPs a row each forward (d the block's width, over its heads), and in a
backward that passes through the block both operands' gradients of each,
8 d a row, whether it steps the network's weights or only carries the
input's gradient (q, k and v are activations). LayerNorm, the softmax,
activations, losses and the optimizer hold no matmul and are left out.
"""

from bench_port.counts import matmul


def _block(d_in: int, d_out: int, spectral: bool):
    attention = [("dense", d_in, d_in, False, False)] * 4
    ff = [("dense", d_in, d_out, spectral, False), ("dense", d_out, d_out, spectral, False)]
    shortcut = [("dense", d_in, d_out, spectral, False)] if d_in != d_out else []
    return attention + ff + shortcut


def _network(n_in: int, widths, head_out, spectral: bool = False):
    """(dense layers, the blocks' widths) of a projection to widths[0],
    the blocks between the widths, and a head of each width in
    `head_out` on the last."""
    dense = [("dense", n_in, widths[0], spectral, True)]
    for a, b in zip(widths, widths[1:]):
        dense += _block(a, b, spectral)
    dense += [("dense", widths[-1], n, spectral, False) for n in head_out]
    return dense, list(widths[:-1])


def networks(cfg: dict) -> dict:
    f, c, z = cfg["feature_num"], cfg["label_num"], cfg["z_size"]
    return {
        "encoder": _network(f + c, cfg["encoder_widths"], [z, z]),
        "generator": _network(z + c, cfg["generator_widths"], [f]),
        "discriminator": _network(f + c, cfg["discriminator_widths"], [1], spectral=True),
        "classifier": _network(f, cfg["classifier_widths"], [c]),
    }


def forward(net, rows: int, train: bool = False) -> int:
    dense, blocks = net
    return matmul.forward(dense, rows, train) + sum(4 * rows * d for d in blocks)


def backward(net, rows: int, weights: bool, input_grad: bool) -> int:
    dense, blocks = net
    return matmul.backward(dense, rows, weights, input_grad) + sum(8 * rows * d for d in blocks)


def step_flops(cfg: dict) -> dict:
    """FLOPs of one D, C and E+G step of one replica, in the order of
    `matmul.strict_steps`: D and C on concat(real, fake), E+G through D
    and C, the generator run on z_enc and on the prior z."""
    n = networks(cfg)
    e, g, d, c = n["encoder"], n["generator"], n["discriminator"], n["classifier"]
    b = cfg["batch_size"]
    return {
        "d": forward(g, b, True) + forward(d, 2 * b, True) + backward(d, 2 * b, True, False),
        "c": forward(g, b, True) + forward(c, 2 * b, True) + backward(c, 2 * b, True, False),
        "g": (forward(e, b, True) + 2 * forward(g, b, True) + forward(d, b, True)
              + forward(c, b, True)
              + backward(d, b, False, True) + backward(c, b, False, True)
              + backward(g, b, True, True) + backward(g, b, True, False)
              + backward(e, b, True, False)),
    }


def epoch_flops(cfg: dict) -> int:
    """FLOPs of one strict epoch of one replica (every class present)."""
    return matmul.epoch(cfg, step_flops(cfg))
