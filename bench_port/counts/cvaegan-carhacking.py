"""Counts of the CVAE-GAN on the Car-Hacking schema
(`src/models/cvae_gan_models.py`): every network an MLP of the reference's
hidden-size rule; the critic spectral-normed with its last hidden width
pinned to 64, as the classifier's."""

from bench_port.counts import matmul


def networks(cfg: dict) -> dict:
    f, c, z = cfg["feature_num"], cfg["label_num"], cfg["z_size"]
    he, hg = matmul.hidden(f + c), matmul.hidden(z + c)
    return {
        "encoder": matmul.mlp([f + c, *he]) + [("dense", he[-1], z, False, False),
                                               ("dense", he[-1], z, False, False)],
        "generator": matmul.mlp([z + c, *hg, f]),
        "discriminator": matmul.mlp([f + c, *matmul.hidden(f + c, pin=True), 1], spectral=True),
        "classifier": matmul.mlp([f, *matmul.hidden(f, pin=True), c]),
    }


def step_flops(cfg: dict) -> dict:
    """FLOPs of one D, C and E+G step of one replica."""
    return matmul.strict_steps(networks(cfg), cfg["batch_size"])


def epoch_flops(cfg: dict) -> int:
    """FLOPs of one strict epoch of one replica (every class present)."""
    return matmul.epoch(cfg, step_flops(cfg))


def generator_forward(cfg: dict, rows: int):
    """(FLOPs, bytes) of the eval-mode generator at `rows` rows, BatchNorm
    folded into its layers: the latents and one-hot labels read once, the
    four layers' weights and biases read once, the rows written once, in
    float32."""
    f, c, z = cfg["feature_num"], cfg["label_num"], cfg["z_size"]
    dims = [z + c, *matmul.hidden(z + c), f]
    flops = matmul.forward(matmul.mlp(dims), rows)
    params = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(4))
    return flops, 4 * (rows * (z + c) + params + rows * f)
