"""The FLOP and byte counts against hand counts."""

import pytest

from bench_port.harness import spec

CFG = {"feature_num": 10, "label_num": 5, "z_size": 128, "batch_size": 128,
       "d_loop_num": 5, "c_loop_num": 5, "g_loop_num": 3}


def counts(config):
    return spec.load_module(spec.BENCH / "counts" / f"{config}.py", f"counts_{config}")


def mm(rows, *dims):
    return sum(2 * rows * a * b for a, b in zip(dims, dims[1:]))


def test_cvaegan_steps_by_hand():
    b = 128
    enc = (15, 256, 128, 64)          # trunk of the encoder, then two heads 64 -> 128
    gen = (133, 256, 128, 64, 10)
    dis = (15, 256, 128, 64, 1)
    clf = (10, 256, 128, 64, 5)

    def fwd_enc(rows):
        return mm(rows, *enc) + 2 * mm(rows, 64, 128)

    def first(dims, rows):
        return 2 * rows * dims[0] * dims[1]

    spectral = 6 * sum(a * c for a, c in zip(dis, dis[1:]))
    d = mm(b, *gen) + mm(2 * b, *dis) + spectral + 2 * mm(2 * b, *dis) - first(dis, 2 * b)
    c = mm(b, *gen) + mm(2 * b, *clf) + 2 * mm(2 * b, *clf) - first(clf, 2 * b)
    g = (fwd_enc(b) + 2 * mm(b, *gen) + mm(b, *dis) + spectral + mm(b, *clf)
         + mm(b, *dis) + mm(b, *clf)                        # input gradients through D, C
         + 2 * mm(b, *gen)                                  # G on z_enc: weights and inputs
         + 2 * mm(b, *gen) - first(gen, b)                  # G on the prior z
         + 2 * fwd_enc(b) - first(enc, b))                  # E: weights, inputs past the first
    got = counts("cvaegan-carhacking").step_flops(CFG)
    assert got == {"d": d, "c": c, "g": g}
    assert counts("cvaegan-carhacking").epoch_flops(CFG) == 5 * (5 * d + 5 * c + 3 * g)


def test_generator_forward_by_hand():
    rows = 833_753
    flops, nbytes = counts("cvaegan-carhacking").generator_forward(CFG, rows)
    assert flops == mm(rows, 133, 256, 128, 64, 10)
    params = 133 * 256 + 256 + 256 * 128 + 128 + 128 * 64 + 64 + 64 * 10 + 10
    assert nbytes == 4 * (rows * 133 + params + rows * 10)


@pytest.mark.parametrize("config", ["cvaegan-carhacking"])
def test_counts_are_positive(config):
    steps = counts(config).step_flops(CFG)
    assert all(v > 0 for v in steps.values())
