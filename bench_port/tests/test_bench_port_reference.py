"""The plain reference against the port's eager forwards and one step of
each kind, at a tiny size on the CPU. The reference is held to the
program here, once, so that a fault found on the card by the comparison
is the program's; the reference itself imports nothing of the port."""

import numpy as np
import pytest
import torch

from bench_port.data import car_hacking
from bench_port.harness import program, spec, weights
from bench_port.reference import nets
from bench_port.reference import train as ref_train

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEED = 2**31 + 11


def _cell(config):
    cfg = dict(spec.load_json(spec.BENCH / "configs" / f"{config}.json"))
    cfg["batch_size"] = 16
    return cfg


def _trainer(cfg, n=4000):
    x, y = car_hacking.frames(n, SEED)
    leaves = weights.make(nets.layout(cfg), [SEED], CPU)
    t = program.trainer_class(cfg)(seed=SEED, settings=program.settings(cfg, SEED), device=CPU)
    t.verbose = False
    t._prepare((x, y))
    program.check_trainer(t, cfg, nets.layout(cfg))
    program.load_leaves(t, leaves, 0)
    return t, leaves, (x, y)


@pytest.mark.parametrize("config", ["cvaegan-carhacking"])
def test_eval_forwards(config):
    cfg = _cell(config)
    t, leaves, _ = _trainer(cfg)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.random((9, cfg["feature_num"]), dtype=np.float32))
    z = torch.tensor(rng.standard_normal((9, cfg["z_size"]), dtype=np.float32))
    y = torch.tensor(rng.integers(0, cfg["label_num"], 9))
    p = {net: {k: v.clone() for k, v in ls.items()} for net, ls in leaves.items()}
    c = cfg["label_num"]
    s = t.state
    with torch.no_grad():
        for net in s.values():
            net.eval()
        pairs = [
            (s["encoder"](x, y)[0], nets.cvae_encoder(p["encoder"], x[None], y[None], c,
                                                      train=False)[0][0]),
            (s["generator"](z, y)[0], nets.cvae_generator(p["generator"], z[None], y[None], c,
                                                          train=False)[0]),
            (s["discriminator"](x, y)[0], nets.cvae_discriminator(
                p["discriminator"], x[None], y[None], c, None, train=False)[0]),
            (s["classifier"](x), nets.cvae_classifier(p["classifier"], x[None], None,
                                                      train=False)[0]),
        ]
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("config", ["cvaegan-carhacking"])
@pytest.mark.parametrize("kind", ["d", "c", "g"])
def test_one_step_of_each_kind(config, kind):
    """One D, C or E+G step on class 3 from the same weights and generator
    seed: every Adam first moment the step writes agrees, but where the
    reference's gradient is nought to rounding (`harness/compare.py`), to
    1e-3 of the moment's norm: a class whose rows vary in one feature (gear)
    gives BatchNorm a small variance that magnifies rounding to ~1e-4."""
    cfg = _cell(config)
    t, leaves, (x, y) = _trainer(cfg)
    counts = {"d": 0, "c": 0, "g": 0, kind: 1}
    t._epoch_t.fill_(0)
    try:
        t._round(3, t._epoch_t, counts)
    except UnboundLocalError:  # a round without a G step has no losses to return
        pass
    got = program.adam_moments([t])
    data = ref_train.Data([torch.as_tensor(x)], [torch.as_tensor(y)], cfg["label_num"])
    tr = ref_train.Trainer(cfg, leaves, data, ref_train.Draws([SEED], CPU))
    bs, zs = cfg["batch_size"], cfg["z_size"]
    xb, yb = data.batch(tr.draws, 3, bs)
    if kind == "d":
        tr.d_step(xb, yb, tr.draws.normal((bs, zs)))
    elif kind == "c":
        tr.c_step(xb, yb, tr.draws.normal((bs, zs)))
    else:
        zp = tr.draws.normal((bs, zs))
        tr.g_step(xb, yb, zp, tr.draws.normal((bs, zs)), 0.0)
    rms = [float(m.square().mean().sqrt()) for o in tr.opt.values() for m in o.m.values()
           if m.norm() > 0]
    floor = 1e-3 * float(np.median(rms))
    compared = 0
    for net, o in tr.opt.items():
        for k, want in o.m.items():
            keep = want.abs() >= floor
            if not bool(keep.any()):
                continue
            rel = float(((got[net][k] - want) * keep).norm() / (want * keep).norm())
            assert rel < 1e-3, f"{net}.{k}: {rel}"
            compared += 1
    assert compared >= 6


def test_prior_rows_of_the_fast_path():
    """`generate_samples_fast` (on the CPU, the fused kernel's plain version
    over the folded BatchNorm) against the reference's prior rows, call
    after call from one generator seed, with drawn BatchNorm statistics."""
    from bench_port.reference import generate

    cfg = _cell("cvaegan-carhacking")
    x, y = car_hacking.frames(4000, SEED)
    leaves = weights.make(nets.layout(cfg), [SEED], CPU, drawn_stats=True)
    t = program.trainer_class(cfg)(seed=SEED, settings=program.settings(cfg, SEED), device=CPU)
    t._prepare((x, y))
    program.load_leaves(t, leaves, 0)
    calls = [(1, 300), (4, 257), (2, 300)]
    got = {i: t.generate_samples_fast(c, n) for i, (c, n) in enumerate(calls)}
    want = generate.replay(cfg, leaves["generator"], SEED, calls, got, CPU)
    for i in got:
        np.testing.assert_allclose(got[i], want[i].numpy(), rtol=0, atol=2e-6)
