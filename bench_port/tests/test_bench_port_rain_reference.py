"""The plain RAIN-GAN reference (`reference/rain_nets.py`,
`reference/rain_train.py`) against the port's eager forwards and one step
of each kind, at a tiny size on the CPU: in float32 at the tolerances of
the CVAE-GAN's tests, and in float64 on both sides, where the two agree to
1e-10, so that a gap the comparison reads on the card is the program's
rounding or its fault, never two computations. At a sequence of one the
softmax is over one key: the Q and K projections get exactly no gradient
in either. The reference imports nothing of the port or of JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_port.data import car_hacking
from bench_port.harness import program, spec, weights
from bench_port.reference import rain_nets, rain_train

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEED = 2**31 + 13
CLASS = 3
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _cfg():
    cfg = dict(spec.load_json(spec.BENCH / "configs" / "raingan-carhacking.json"))
    cfg["batch_size"] = 16
    return cfg


def _trainer(cfg, n=4000):
    from cvaegan_tpu_torch import RAIN_GAN

    x, y = car_hacking.frames(n, SEED)
    layout = rain_nets.layout(cfg)
    leaves = weights.make(layout, [SEED], CPU)
    t = RAIN_GAN(seed=SEED, settings=program.settings(cfg, SEED), device=CPU)
    t.verbose = False
    t._prepare((x, y))
    program.check_trainer(t, cfg, layout)
    program.load_leaves(t, leaves, 0)
    return t, leaves, (x, y)


def _float64_port(t, monkeypatch):
    """The port's trainer in float64: networks, Adam moments, data and
    draws, and the losses' float32 cast taken out."""
    from cvaegan_tpu_torch.core import losses

    monkeypatch.setattr(losses, "_f32", lambda *xs: xs[0] if len(xs) == 1 else xs)
    t.state.double()
    for opt in t.optimizers.values():
        opt.m, opt.v = [m.double() for m in opt.m], [v.double() for v in opt.v]
    t._data = {k: v.double() if isinstance(v, torch.Tensor) and v.is_floating_point() else v
               for k, v in t._data.items()}
    normal = t._normal
    t._normal = lambda shape: normal(shape).double()


class _Draws64(rain_train.Draws):
    def normal(self, shape):
        return super().normal(shape).double()


def _one_step(kind, monkeypatch=None):
    """One D, C or E+G step on class 3 from the same leaves and generator
    seed in the port and the reference (float64 on both sides where
    `monkeypatch` is given): (the port's Adam first moments, the
    reference's trainer)."""
    cfg = _cfg()
    t, leaves, (x, y) = _trainer(cfg)
    x = torch.as_tensor(x)
    if monkeypatch is not None:
        _float64_port(t, monkeypatch)
        leaves = {net: {k: v.double() for k, v in ls.items()} for net, ls in leaves.items()}
        x = x.double()
    t._epoch_t.fill_(0)
    try:
        t._round(CLASS, t._epoch_t, {"d": 0, "c": 0, "g": 0, kind: 1})
    except UnboundLocalError:  # a round without a G step has no losses to return
        pass
    got = program.adam_moments([t])
    data = rain_train.Data([x], [torch.as_tensor(y)], cfg["label_num"])
    draws = (_Draws64 if monkeypatch is not None else rain_train.Draws)([SEED], CPU)
    tr = rain_train.Trainer(cfg, leaves, data, draws)
    bs, zs = cfg["batch_size"], cfg["z_size"]
    xb, yb = data.batch(tr.draws, CLASS, bs)
    if kind == "d":
        tr.d_step(xb, yb, tr.draws.normal((bs, zs)))
    elif kind == "c":
        tr.c_step(xb, yb, tr.draws.normal((bs, zs)))
    else:
        zp = tr.draws.normal((bs, zs))
        tr.g_step(xb, yb, zp, tr.draws.normal((bs, zs)), 0.0)
    return got, tr


def test_eval_forwards():
    cfg = _cfg()
    t, leaves, _ = _trainer(cfg)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.random((9, cfg["feature_num"]), dtype=np.float32))
    z = torch.tensor(rng.standard_normal((9, cfg["z_size"]), dtype=np.float32))
    y = torch.tensor(rng.integers(0, cfg["label_num"], 9))
    p = {net: {k: v.clone() for k, v in ls.items()} for net, ls in leaves.items()}
    c, s = cfg["label_num"], t.state
    with torch.no_grad():
        for net in s.values():
            net.eval()
        (mu, lv), e_attn = s["encoder"](x, y)
        (r_mu, r_lv), r_e = rain_nets.encoder(p["encoder"], x[None], y[None], c, train=False)
        pairs = [(mu, r_mu[0]), (lv, r_lv[0]), (e_attn, r_e[0])]
        for got, want in (
                (s["generator"](z, y), rain_nets.generator(p["generator"], z[None], y[None], c,
                                                           train=False)),
                (s["discriminator"](x, y), rain_nets.discriminator(
                    p["discriminator"], x[None], y[None], c, train=False)),
                (s["classifier"](x), rain_nets.classifier(p["classifier"], x[None],
                                                          train=False))):
            pairs += [(got[0], want[0][0]), (got[1], want[1][0])]
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["d", "c", "g"])
def test_one_step_of_each_kind(kind):
    """Every Adam first moment the step writes agrees, but where the
    reference's moment is nought to rounding, to 1e-3 of the moment's norm,
    as the CVAE-GAN's steps do."""
    got, tr = _one_step(kind)
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
    assert compared >= 20


@pytest.mark.parametrize("kind", ["d", "c", "g"])
def test_one_step_in_float64(kind, monkeypatch):
    """The same step in float64 on both sides: every leaf's first moment
    within 1e-10 of the reference's, by its norm."""
    got, tr = _one_step(kind, monkeypatch)
    compared = 0
    for net, o in tr.opt.items():
        for k, want in o.m.items():
            assert got[net][k].dtype == want.dtype == torch.float64
            norm = float(want.norm())
            if norm == 0.0:
                assert float(got[net][k].norm()) == 0.0, f"{net}.{k}"
                continue
            rel = float((got[net][k] - want).norm()) / norm
            assert rel < 1e-10, f"{net}.{k}: {rel}"
            compared += 1
    assert compared >= 20


@pytest.mark.parametrize("kind", ["d", "c", "g"])
def test_query_and_key_get_no_gradient(kind):
    """At a sequence of one the softmax is over one key: the Q and K
    projections' first moments stay exactly 0 in the port and in the
    reference, and V's and O's do not."""
    got, tr = _one_step(kind)
    stepped = {"d": ["discriminator"], "c": ["classifier"], "g": ["encoder", "generator"]}[kind]
    seen = 0
    for net in stepped:
        for k, want in tr.opt[net].m.items():
            if ".attention.query." in k or ".attention.key." in k:
                assert not bool(want.any()) and not bool(got[net][k].any()), f"{net}.{k}"
                seen += 1
            elif ".attention.value.weight" in k or ".attention.out.weight" in k:
                assert bool(want.any()) and bool(got[net][k].any()), f"{net}.{k}"
    assert seen >= 8


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, {root!r}); "
            "import bench_port.reference.rain_nets, bench_port.reference.rain_train; "
            "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "cvaegan_tpu", "cvaegan_tpu_torch"}, top
