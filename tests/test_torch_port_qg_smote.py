"""The port's QG-SMOTE against the JAX package's.

Built as `tests/test_torch_port_sngan_ctgan.py` is: a JAX trainer is
prepared on the blob fixture (no fit), its BatchNorm statistics and
spectral u/v are moved off their initial values (u/v then power-iterated)
and its Adam moments drawn by numpy (count 3, |mu| < 2e-4, nu in [1e-8,
1e-6]), and the state, Adam state included, is carried into the port with
`load_jax_state`. Each D, C, quantile-regressor and E+G step then runs on
both sides from that state, on the same inputs (drawn on the JAX side from
the step's own key split: batches, the interpolation alpha, z) and the
same dropout keep-masks: losses, every parameter, BatchNorm statistic,
spectral u/v and Adam tensor agree at rtol 1e-5, atol 1e-6.

Also here: `sample_from_quantiles` (JAX's alpha, and alpha at 0, 0.5 and 1,
where alpha (nq - 1) is an integer), the encoder's and regressor's
forwards, the epoch's order of steps with and without an absent class, a
balanced-mode epoch, quantile and prior generation, qualified generation's
filter and patience, `analyze_quantiles`, `generate_samples_fast` against
the plain prior path, `load_jax_state`'s accounting of every leaf, the
downstream classifier's warm-started step and a 2-epoch pipeline.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_family import (  # noqa: F401  (masks is a fixture)
    TOL,
    _lookup,
    _normal,
    _t,
    _tree,
    _warm_state,
    masks,
)
from test_torch_port_sngan_ctgan import (
    _assert_state_matches,
    _replayed_masks,
    power_iterated,
    run_pipeline,
    warm_start_step_matches_jax,
)

import cvaegan_tpu
import cvaegan_tpu_torch
from cvaegan_tpu.core.state import apply_eval as jax_apply_eval
from cvaegan_tpu.models import quantile as jquantile
from cvaegan_tpu_torch.convert import net_leaves
from cvaegan_tpu_torch.core import config as tconfig
from cvaegan_tpu_torch.models import quantile as tquantile
from cvaegan_tpu_torch.pipelines import balance as tbalance

#: the E+G step: the JAX package's float32 step lies up to ~7x rtol 1e-5,
#: atol 1e-6 from a float64 run in the encoder's first layer, where the
#: port's lies within it (`test_g_step_against_float64`)
G_TOL = dict(rtol=1e-5, atol=1e-5)
EPOCH = 350.0  # inside the lambda_class ramp
CLASS_ID = 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


_JAX = {}


def jax_twin(blob_dataset):
    """(JAX QG-SMOTE, its warm state, the state as numpy trees), built once."""
    if not _JAX:
        jt = cvaegan_tpu.QG_SMOTE(seed=0)
        jt.verbose = False
        jt._prepare(blob_dataset)
        state = power_iterated(_warm_state(jt, 30))
        jt.state = state
        jt._clear_gen_caches()
        _JAX["twin"] = (jt, state, _tree(state))
    return _JAX["twin"]


def port_twin(blob_dataset):
    _, _, tree = jax_twin(blob_dataset)
    port = cvaegan_tpu_torch.QG_SMOTE(seed=0, device="cpu")
    port._prepare((blob_dataset.tr_samples, blob_dataset.tr_labels))
    port.load_jax_state(tree)
    return port


# ------------------------------------------------------------ quantiles
def _quantiles(rows=64, latent=16, nq=3, seed=0):
    return np.random.default_rng(seed).standard_normal((rows, latent, nq)).astype(np.float32)


@pytest.mark.parametrize("alpha", ["jax", "grid"])
def test_sample_from_quantiles_matches_jax(monkeypatch, alpha):
    """JAX's own alpha draw, and alpha at 0, 0.5 and 1 (alpha 2 lands on
    the quantile indices 0, 1 and 2: floor = ceil), fed to the JAX
    function through its uniform draw."""
    q = _quantiles()
    key = jax.random.PRNGKey(5)
    if alpha == "jax":
        a = np.array(jax.random.uniform(key, (q.shape[0], 1)))
    else:
        a = np.resize(np.array([0.0, 0.5, 1.0], np.float32), (q.shape[0], 1))
        monkeypatch.setattr(jax.random, "uniform", lambda k, shape: jnp.asarray(a))
    want = np.asarray(jquantile.sample_from_quantiles(key, jnp.asarray(q)))
    got = tquantile.sample_from_quantiles(torch.from_numpy(q), torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if alpha == "grid":
        picked = np.round(a[:, 0] * 2).astype(int)
        np.testing.assert_array_equal(got.numpy(), q[np.arange(len(q)), :, picked])


def _forward(jt, state, port, name, train, x, y):
    """(the JAX forward's output and new mutables, the port's output)."""
    module, ns = jt.modules[name], state[name]
    net = port.state[name].train(train)
    variables = {"params": ns.params, **ns.mutables}
    if train:
        out, mut = module.apply(variables, jnp.asarray(x), jnp.asarray(y), train=True,
                                rngs={"dropout": jax.random.PRNGKey(1)},
                                mutable=list(ns.mutables))
        args = (torch.from_numpy(x), torch.from_numpy(y).long())
        got = net(*args) if name == "encoder" else net(*args, port.generator)
        return np.asarray(out), jax.device_get(dict(mut)), got
    want = jax_apply_eval(module, ns, jnp.asarray(x), jnp.asarray(y))
    return np.asarray(want), None, net(torch.from_numpy(x), torch.from_numpy(y).long())


@pytest.mark.parametrize("name", ["encoder", "regressor"])
@pytest.mark.parametrize("train", [True, False])
def test_networks_match_jax(name, train, masks, blob_dataset):  # noqa: F811
    """The quantile encoder's `[b, latent, nq]` and the regressor's `[b,
    features, nq]` outputs in train mode (batch statistics, dropout; the
    encoder's running statistics updated) and eval mode."""
    jt, state, _ = jax_twin(blob_dataset)
    port = port_twin(blob_dataset)
    x = blob_dataset.tr_samples[:96]
    y = blob_dataset.tr_labels[:96]
    with torch.no_grad():
        want, mut, got = _forward(jt, state, port, name, train, x, y)
    assert not masks
    assert got.shape == want.shape == ((96, 128, 3) if name == "encoder" else (96, 30, 3))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for path, (tensor, _) in net_leaves(port.state[name]).items():
        if path[0] == "batch_stats":
            want_stat = _lookup(mut, path) if mut else _lookup(_tree(state)[name], path)
            np.testing.assert_allclose(tensor.numpy(), want_stat, err_msg="/".join(path),
                                       **TOL)


# ---------------------------------------------------------------- steps
def _steps(kind, jt, port, key):
    """(the JAX step as a function of (state, key), the port's step on the
    same inputs as a thunk)."""
    data = jt._data
    bs = jt.gan_cfg.batch_size
    if kind in "dc":
        k_x, k_q, _ = jax.random.split(key, 3)
        x, y, alpha = _t(*jt._sample_batch(k_x, data, CLASS_ID),
                         jax.random.uniform(k_q, (bs, 1)))
        step = jt._d_step if kind == "d" else jt._c_step
        port_step = port._d_step if kind == "d" else port._c_step
        return (lambda s, k: step(s, data, CLASS_ID, k),
                lambda: port_step(x, y.long(), port._quantile_z(x, y.long(), alpha)))
    if kind == "q":
        k_x, _ = jax.random.split(key)
        x, y = _t(*jt._sample_batch(k_x, data, CLASS_ID))
        return (lambda s, k: jt._qr_step(s, data, CLASS_ID, k),
                lambda: port._qr_step(x, y.long()))
    k_x, k_q, k_z, _, _ = jax.random.split(key, 5)
    x, y, alpha, z = _t(*jt._sample_batch(k_x, data, CLASS_ID),
                        jax.random.uniform(k_q, (bs, 1)), _normal(jt, k_z))
    lam = port._lambda_class(torch.tensor(EPOCH))
    return (lambda s, k: jt._g_step(s, data, CLASS_ID, jnp.float32(EPOCH), k),
            lambda: port._g_step(x, y.long(), alpha, z, lam))


@pytest.mark.parametrize("kind", "dcqg")
def test_steps_match_jax(kind, masks, blob_dataset):  # noqa: F811
    """Each step from the same state: its losses, then every parameter,
    BatchNorm statistic (the encoder's and generator's, committed by the
    D and C steps' no-grad forward and chained through the E+G step's two
    generator forwards), spectral u/v and Adam tensor."""
    jt, state, _ = jax_twin(blob_dataset)
    port = port_twin(blob_dataset)
    key = jax.random.PRNGKey(50 + "dcqg".index(kind))
    jax_step, port_step = _steps(kind, jt, port, key)
    new_state, want = jax.jit(jax_step)(state, key)
    got = port_step()
    assert not masks
    if isinstance(want, dict):
        assert set(got) == set(want) == {"recon_loss", "adv_loss", "class_loss"}
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_state_matches(port, new_state, **(G_TOL if kind == "g" else TOL))


def errors_over_tol(trainer, reference, tol=TOL):
    """The worst |a - b| / (atol + rtol |b|) over every tensor a trainer's
    epoch updates (parameters, buffers, Adam moments and counts),
    `reference` a port trainer of the same networks."""
    worst = 0.0
    for a, b in zip(trainer._static_tensors(), reference._static_tensors()):
        a, b = a.detach().double(), b.detach().double()
        worst = max(worst, float(((a - b).abs() / (tol["atol"] + tol["rtol"] * b.abs())).max()))
    return worst


def assert_as_exact_as(trainer, other, exact, tol):
    """`trainer`'s step is as exact as `other`'s: for every tensor the step
    updates, its largest |error| from the float64 run `exact` is within
    `tol` of that tensor's scale (atol + rtol max|exact|) or no more than
    twice `other`'s largest |error| on the same tensor. Per tensor, not per
    element: both float32 steps scatter rounding of the same size over a
    tensor, and an element-wise ratio reads whichever small element it
    happens to land on (ROADMAP C3)."""
    for a, o, r in zip(trainer._static_tensors(), other._static_tensors(),
                       exact._static_tensors()):
        a, o, r = a.detach().double(), o.detach().double(), r.detach().double()
        err, theirs = float((a - r).abs().max()), float((o - r).abs().max())
        limit = max(tol["atol"] + tol["rtol"] * float(r.abs().max()), 2.0 * theirs)
        assert err <= limit, (tuple(r.shape), err, theirs, limit)


def float64_runs(monkeypatch, module, make_port, make_steps, state, key):
    """One step run three ways from the same state, inputs and dropout
    masks: the port in float32, the port in float64 (its networks, Adam
    moments, inputs and losses), and the JAX package in float32, whose new
    state is carried into a third port trainer. `make_steps(port)` gives
    (the JAX step, the port's step) as `_steps` does, reading its inputs
    through `module`'s `_t`. Returns (float32, float64, from JAX)."""
    from cvaegan_tpu_torch.core import losses as tlosses

    replay = _replayed_masks(monkeypatch)
    f32, f64 = make_port(), make_port()
    jax_step, run32 = make_steps(f32)
    new_state, _ = jax.jit(jax_step)(state, key)
    replay()
    run32()
    from_jax = make_port()
    from_jax.load_jax_state(_tree(new_state))

    f64.state.double()
    for opt in f64.optimizers.values():
        opt.m, opt.v = [m.double() for m in opt.m], [v.double() for v in opt.v]
    monkeypatch.setattr(tlosses, "_f32", lambda *xs: xs[0] if len(xs) == 1 else xs)
    monkeypatch.setattr(f"{module}._t", lambda *arrays: [
        torch.from_numpy(np.array(a, np.float64 if np.asarray(a).dtype.kind == "f" else None))
        for a in arrays])
    _, run64 = make_steps(f64)
    replay()
    run64()
    return f32, f64, from_jax


def test_g_step_against_float64(monkeypatch, blob_dataset):
    """Why the E+G step is held at G_TOL: the raw blob rows have means near
    10 and a class's batch a spread near 1, so the encoder's first-layer
    gradient x^T dh carries mean(x) sum(dh), exactly 0 in exact arithmetic
    (BatchNorm follows the layer) and float32 rounding in practice. The
    port's float32 step lies within rtol 1e-5, atol 1e-6 of the same step
    in float64 (the port's code in float64: the JAX step's semantics, as
    every other tensor's float32 agreement shows); the JAX package's
    float32 step does not, and lies within G_TOL."""
    jt, state, _ = jax_twin(blob_dataset)
    key = jax.random.PRNGKey(53)
    f32, f64, from_jax = float64_runs(
        monkeypatch, "test_torch_port_qg_smote", lambda: port_twin(blob_dataset),
        lambda port: _steps("g", jt, port, key), state, key)
    port_err, jax_err = errors_over_tol(f32, f64), errors_over_tol(from_jax, f64)
    assert port_err <= 1.0, port_err
    assert jax_err > 1.0, jax_err
    assert errors_over_tol(from_jax, f64, G_TOL) <= 1.0, jax_err


# ---------------------------------------------------------------- epoch
def _small_settings(epochs=1, batch_size=16):
    settings = tconfig.Settings()
    settings.gan.batch_size = batch_size
    settings.gan.epochs = epochs
    settings.gan.d_loop_num, settings.gan.c_loop_num, settings.gan.g_loop_num = 2, 3, 2
    return settings


def _small_data(absent=None, features=12, rows=100):
    rng = np.random.default_rng(0)
    x = rng.random((rows, features), dtype=np.float32)
    y = (np.arange(rows) % 5).astype(np.int32)
    if absent is not None:
        y[y == absent] = 0
    return x, y


@pytest.mark.parametrize("absent", [None, 2])
def test_epoch_order(monkeypatch, absent):
    """Per present class in order: D x d_loop_num, C x c_loop_num, one
    regressor step, E+G x g_loop_num; the history holds the last round's
    regressor loss and last E+G step's losses."""
    port = cvaegan_tpu_torch.QG_SMOTE(seed=0, device="cpu", settings=_small_settings())
    port.verbose = False
    port._prepare(_small_data(absent))
    calls = []
    for kind, attr in (("d", "_d_step"), ("c", "_c_step"), ("q", "_qr_step"),
                       ("g", "_g_step")):
        step = getattr(port, attr)

        def wrapped(*args, _kind=kind, _step=step):
            out = _step(*args)
            calls.append((_kind, {k: float(v) for k, v in out.items()}
                          if isinstance(out, dict) else float(out)))
            return out

        monkeypatch.setattr(port, attr, wrapped)
    rounds = []
    monkeypatch.setattr(port, "_sample_batch", lambda c, _f=port._sample_batch:
                        rounds.append(c) or _f(c))
    port._fit_prepared(1)
    present = [c for c in range(5) if c != absent]
    assert [c[0] for c in calls] == (["d"] * 2 + ["c"] * 3 + ["q"] + ["g"] * 2) * len(present)
    assert sorted(set(rounds)) == present and rounds == sorted(rounds)
    assert port._steps_per_epoch() == len(calls) == 8 * len(present)
    last_q = [c[1] for c in calls if c[0] == "q"][-1]
    want = {"quantile_loss": last_q, **calls[-1][1]}
    assert {k: v[0] for k, v in port.loss_history.items()} == want
    assert set(want) == set(port.loss_keys)


def test_balanced_mode_epoch():
    """One mixed round of D, C, one regressor step and E+G, on
    class-balanced batches: 14 steps at the default loop counts."""
    settings = tconfig.Settings()
    settings.gan.batch_size, settings.gan.epochs = 16, 2
    port = cvaegan_tpu_torch.QG_SMOTE(seed=0, device="cpu", settings=settings,
                                      balanced_mode=True)
    port.verbose = False
    port.fit(_small_data())
    assert port._class_rounds() == [None] and port._steps_per_epoch() == 14
    for v in port.loss_history.values():
        assert len(v) == 2 and np.isfinite(v).all()


# ----------------------------------------------------------- generation
def test_generation_shapes_and_filter(blob_dataset):
    port = port_twin(blob_dataset)
    for method in ("quantile", "prior"):
        out = port.generate_samples(3, 37, method=method)
        assert out.shape == (37, 30) and out.dtype == np.float32
        assert np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0
    assert port.generate_samples(3, 5).shape == (5, 30)  # quantile by default
    for method in ("quantile", "prior"):
        q = port.generate_qualified_samples(1, 40, confidence_threshold=0.0, method=method)
        assert q.shape[1] == 30 and len(q) <= 40
        if len(q):
            logits = port._classifier_logits(port.state, torch.from_numpy(q))
            assert (logits.argmax(-1) == 1).all()
    with pytest.raises(NotImplementedError, match="encoder"):
        port.reconstruct_samples(blob_dataset.te_samples[:4], blob_dataset.te_labels[:4])


def test_quantile_latents_match_jax(blob_dataset):
    """The quantile path's z: the class's real rows cycled in table order,
    encoded in eval mode, interpolated at alpha; the JAX package's z from
    its own key, and the port's at that key's alpha."""
    jt, state, _ = jax_twin(blob_dataset)
    port = port_twin(blob_dataset)
    num = 2 * int(np.sum(blob_dataset.tr_labels == 4)) + 3  # wraps around the class
    key = jax.random.PRNGKey(9)
    jt._next_key = lambda: key
    want = np.asarray(jt._quantile_latents(4, num))
    alpha = torch.from_numpy(np.array(jax.random.uniform(key, (num, 1))))
    port._alpha = lambda rows: alpha
    got = port._quantile_latents(4, num)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_qualified_quantile_gives_up_after_20_empty_batches(monkeypatch, blob_dataset):
    """Candidate batches of max(256, min(4096, 2 num)) rows; a threshold no
    softmax exceeds spends the budget of 20 empty batches."""
    port = port_twin(blob_dataset)
    sizes = []
    real = port._quantile_latents
    monkeypatch.setattr(port, "_quantile_latents",
                        lambda c, n: sizes.append(n) or real(c, n))
    out = port.generate_qualified_samples(0, 300, confidence_threshold=1.0)
    assert out.shape == (0, 30) and sizes == [600] * 20
    sizes.clear()
    port.generate_qualified_samples(0, 10, confidence_threshold=1.0)
    assert sizes == [256] * 20


def test_analyze_quantiles_matches_jax(blob_dataset):
    jt, state, _ = jax_twin(blob_dataset)
    port = port_twin(blob_dataset)
    for label, n in ((0, 100), (4, 7)):
        want, got = jt.analyze_quantiles(label, n), port.analyze_quantiles(label, n)
        assert set(got) == set(want) == {"mean", "std", "min", "max"}
        for k in want:
            assert got[k].shape == (128, 3)
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_fast_path_matches_plain_prior_path(blob_dataset):
    """`generate_samples_fast` (on the CPU the fused kernel's plain
    version, eval BatchNorm folded in) against `generate_samples(method=
    'prior')` from the same generator state: the same z."""
    port = port_twin(blob_dataset)
    rng_state = port.generator.get_state()
    fast = port.generate_samples_fast(2, 300)
    port.generator.set_state(rng_state)
    plain = port.generate_samples(2, 300, method="prior")
    np.testing.assert_allclose(fast, plain, **TOL)


# ------------------------------------------------------------ the trees
def test_load_jax_state_accounts_for_every_leaf(blob_dataset):
    _, state, tree = jax_twin(blob_dataset)
    port = cvaegan_tpu_torch.QG_SMOTE(device="cpu")
    port.load_jax_state(tree)
    assert (port.feature_num, port.label_num) == (30, 5)
    assert set(port.optimizers) == set(port.state.keys())
    _assert_state_matches(port, state)
    counted = sum(len(net_leaves(net)) for net in port.state.values())
    leaves = sum(len(jax.tree_util.tree_leaves(
        {k: v for k, v in t.items() if k != "opt_state"})) for t in tree.values())
    assert counted == leaves
    missing = copy.deepcopy(tree)
    del missing["encoder"]["batch_stats"]["MLPTrunk_0"]["BatchNorm_2"]
    with pytest.raises(ValueError, match="missing"):
        port.load_jax_state(missing)
    extra = copy.deepcopy(tree)
    extra["regressor"]["params"]["Dense_3"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="no place"):
        port.load_jax_state(extra)


# --------------------------------------------------- downstream warm start
def test_warm_started_classifier_step_matches_jax(monkeypatch, blob_dataset):
    jt, state, _ = jax_twin(blob_dataset)
    warm_start_step_matches_jax(monkeypatch, jt, state, port_twin(blob_dataset))


def test_pipeline_with_warm_start(tmp_path):
    result = run_pipeline(tmp_path, "qg_smote")
    assert set(result["gen_stats"]) == set(range(5))
    args = tbalance.make_cli("port").parse_args(["--model", "qg_smote"])
    assert tbalance.TRAINERS[args.model] == ("QG_SMOTE", "QG_SMOTE", "qualified")
