"""The port's CVAE-GAN training half against the JAX package's.

Adam: 1 and 3 steps against `optax.adam` with both beta pairs.

Steps: a JAX `CVAEGAN` is built on the blob fixture and trained one D, one
C and one G step, so that BatchNorm statistics and spectral u/v are off
their initial values; its Adam moments are then replaced by numpy draws
(count 3, |mu| ~ 1e-4, nu in [1e-8, 1e-6]), and the state, Adam state
included, is carried into the port with `load_jax_state`. The moments are
drawn because some gradients are exactly 0 in exact arithmetic (a bias or
a constant one-hot column before BatchNorm, the critic's output bias
under the Wasserstein loss) and carry float32 rounding noise of ~1e-10 in
either package; from the near-zero nu of a real first step, Adam divides
that noise by its eps of 1e-8, so the two packages' updates of exactly
those elements differ by up to ~lr whatever either computes (measured:
those elements alone, up to 3.2e-4 apart). With nu >= 1e-8 the noise
moves a parameter by ~lr 1e-6. Then each of the D, C
and G steps runs on both sides from that state, on the same x_real, y, z
and eps (drawn on the JAX side from the step's own key split) and the
same dropout keep-masks (served from a numpy queue to Flax's
`jax.random.bernoulli` and to the port's `_keep_mask`). Losses, every
parameter, BatchNorm statistics, u/v and the Adam state must agree at
rtol 1e-5, atol 1e-6.

The epoch: its order of steps by call counting, absent classes, the loss
pick, balanced mode and the classifier EMA; then short fits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cvaegan_tpu import CVAEGAN as JaxCVAEGAN
from cvaegan_tpu_torch import CVAEGAN
from cvaegan_tpu_torch.convert import net_leaves
from cvaegan_tpu_torch.core import config as tconfig
from cvaegan_tpu_torch.core.schedules import progressive_lambda
from cvaegan_tpu_torch.core.state import Adam
from cvaegan_tpu_torch.models import layers as tl

TOL = dict(rtol=1e-5, atol=1e-6)
ADAM_TOL = dict(rtol=1e-6, atol=1e-7)
EPOCH = 350.0  # inside the lambda_class ramp


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# --------------------------------------------------------------------- Adam
@pytest.mark.parametrize("betas", [(0.5, 0.999), (0.9, 0.999)])
@pytest.mark.parametrize("steps", [1, 3])
def test_adam_matches_optax(betas, steps):
    rng = np.random.default_rng(steps)
    params = [rng.standard_normal((7, 4)).astype(np.float32),
              rng.standard_normal(5).astype(np.float32)]
    tx = optax.adam(2e-4, b1=betas[0], b2=betas[1])
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.tensor(p) for p in params]
    opt = Adam(tp, 2e-4, *betas)
    for _ in range(steps):
        grads = [rng.standard_normal(p.shape).astype(np.float32) for p in params]
        updates, opt_state = tx.update([jnp.asarray(g) for g in grads], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.from_numpy(g) for g in grads])
    adam_state = opt_state[0]
    assert int(opt.count) == int(adam_state.count) == steps
    for got, want in ((tp, jp), (opt.m, adam_state.mu), (opt.v, adam_state.nu)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **ADAM_TOL)


# -------------------------------------------------------------------- steps
def _tree(state):
    """A JAX trainer state as plain nested numpy dicts, Adam state included."""
    tree = {}
    for name, ns in state.items():
        adam_state = ns.opt_state[0]
        tree[name] = jax.device_get({
            "params": ns.params, **ns.mutables,
            "opt_state": {"count": adam_state.count, "mu": adam_state.mu,
                          "nu": adam_state.nu}})
    return tree


def _lookup(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _assert_state_matches(port, jstate, nets=("encoder", "generator",
                                              "discriminator", "classifier")):
    tree = _tree(jstate)
    for name in nets:
        net, opt = port.state[name], port.optimizers[name]
        slot = {id(p): i for i, p in enumerate(opt.params)}
        for path, (tensor, transposed) in net_leaves(net).items():
            want = _lookup(tree[name], path)
            want = want.T if transposed else want
            where = f"{name}/{'/'.join(path)}"
            np.testing.assert_allclose(tensor.detach().numpy(), want,
                                       err_msg=where, **TOL)
            if path[0] == "params":
                for moment, got in (("mu", opt.m), ("nu", opt.v)):
                    m = _lookup(tree[name]["opt_state"][moment], path[1:])
                    np.testing.assert_allclose(
                        got[slot[id(tensor)]].numpy(), m.T if transposed else m,
                        err_msg=f"{where} Adam {moment}", **TOL)
        assert int(opt.count) == int(tree[name]["opt_state"]["count"]), name


@pytest.fixture(scope="module")
def warm(blob_dataset):
    """A JAX trainer after one D, one C and one G step, and its state tree."""
    jt = JaxCVAEGAN(seed=0)
    jt.verbose = False
    jt._prepare(blob_dataset)
    data = jt._data
    state = jt.state
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    state, _ = jax.jit(lambda s, k: jt._d_step(s, data, 1, k))(state, keys[0])
    state, _ = jax.jit(lambda s, k: jt._c_step(s, data, 1, k))(state, keys[1])
    state, _ = jax.jit(lambda s, k: jt._g_step(s, data, 1, jnp.float32(EPOCH), k))(
        state, keys[2])
    rng = np.random.default_rng(5)

    def draw(low, high, signed):
        def leaf(x):
            mag = rng.uniform(low, high, np.shape(x))
            sign = rng.choice([-1.0, 1.0], np.shape(x)) if signed else 1.0
            return jnp.asarray(sign * mag, jnp.float32)
        return leaf

    for name, ns in state.items():
        adam_state, *rest = ns.opt_state
        adam_state = adam_state._replace(
            count=jnp.int32(3), mu=jax.tree.map(draw(0.0, 2e-4, True), adam_state.mu),
            nu=jax.tree.map(draw(1e-8, 1e-6, False), adam_state.nu))
        state[name] = ns.replace(opt_state=(adam_state, *rest))
    return jt, state, _tree(state)


@pytest.fixture
def masks(monkeypatch):
    """Serve the same dropout keep-masks to Flax and to the port: each
    `jax.random.bernoulli` call Flax's Dropout makes draws a numpy mask,
    which the port's `_keep_mask` then takes in the same order."""
    rng = np.random.default_rng(11)
    queue = []

    def bernoulli(key, p=0.5, shape=None):
        mask = rng.random(shape) < p
        queue.append(mask)
        return jnp.asarray(mask)

    def keep_mask(x, keep_prob, generator):
        mask = queue.pop(0)
        assert mask.shape == tuple(x.shape)
        return torch.from_numpy(mask)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    monkeypatch.setattr(tl, "_keep_mask", keep_mask)
    return queue


def _port(warm, blob_dataset):
    port = CVAEGAN(seed=0, device="cpu")
    port._prepare((blob_dataset.tr_samples, blob_dataset.tr_labels))
    port.load_jax_state(warm[2])
    return port


def _d_inputs(jt, class_id, key):
    k_x, k_z, _, _ = jax.random.split(key, 4)
    x_real, y = jt._sample_batch(k_x, jt._data, class_id)
    z = jax.random.normal(k_z, (jt.gan_cfg.batch_size, jt.gan_cfg.z_size))
    return [torch.from_numpy(np.array(a)) for a in (x_real, y, z)]


@pytest.mark.parametrize("kind", ["d", "c"])
def test_d_and_c_steps_match_jax(kind, warm, masks, blob_dataset):
    jt, state, _ = warm
    port = _port(warm, blob_dataset)
    key, class_id = jax.random.PRNGKey(21), 3
    step = jt._d_step if kind == "d" else jt._c_step
    new_state, loss = jax.jit(lambda s, k: step(s, jt._data, class_id, k))(state, key)
    x_real, y, z = _d_inputs(jt, class_id, key)
    got = (port._d_step if kind == "d" else port._c_step)(x_real, y.long(), z)
    assert not masks
    np.testing.assert_allclose(got.numpy(), np.asarray(loss), **TOL)
    _assert_state_matches(port, new_state)


def test_g_step_matches_jax(warm, masks, blob_dataset):
    jt, state, _ = warm
    port = _port(warm, blob_dataset)
    key, class_id = jax.random.PRNGKey(22), 2
    new_state, losses = jax.jit(
        lambda s, k: jt._g_step(s, jt._data, class_id, jnp.float32(EPOCH), k))(state, key)
    k_x, k_eps, k_z, _, _ = jax.random.split(key, 5)
    cfg = jt.gan_cfg
    x_real, y = jt._sample_batch(k_x, jt._data, class_id)
    z_prior = jax.random.normal(k_z, (cfg.batch_size, cfg.z_size))
    eps = jax.random.normal(k_eps, (cfg.batch_size, cfg.z_size))
    t = [torch.from_numpy(np.array(a)) for a in (x_real, y, z_prior, eps)]
    got = port._g_step(t[0], t[1].long(), t[2], t[3],
                       progressive_lambda(torch.tensor(EPOCH), 0.5, 200, 500))
    assert not masks
    for k in port.loss_keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(losses[k]), err_msg=k, **TOL)
    _assert_state_matches(port, new_state)


def test_state_tree_round_trip(warm, blob_dataset):
    """The converted port state, Adam state included, equals the tree."""
    port = _port(warm, blob_dataset)
    _assert_state_matches(port, warm[1])


def test_feature_importance_matches_jax(warm, blob_dataset):
    jt, state, _ = warm
    port = _port(warm, blob_dataset)
    jt.state = state
    for net in ("discriminator", "encoder", "generator", "classifier"):
        want, got = jt.get_feature_importance(net), port.get_feature_importance(net)
        if net == "classifier":
            want, got = [want], [got]
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, np.asarray(w), err_msg=net, **TOL)
    with pytest.raises(KeyError):
        port.get_feature_importance("critic")


# -------------------------------------------------------------------- epoch
def _small_settings(tmp_path=None, epochs=1):
    settings = tconfig.Settings()
    settings.gan.batch_size = 16
    settings.gan.epochs = epochs
    if tmp_path is not None:
        settings.paths = tconfig.Paths(root=tmp_path)
    return settings


def _data(absent=()):
    rng = np.random.default_rng(0)
    labels = np.arange(100) % 5
    keep = ~np.isin(labels, absent)
    x = rng.random((100, 12), dtype=np.float32)[keep]
    return x, labels[keep].astype(np.int32)


def _record_steps(monkeypatch, trainer):
    """Wrap the three steps so each call is logged as (kind, labels)."""
    calls = []
    for kind in ("d", "c", "g"):
        step = getattr(trainer, f"_{kind}_step")

        def wrapped(x_real, y, *rest, _kind=kind, _step=step):
            calls.append((_kind, y.tolist()))
            out = _step(x_real, y, *rest)
            if _kind == "g":
                calls[-1] += ({k: float(v) for k, v in out.items()},)
            return out

        monkeypatch.setattr(trainer, f"_{kind}_step", wrapped)
    return calls


@pytest.mark.parametrize("absent", [(), (3,), (0, 4)])
def test_epoch_order_and_absent_classes(monkeypatch, absent):
    """D x5, C x5, G x3 for each present class in order, none for an absent
    one; the recorded losses are the last G step's."""
    x, y = _data(absent)
    port = CVAEGAN(seed=0, device="cpu", settings=_small_settings())
    port.verbose = False
    port._prepare((x, y))
    calls = _record_steps(monkeypatch, port)
    port._fit_prepared(1)
    present = [c for c in range(5) if c not in absent]
    assert [c[0] for c in calls] == (["d"] * 5 + ["c"] * 5 + ["g"] * 3) * len(present)
    assert [c[1][0] for c in calls] == [c for c in present for _ in range(13)]
    assert all(len(set(c[1])) == 1 for c in calls)
    last = calls[-1][2]
    assert [port.loss_history[k][0] for k in port.loss_keys] == [last[k] for k in port.loss_keys]


def test_balanced_mode_runs_one_mixed_round(monkeypatch):
    x, y = _data((3,))
    port = CVAEGAN(seed=0, device="cpu", settings=_small_settings(), balanced_mode=True)
    port.verbose = False
    port._prepare((x, y))
    calls = _record_steps(monkeypatch, port)
    port._fit_prepared(1)
    assert [c[0] for c in calls] == ["d"] * 5 + ["c"] * 5 + ["g"] * 3
    drawn = {label for c in calls for label in c[1]}
    assert 3 not in drawn and len(drawn) > 1


def test_classifier_ema_update():
    x, y = _data()
    port = CVAEGAN(seed=0, device="cpu", settings=_small_settings(), ema_filter=True)
    port.verbose = False
    port._prepare((x, y))
    with torch.no_grad():
        for p in port.state["classifier_ema"].parameters():
            p.add_(0.01)
    before = [p.detach().clone() for p in port.state["classifier_ema"].parameters()]
    port._fit_prepared(1)
    d = port.ema_decay
    for e0, e, p in zip(before, port.state["classifier_ema"].parameters(),
                        port.state["classifier"].parameters()):
        np.testing.assert_allclose(e.detach().numpy(), (d * e0 + (1 - d) * p).detach().numpy(),
                                   **ADAM_TOL)


def test_short_fit_on_blobs(tmp_path):
    from cvaegan_tpu_torch.data.tabular import TabularDataset

    ds = TabularDataset.synthetic_blobs(seed=0)
    port = CVAEGAN(seed=0, device="cpu", settings=_small_settings(tmp_path, epochs=2))
    port.verbose = False
    port.fit(ds)
    assert set(port.loss_history) == set(port.loss_keys)
    for k, v in port.loss_history.items():
        assert len(v) == 2 and np.isfinite(v).all(), k
    port.fit(ds)  # a second fit appends
    assert all(len(v) == 4 for v in port.loss_history.values())
    assert abs(port.loss_history["class_loss"][0] - np.log(5)) < 0.3
    out = port.plot_loss_history()
    assert out.exists()


def test_unported_options_raise():
    port = CVAEGAN(seed=0, device="cpu", settings=_small_settings())
    port.checkpoint_dir = "ckpt"
    with pytest.raises(NotImplementedError, match="A19"):
        port.fit(_data())
    with pytest.raises(NotImplementedError, match="A18"):
        port.fit_streamed("x.csv", "y.csv")
