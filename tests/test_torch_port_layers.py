"""Layers and networks of the PyTorch port against their Flax counterparts.

The same weights (drawn with numpy, carried across by
`cvaegan_tpu_torch.convert`) and the same inputs go through both; eval and
train forwards must agree at rtol 1e-5, atol 1e-6 in float32, and so must
the BatchNorm running statistics and the spectral u/v after a train
forward. Train-mode dropout draws different bits in the two frameworks,
so the port is fed the masks that Flax drew.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvaegan_tpu.models import layers as jl
from cvaegan_tpu.models import mlp as jm
from cvaegan_tpu_torch.convert import load_net, net_leaves
from cvaegan_tpu_torch.models import layers as tl
from cvaegan_tpu_torch.models import mlp as tm

TOL = dict(rtol=1e-5, atol=1e-6)
N = 48


@pytest.fixture(autouse=True)
def _float32_matmuls():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _randomize(variables, seed):
    """Replace every leaf of a Flax variable tree with numpy draws of the
    same shape, scaled so activations stay O(1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name == "kernel":
            return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.3 * rng.standard_normal(shape)).astype(np.float32)

    out = jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))
    _near_top_singular(out, rng)
    return out


def _normalize(v):
    return v / np.linalg.norm(v)


def _near_top_singular(variables, rng):
    """Set each spectral u/v near its kernel's top singular vectors, as
    training leaves them. Random u/v can make sigma = v^T K u cancel to
    near 0, which turns float32 rounding into large output errors."""

    def walk(spectral, params):
        if "u" in spectral:
            left, _, right = np.linalg.svd(params["kernel"])
            for name, top in (("v", left[:, 0]), ("u", right[0])):
                noise = _normalize(rng.standard_normal(top.shape))
                spectral[name] = _normalize(top + 0.5 * noise).astype(np.float32)
            return
        for key, sub in spectral.items():
            walk(sub, params[key])

    if "spectral" in variables:
        walk(variables["spectral"], variables["params"])


def _twin(jax_module, torch_module, *init_args, seed=0, **init_kwargs):
    """Flax variables drawn by `_randomize`, and the port module holding them."""
    variables = jax_module.init(jax.random.PRNGKey(seed), *init_args, **init_kwargs)
    variables = _randomize(variables, seed)
    load_net(torch_module, variables)
    return variables, torch_module


def _np(t):
    return t.detach().numpy()


def _assert_state(torch_module, variables):
    """Every port tensor equals its Flax leaf (kernels transposed)."""
    for path, (tensor, transposed) in net_leaves(torch_module).items():
        want = variables
        for key in path:
            want = want[key]
        want = np.asarray(want)
        np.testing.assert_allclose(_np(tensor), want.T if transposed else want,
                                   err_msg="/".join(path), **TOL)


def _inputs(seed, *shape):
    return np.random.default_rng(100 + seed).standard_normal(shape).astype(np.float32)


def _flax_masks(module, variables, *args, rng, mutable):
    """(outputs, new mutables, dropout keep-masks) of a Flax train forward."""
    out, state = module.apply(
        variables, *args, train=True, rngs={"dropout": rng},
        mutable=[*mutable, "intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout))
    state = dict(state)
    inter = state.pop("intermediates")
    masks = [np.asarray(inter[f"Dropout_{i}"]["__call__"][0]) != 0
             for i in range(len(inter))]
    return out, state, masks


def _feed_masks(monkeypatch, masks):
    it = iter(torch.from_numpy(m) for m in masks)
    monkeypatch.setattr(tl, "_keep_mask", lambda x, keep_prob, generator: next(it))


# ------------------------------------------------------------------- layers
def test_hidden_sizes_and_one_hot():
    for d in (1, 35, 133, 300, 700, 1025):
        for pin in (False, True):
            assert tl.hidden_sizes(d, pin) == tuple(jl.hidden_sizes(d, pin))
    labels = np.array([0, 3, 1, 4], np.int32)
    np.testing.assert_array_equal(
        _np(tl.one_hot(torch.from_numpy(labels), 5)),
        np.asarray(jl.one_hot(jnp.asarray(labels), 5)))


def test_dense():
    x = _inputs(0, N, 20)
    variables, port = _twin(jl.Dense(7), tl.Dense(20, 7), jnp.asarray(x))
    want = jl.Dense(7).apply(variables, x)
    np.testing.assert_allclose(_np(port(torch.from_numpy(x))), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm(train):
    x = 2.0 * _inputs(1, N, 16) + 0.5
    jmod = jl.BatchNorm()
    variables, port = _twin(jmod, tl.BatchNorm(16), jnp.asarray(x), train=False)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    if train:
        want, new = jmod.apply(variables, x, train=True, mutable=["batch_stats"])
        variables = {**variables, **new}
    else:
        want = jmod.apply(variables, x, train=False)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    _assert_state(port, variables)


@pytest.mark.parametrize("train", [False, True])
def test_spectral_dense(train):
    x = _inputs(2, N, 24)
    jmod = jl.SpectralDense(12)
    variables, port = _twin(jmod, tl.SpectralDense(24, 12), jnp.asarray(x))
    port.train(train)
    got = port(torch.from_numpy(x))
    want, new = jmod.apply(variables, x, update_stats=train, mutable=["spectral"])
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    _assert_state(port, {**variables, **new})


def test_layernorm():
    x = 3.0 * _inputs(3, N, 40) - 1.0
    jmod = fnn.LayerNorm(epsilon=1e-5)
    variables, port = _twin(jmod, tl.LayerNorm(40), jnp.asarray(x))
    np.testing.assert_allclose(_np(port(torch.from_numpy(x))),
                               np.asarray(jmod.apply(variables, x)), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_mlp_trunk(train):
    x = _inputs(4, N, 35)
    hidden = tl.hidden_sizes(35)
    jmod = jl.MLPTrunk(hidden)
    variables, port = _twin(jmod, tl.MLPTrunk(35, hidden), jnp.asarray(x), train=False)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    want, new = jmod.apply(variables, x, train=train, mutable=["batch_stats"])
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    _assert_state(port, {**variables, **new})


def test_dropout_masks_and_scaling():
    """The port's dropout draws from an explicit generator, keeps about
    1 - rate of the entries, scales them by 1 / (1 - rate), and is the
    identity in eval mode."""
    drop = tl.Dropout(0.3)
    x = torch.ones(200, 50)
    g = torch.Generator().manual_seed(0)
    y = drop(x, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.02
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert torch.equal(drop(x, torch.Generator().manual_seed(0)), y)
    drop.eval()
    assert torch.equal(drop(x, g), x)


# ----------------------------------------------------------------- networks
FEATURES, CLASSES, Z = 12, 3, 16


def _labels(n=N):
    return (np.arange(n) % CLASSES).astype(np.int32)


@pytest.mark.parametrize("train", [False, True])
def test_gaussian_encoder(train):
    x, y = _inputs(5, N, FEATURES), _labels()
    jmod = jm.GaussianEncoder(num_classes=CLASSES, latent_dim=Z)
    variables, port = _twin(jmod, tm.GaussianEncoder(FEATURES, CLASSES, latent_dim=Z),
                            jnp.asarray(x), jnp.asarray(y), train=False)
    port.train(train)
    with torch.no_grad():
        mu, log_var = port(torch.from_numpy(x), torch.from_numpy(y))
    (wmu, wlv), new = jmod.apply(variables, x, y, train=train, mutable=["batch_stats"])
    np.testing.assert_allclose(_np(mu), np.asarray(wmu), **TOL)
    np.testing.assert_allclose(_np(log_var), np.asarray(wlv), **TOL)
    _assert_state(port, {**variables, **new})


def test_reparameterize():
    mu = torch.from_numpy(_inputs(6, N, Z))
    log_var = torch.from_numpy(0.5 * _inputs(7, N, Z))
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    z = tm.reparameterize(mu, log_var, g1)
    eps = torch.randn(mu.shape, generator=g2)
    torch.testing.assert_close(z, mu + eps * torch.exp(0.5 * log_var))


@pytest.mark.parametrize("activation,spectral", [
    ("sigmoid", False), ("tanh", False), (None, False), ("sigmoid", True)])
@pytest.mark.parametrize("train", [False, True])
def test_generator(activation, spectral, train):
    z, y = _inputs(8, N, Z), _labels()
    jmod = jm.Generator(output_dim=FEATURES, num_classes=CLASSES,
                        out_activation=activation, spectral=spectral)
    port = tm.Generator(Z, FEATURES, num_classes=CLASSES,
                        out_activation=activation, spectral=spectral)
    variables, port = _twin(jmod, port, jnp.asarray(z), jnp.asarray(y), train=False)
    port.train(train)
    with torch.no_grad():
        x, hidden = port(torch.from_numpy(z), torch.from_numpy(y))
    mutable = ["spectral"] if spectral else ["batch_stats"]
    (wx, wh), new = jmod.apply(variables, z, y, train=train, mutable=mutable)
    np.testing.assert_allclose(_np(x), np.asarray(wx), **TOL)
    np.testing.assert_allclose(_np(hidden), np.asarray(wh), **TOL)
    _assert_state(port, {**variables, **new})


@pytest.mark.parametrize("spectral", [True, False])
@pytest.mark.parametrize("with_labels", [True, False])
@pytest.mark.parametrize("train", [False, True])
def test_discriminator(spectral, with_labels, train, monkeypatch):
    x, y = _inputs(9, N, FEATURES), _labels()
    jmod = jm.Discriminator(num_classes=CLASSES, spectral=spectral)
    variables, port = _twin(jmod, tm.Discriminator(FEATURES, CLASSES, spectral=spectral),
                            jnp.asarray(x), jnp.asarray(y), train=False)
    labels = y if with_labels else None
    if train:
        (ws, wh), new, masks = _flax_masks(
            jmod, variables, x, labels, rng=jax.random.PRNGKey(1),
            mutable=["spectral"] if spectral else [])
        assert len(masks) == 2
        _feed_masks(monkeypatch, masks)
        variables = {**variables, **new}
    else:
        ws, wh = jmod.apply(variables, x, labels, train=False)
    port.train(train)
    with torch.no_grad():
        score, hidden = port(torch.from_numpy(x),
                             None if labels is None else torch.from_numpy(labels))
    np.testing.assert_allclose(_np(score), np.asarray(ws), **TOL)
    np.testing.assert_allclose(_np(hidden), np.asarray(wh), **TOL)
    _assert_state(port, variables)


@pytest.mark.parametrize("spectral", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_classifier(spectral, train, monkeypatch):
    x = _inputs(10, N, FEATURES)
    jmod = jm.Classifier(num_classes=CLASSES, spectral=spectral)
    variables, port = _twin(jmod, tm.Classifier(FEATURES, CLASSES, spectral=spectral),
                            jnp.asarray(x), train=False)
    if train:
        want, new, masks = _flax_masks(jmod, variables, x, rng=jax.random.PRNGKey(2),
                                       mutable=["spectral"] if spectral else [])
        assert len(masks) == 2
        _feed_masks(monkeypatch, masks)
        variables = {**variables, **new}
    else:
        want = jmod.apply(variables, x, train=False)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    _assert_state(port, variables)
