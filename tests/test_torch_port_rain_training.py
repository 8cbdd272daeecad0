"""The port's RAIN-GAN training half against the JAX package's.

Built as `tests/test_torch_port_family.py` is: a JAX `RAIN_GAN` prepared
on the blob fixture (no fit), its critic's spectral u/v drawn and
power-iterated, its Adam moments drawn by numpy (count 3, |mu| < 2e-4,
nu in [1e-8, 1e-6]), carried into the port with `load_jax_state`. The D,
C and G steps run on both sides from that state on the same inputs
(batches, z and eps drawn on the JAX side from the step's own key
split): losses, every parameter, spectral u/v and Adam tensor agree at
rtol = atol = 1e-5, RAIN's network tolerance
(`tests/test_torch_port_rain_gan.py::test_network_matches_flax`). RAIN
has no dropout, so no keep-masks are fed.

Also here: the epoch's order of steps with absent classes; the chunk
hook (`_on_chunk_end`): its cadence in the base `fit`, RAIN's attention
history against the JAX package's (4 epochs at chunk 2 give 2 points of
1.0 per network, `tests/test_training_smoke.py:230-243`) and that it
changes no state; the downstream classifier warm-started from RAIN's
companion (which takes no generator and returns (logits, attention))
against the JAX `Classifier`'s batch step, and a 2-epoch pipeline with
that warm start; `load_jax_state`'s accounting of Adam leaves.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_family import _normal, _t, _tree, _warm_state
from test_torch_port_sngan_ctgan import (
    _assert_state_matches,
    power_iterated,
    run_pipeline,
    warm_start_step_matches_jax,
)

import cvaegan_tpu
import cvaegan_tpu_torch
from cvaegan_tpu_torch.core import config as tconfig
from cvaegan_tpu_torch.kernels import block_attention as tba

NET_TOL = dict(rtol=1e-5, atol=1e-5)
EPOCH = 350.0
CLASS_ID = 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def twins(blob_dataset):
    jt = cvaegan_tpu.RAIN_GAN(seed=0)
    jt.verbose = False
    jt._prepare(blob_dataset)
    state = power_iterated(_warm_state(jt, 30))
    jt.state = state
    jt._clear_gen_caches()
    return jt, state, _tree(state)


def _port(twins, blob_dataset):
    _, _, tree = twins
    port = cvaegan_tpu_torch.RAIN_GAN(seed=0, device="cpu")
    port._prepare((blob_dataset.tr_samples, blob_dataset.tr_labels))
    port.load_jax_state(tree)
    return port


@pytest.mark.parametrize("kind", "dcg")
def test_steps_match_jax(kind, twins, blob_dataset):
    jt, state, _ = twins
    port = _port(twins, blob_dataset)
    data = jt._data
    key = jax.random.PRNGKey(50 + "dcg".index(kind))
    if kind == "g":
        k_x, k_eps, k_z = jax.random.split(key, 3)
        x, y, eps, z = _t(*jt._sample_batch(k_x, data, CLASS_ID), _normal(jt, k_eps),
                          _normal(jt, k_z))
        jax_step = lambda s, k: jt._g_step(s, data, CLASS_ID, jnp.float32(EPOCH), k)  # noqa: E731
        lam = port._lambda_class(torch.tensor(EPOCH))
        run = lambda: port._g_step(x, y.long(), z, eps, lam)  # noqa: E731
    else:
        k_x, k_z = jax.random.split(key)
        x, y, z = _t(*jt._sample_batch(k_x, data, CLASS_ID), _normal(jt, k_z))
        step = jt._d_step if kind == "d" else jt._c_step
        jax_step = lambda s, k: step(s, data, CLASS_ID, k)  # noqa: E731
        run = lambda: (port._d_step if kind == "d" else port._c_step)(x, y.long(), z)  # noqa: E731
    new_state, want = jax.jit(jax_step)(state, key)
    before = (tba.LAUNCHES, tba.ENTROPY_LAUNCHES)
    got = run()
    assert (tba.LAUNCHES, tba.ENTROPY_LAUNCHES) == before
    if kind == "g":
        assert set(got) == set(want) == set(port.loss_keys)
        assert float(got["attention_loss"]) == 0.0  # singleton sequences
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **NET_TOL)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET_TOL)
    _assert_state_matches(port, new_state, **NET_TOL)


def _small_settings(epochs=1):
    settings = tconfig.Settings()
    settings.gan.batch_size = 8
    settings.gan.epochs = epochs
    settings.gan.d_loop_num, settings.gan.c_loop_num, settings.gan.g_loop_num = 2, 1, 2
    return settings


def _data(absent=None, n=60):
    rng = np.random.default_rng(0)
    x = rng.random((n, 12), dtype=np.float32)
    y = (np.arange(n) % 5).astype(np.int32)
    if absent is not None:
        y[y == absent] = 0
    return x, y


@pytest.mark.parametrize("absent", [None, 1])
def test_epoch_order(monkeypatch, absent):
    """D x d_loop_num, C x c_loop_num, G x g_loop_num per present class,
    in order; the history holds the last G step's five losses."""
    port = cvaegan_tpu_torch.RAIN_GAN(seed=0, device="cpu", settings=_small_settings())
    port.verbose = False
    port._prepare(_data(absent))
    calls, rounds = [], []
    for kind in "dcg":
        step = getattr(port, f"_{kind}_step")

        def wrapped(*args, _kind=kind, _step=step):
            out = _step(*args)
            calls.append((_kind, {k: float(v) for k, v in out.items()} if _kind == "g" else None))
            return out

        monkeypatch.setattr(port, f"_{kind}_step", wrapped)
    monkeypatch.setattr(port, "_sample_batch", lambda c, _f=port._sample_batch:
                        rounds.append(c) or _f(c))
    port._fit_prepared(1)
    present = [c for c in range(5) if c != absent]
    assert [c[0] for c in calls] == list("ddcgg") * len(present)
    assert sorted(set(rounds)) == present and rounds == sorted(rounds)
    assert port._steps_per_epoch() == len(calls)
    assert {k: v[0] for k, v in port.loss_history.items()} == calls[-1][1]
    assert all(np.isfinite(v) for v in calls[-1][1].values())


def test_chunk_hook_cadence(monkeypatch):
    """The base `fit` calls `_on_chunk_end(epochs_done)` after each chunk,
    as the JAX package does (`cvaegan_tpu/algorithms/base.py:337-342`),
    the last chunk short."""
    model = cvaegan_tpu_torch.CGAN(seed=0, device="cpu", settings=_small_settings(5))
    model.verbose = False
    model.epoch_chunk = 2
    seen = []
    monkeypatch.setattr(model, "_on_chunk_end", lambda e: seen.append(
        (e, len(model.loss_history["adv_loss"]))))
    model.fit(_data())
    assert seen == [(2, 2), (4, 4), (5, 5)]


def test_attention_history_matches_jax(twins, blob_dataset):
    """4 epochs at chunk 2: 2 points per network, each the JAX package's
    value (1.0: a softmax over one key); recording changes no state."""
    jt, state, _ = twins
    assert cvaegan_tpu_torch.RAIN_GAN.epoch_chunk == 50
    port = _port(twins, blob_dataset)
    jt.attention_history = {k: [] for k in jt.attention_history}
    jt._on_chunk_end(50)
    before = [t.clone() for t in port._static_tensors()]
    port._on_chunk_end(50)
    for a, b in zip(port._static_tensors(), before):
        assert torch.equal(a, b)
    assert port.attention_history.keys() == jt.attention_history.keys()
    for name in jt.attention_history:
        np.testing.assert_allclose(port.attention_history[name], jt.attention_history[name],
                                   rtol=1e-6, atol=1e-6, err_msg=name)

    settings = _small_settings(4)
    model = cvaegan_tpu_torch.RAIN_GAN(seed=0, device="cpu", settings=settings)
    model.verbose = False
    model.epoch_chunk = 2
    model.fit((blob_dataset.tr_samples[:100], blob_dataset.tr_labels[:100]))
    for name in ("encoder", "generator", "discriminator", "classifier"):
        assert len(model.attention_history[name]) == 2, name
        assert np.allclose(model.attention_history[name], 1.0), name
    assert all(len(v) == 4 for v in model.loss_history.values())


def test_plot_attention_history(tmp_path):
    pytest.importorskip("matplotlib")
    settings = tconfig.Settings()
    settings.paths = tconfig.Paths(root=tmp_path)
    model = cvaegan_tpu_torch.RAIN_GAN(seed=0, device="cpu", settings=settings)
    model._prepare(_data())
    assert model.plot_attention_history() is None
    model._on_chunk_end(50)
    out = model.plot_attention_history()
    assert out.exists() and out.name == "rain_gan_attention_history.jpg"


def test_warm_started_classifier_step_matches_jax(monkeypatch, twins, blob_dataset):
    """The downstream classifier warm-started from RAIN's companion: the
    forward takes no generator and returns (logits, attention)."""
    jt, state, _ = twins
    warm_start_step_matches_jax(monkeypatch, jt, state, _port(twins, blob_dataset),
                                **NET_TOL)


def test_pipeline_with_warm_start(tmp_path):
    result = run_pipeline(tmp_path, "rain_gan")
    assert set(result["model"].attention_history) == {
        "encoder", "generator", "discriminator", "classifier"}


def test_load_jax_state_accounts_for_adam_leaves(twins):
    _, state, tree = twins
    port = cvaegan_tpu_torch.RAIN_GAN(device="cpu")
    port.load_jax_state(tree)
    _assert_state_matches(port, state)
    assert int(port.optimizers["encoder"].count) == 3
    adam = copy.deepcopy(tree)
    del adam["encoder"]["opt_state"]["nu"]["ResidualAttentionBlock_0"]
    with pytest.raises(ValueError, match="nu"):
        port.load_jax_state(adam)
