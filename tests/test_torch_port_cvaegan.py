"""The port's CVAE-GAN serving slice against the JAX package's CVAEGAN.

A JAX CVAEGAN is built by `_prepare(blob_dataset)` (no fit), its
BatchNorm statistics and spectral vectors are moved off their initial
values by train-mode forwards, and its state is carried into the port
with `load_jax_state`. Deterministic forwards must then agree at rtol
1e-5, atol 1e-6; sampling draws from different RNG streams, so sampled
outputs are compared by their per-feature means, within 5 standard
errors of the difference of two independent means.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvaegan_tpu import CVAEGAN as JaxCVAEGAN
from cvaegan_tpu.core.state import apply_eval as jax_apply_eval
from cvaegan_tpu_torch import CVAEGAN
from cvaegan_tpu_torch.convert import state_from_jax
from cvaegan_tpu_torch.core import config as tconfig
from cvaegan_tpu_torch.core.state import apply_eval
from cvaegan_tpu_torch.data.tabular import TabularDataset
from cvaegan_tpu_torch.models import mlp as tm

TOL = dict(rtol=1e-5, atol=1e-6)
DRAWS = 8192
SIGMAS = 5.0


@pytest.fixture(scope="module")
def twins(blob_dataset):
    jt = JaxCVAEGAN(seed=0)
    jt.verbose = False
    jt._prepare(blob_dataset)
    rng = np.random.default_rng(0)
    state = dict(jt.state)
    z = (2.0 * rng.standard_normal((256, jt.gan_cfg.z_size))).astype(np.float32)
    x = blob_dataset.tr_samples[:256]
    y = blob_dataset.tr_labels[:256]
    for name, args, mutable in (("generator", (z, y), ["batch_stats"]),
                                ("encoder", (x, y), ["batch_stats"]),
                                ("discriminator", (x, y), ["spectral"])):
        ns = state[name]
        _, mut = jt.modules[name].apply(
            {"params": ns.params, **ns.mutables}, *args, train=True,
            rngs={"dropout": jax.random.PRNGKey(1)}, mutable=mutable)
        state[name] = ns.replace(mutables={**ns.mutables, **mut})
    jt.state = state
    jt._clear_gen_caches()
    tree = {name: jax.device_get({"params": ns.params, **ns.mutables})
            for name, ns in state.items()}
    port = CVAEGAN(seed=0, device="cpu")
    port.load_jax_state(tree)
    return jt, port, tree


def _batch(seed, n, z_size=128, classes=5):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, z_size)).astype(np.float32)
    return z, (np.arange(n) % classes).astype(np.int32)


def _same_means(a, b):
    """Per-feature means of two independent sample sets agree within
    SIGMAS standard errors of their difference."""
    se = np.sqrt(a.var(0, ddof=1) / len(a) + b.var(0, ddof=1) / len(b))
    gap = np.abs(a.mean(0) - b.mean(0))
    assert (gap <= SIGMAS * se + 1e-7).all(), (gap / np.maximum(se, 1e-12)).max()


def test_load_jax_state_sets_shapes(twins, blob_dataset):
    _, port, _ = twins
    assert (port.feature_num, port.label_num) == (30, 5)
    assert port.state["generator"].trunk.dense[0].weight.shape == (256, 133)


def test_prepare_takes_a_dataset_or_a_tuple(blob_dataset):
    ds = TabularDataset(blob_dataset.tr_samples, blob_dataset.tr_labels,
                        blob_dataset.te_samples, blob_dataset.te_labels)
    port = CVAEGAN(device="cpu")
    port._prepare(ds)
    assert (port.feature_num, port.label_num) == (30, 5)
    np.testing.assert_array_equal(port._data["labels"].numpy(), blob_dataset.tr_labels)
    with pytest.raises(TypeError, match="tuple"):
        CVAEGAN(device="cpu")._prepare([blob_dataset.tr_samples, blob_dataset.tr_labels])


def test_prepare_builds_the_jax_shapes(twins, blob_dataset):
    """`_prepare` builds the four networks with the JAX package's shapes,
    so a JAX state fills them leaf for leaf."""
    _, _, tree = twins
    fresh = CVAEGAN(seed=1, device="cpu")
    fresh._prepare((blob_dataset.tr_samples, blob_dataset.tr_labels))
    state_from_jax(tree, fresh.state)


def test_generator_forward(twins):
    jt, port, _ = twins
    z, y = _batch(1, 200)
    want = jt._generator_forward(jt.state, jnp.asarray(z), jnp.asarray(y), None)
    got = port._generator_forward(port.state, torch.from_numpy(z), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_classifier_logits(twins, blob_dataset):
    jt, port, _ = twins
    x = blob_dataset.te_samples
    want = jt._classifier_logits(jt.state, jnp.asarray(x))
    got = port._classifier_logits(port.state, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encoder(twins, blob_dataset):
    jt, port, _ = twins
    x, y = blob_dataset.te_samples, blob_dataset.te_labels
    wmu, wlv = jax_apply_eval(jt.modules["encoder"], jt.state["encoder"], x, y)
    mu, log_var = apply_eval(port.state["encoder"], torch.from_numpy(x),
                             torch.from_numpy(y))
    np.testing.assert_allclose(mu.numpy(), np.asarray(wmu), **TOL)
    np.testing.assert_allclose(log_var.numpy(), np.asarray(wlv), **TOL)


@pytest.mark.parametrize("label", [0, 3])
def test_generate_samples_distribution(twins, label):
    jt, port, _ = twins
    want = jt.generate_samples(label, DRAWS)
    got = port.generate_samples(label, DRAWS)
    fast = port.generate_samples_fast(label, DRAWS)
    for s in (got, fast):
        assert s.shape == (DRAWS, 30) and s.dtype == np.float32
        assert np.isfinite(s).all() and s.min() >= 0.0 and s.max() <= 1.0
        _same_means(s, want)


def test_reconstruct_samples_distribution(twins, blob_dataset):
    jt, port, _ = twins
    x, y = blob_dataset.tr_samples, blob_dataset.tr_labels
    want = jt.reconstruct_samples(x, y)
    got = port.reconstruct_samples(x, y)
    assert got.shape == want.shape and got.dtype == np.float32
    _same_means(got, want)


def _count_batches(port, monkeypatch):
    sizes = []
    forward = port._generator_forward

    def counting(state, z, labels):
        sizes.append(z.shape[0])
        return forward(state, z, labels)

    monkeypatch.setattr(port, "_generator_forward", counting)
    return sizes


@pytest.mark.parametrize("num,cand", [(100, 256), (300, 512), (600, 1024)])
def test_qualified_gives_up_after_20_empty_batches(twins, monkeypatch, num, cand):
    _, port, _ = twins
    sizes = _count_batches(port, monkeypatch)
    out = port.generate_qualified_samples(2, num, confidence_threshold=1.0)
    assert out.shape == (0, 30)
    assert sizes == [cand] * 20


def test_qualified_patience_is_never_refunded(twins, monkeypatch):
    """Batches alternate between no valid row and one valid row: the
    budget of 20 runs out at the 20th empty batch, after 19 kept rows."""
    _, port, _ = twins
    sizes = _count_batches(port, monkeypatch)
    target = 1

    def logits(state, x):
        out = torch.zeros(x.shape[0], port.label_num)
        if len(sizes) % 2 == 0:
            out[0, target] = 10.0
        return out

    monkeypatch.setattr(port, "_classifier_logits", logits)
    out = port.generate_qualified_samples(target, 1000)
    assert len(sizes) == 39
    assert out.shape == (19, 30)


def test_qualified_rows_pass_the_filter(twins):
    _, port, _ = twins
    total = 0
    for target in range(port.label_num):
        out = port.generate_qualified_samples(target, 64, confidence_threshold=0.0)
        assert out.shape[1] == 30 and len(out) <= 64
        if len(out):
            logits = port._classifier_logits(port.state, torch.from_numpy(out))
            assert (logits.argmax(-1) == target).all()
        total += len(out)
    assert total > 0
    assert port.generate_qualified_samples(0, 0).shape == (0, 30)
    assert port.generate_qualified_samples(0, -3).shape == (0, 30)


def test_fast_path_needs_the_standard_generator(twins):
    _, port, _ = twins
    other = copy.deepcopy(port)
    other.state["generator"] = tm.Generator(128, 30, num_classes=5, spectral=True)
    with pytest.raises(NotImplementedError, match="cvae_gan"):
        other.generate_samples_fast(0, 4)


def test_load_jax_state_accounts_for_every_leaf(twins):
    _, _, tree = twins
    port = CVAEGAN(device="cpu")
    missing = copy.deepcopy(tree)
    del missing["generator"]["batch_stats"]["MLPTrunk_0"]["BatchNorm_1"]
    with pytest.raises(ValueError, match="missing"):
        port.load_jax_state(missing)
    extra = copy.deepcopy(tree)
    extra["classifier"]["params"]["Dense_9"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="no place"):
        port.load_jax_state(extra)
    no_net = {k: v for k, v in tree.items() if k != "discriminator"}
    with pytest.raises(ValueError):
        port.load_jax_state(no_net)


def test_ema_filter_state(blob_dataset):
    port = CVAEGAN(device="cpu", ema_filter=True)
    port._prepare((blob_dataset.tr_samples, blob_dataset.tr_labels))
    assert port._filter_state(port.state)["classifier"] is port.state["classifier_ema"]
    assert port._filter_state(port.state)["generator"] is port.state["generator"]


def test_float32_only():
    settings = tconfig.Settings()
    settings.gan.compute_dtype = "bfloat16"
    with pytest.raises(NotImplementedError, match="A20"):
        CVAEGAN(device="cpu", settings=settings)
