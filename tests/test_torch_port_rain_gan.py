"""The port's RAIN-GAN networks and serving slice against the JAX package.

Networks: Flax variables drawn with numpy (`_randomize`, as in
`tests/test_torch_port_layers.py`) go into both packages; eval and train
forwards must agree at rtol 1e-5, atol 1e-5, and the spectral u/v after a
train forward at rtol 1e-5, atol 1e-6. The looser atol is float32
rounding: a RAIN network is ~16 matmuls and 5-7 LayerNorms deep, and at
these O(1) weights either package alone lies ~3e-6 from a float64 run of
the same network. The trainer: a JAX `RAIN_GAN` built by
`_prepare(blob_dataset)` (no fit), its discriminator's spectral vectors
moved by a train forward, carried into the port with `load_jax_state`.
Its deterministic forwards (at the JAX package's own small initial
weights) agree at rtol 1e-5, atol 1e-6; sampled outputs come
from different RNG streams and are compared by their per-feature means,
within 5 standard errors, as in `tests/test_torch_port_cvaegan.py`.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_layers import _assert_state, _randomize

from cvaegan_tpu import RAIN_GAN as JaxRAINGAN
from cvaegan_tpu.models import attention as jatt
from cvaegan_tpu_torch import RAIN_GAN
from cvaegan_tpu_torch.convert import load_net, rain_gan_state_from_jax
from cvaegan_tpu_torch.kernels import block_attention as tba
from cvaegan_tpu_torch.models import attention as tatt

TOL = dict(rtol=1e-5, atol=1e-6)
NET_TOL = dict(rtol=1e-5, atol=1e-5)
FEATURES, CLASSES, Z, N = 30, 5, 128, 48
DRAWS = 8192
SIGMAS = 5.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """A RAIN forward is many small ops. Under several test workers torch's
    intra-op threads oversubscribe the cores and spin (the qualified-
    sampling test ran hundreds of times slower than alone); one thread
    keeps this module near its single-process time."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs(seed, *shape):
    return np.random.default_rng(200 + seed).standard_normal(shape).astype(np.float32)


def _labels(n=N):
    return (np.arange(n) % CLASSES).astype(np.int32)


NETWORKS = {
    "encoder": (lambda: jatt.RAINEncoder(num_classes=CLASSES, latent_dim=Z),
                lambda: tatt.RAINEncoder(FEATURES, CLASSES, latent_dim=Z),
                lambda: (_inputs(0, N, FEATURES), _labels())),
    "generator": (lambda: jatt.RAINGenerator(output_dim=FEATURES, num_classes=CLASSES),
                  lambda: tatt.RAINGenerator(Z, FEATURES, CLASSES),
                  lambda: (_inputs(1, N, Z), _labels())),
    "discriminator": (lambda: jatt.RAINDiscriminator(num_classes=CLASSES),
                      lambda: tatt.RAINDiscriminator(FEATURES, CLASSES),
                      lambda: (_inputs(2, N, FEATURES), _labels())),
    "classifier": (lambda: jatt.RAINClassifier(num_classes=CLASSES),
                   lambda: tatt.RAINClassifier(FEATURES, CLASSES),
                   lambda: (_inputs(3, N, FEATURES),)),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_network_matches_flax(name, train):
    make_jax, make_port, make_args = NETWORKS[name]
    jmod, port, args = make_jax(), make_port(), make_args()
    variables = _randomize(jmod.init(jax.random.PRNGKey(0), *args, train=False), 0)
    load_net(port, variables)
    mutable = ["spectral"] if "spectral" in variables else []
    (want, want_stats), new = jmod.apply(variables, *args, train=train, mutable=mutable)
    port.train(train)
    with torch.no_grad():
        got, stats = port(*(torch.from_numpy(a) for a in args))
    for g, w in zip(got if name == "encoder" else (got,),
                    want if name == "encoder" else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **NET_TOL)
    assert stats.shape == (N, 4, 1, 1)
    np.testing.assert_array_equal(stats.numpy(), np.asarray(want_stats))
    _assert_state(port, {**variables, **new})


def test_discriminator_without_labels():
    jmod, port = jatt.RAINDiscriminator(num_classes=CLASSES), tatt.RAINDiscriminator(
        FEATURES, CLASSES)
    x = _inputs(4, N, FEATURES)
    variables = _randomize(jmod.init(jax.random.PRNGKey(1), x, train=False), 1)
    load_net(port, variables)
    want, _ = jmod.apply(variables, x, None, train=False)
    port.eval()
    with torch.no_grad():
        got, _ = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET_TOL)


# ---------------------------------------------------------------- trainer
@pytest.fixture(scope="module")
def twins(blob_dataset):
    jt = JaxRAINGAN(seed=0)
    jt.verbose = False
    jt._prepare(blob_dataset)
    state = dict(jt.state)
    d = state["discriminator"]
    x, y = blob_dataset.tr_samples[:256], blob_dataset.tr_labels[:256]
    _, mut = jt.modules["discriminator"].apply(
        {"params": d.params, **d.mutables}, x, y, train=True, mutable=["spectral"])
    state["discriminator"] = d.replace(mutables={**d.mutables, **mut})
    jt.state = state
    jt._clear_gen_caches()
    tree = {name: jax.device_get({"params": ns.params, **ns.mutables})
            for name, ns in state.items()}
    port = RAIN_GAN(seed=0, device="cpu")
    port.load_jax_state(tree)
    return jt, port, tree


def _same_means(a, b):
    se = np.sqrt(a.var(0, ddof=1) / len(a) + b.var(0, ddof=1) / len(b))
    gap = np.abs(a.mean(0) - b.mean(0))
    assert (gap <= SIGMAS * se + 1e-7).all(), (gap / np.maximum(se, 1e-12)).max()


def test_load_jax_state_sets_shapes(twins):
    _, port, _ = twins
    assert (port.feature_num, port.label_num) == (FEATURES, CLASSES)
    assert port.state["generator"].proj.weight.shape == (256, Z + CLASSES)
    assert port.attention_history == {
        "encoder": [], "generator": [], "discriminator": [], "classifier": []}


def test_prepare_builds_the_jax_shapes(twins, blob_dataset):
    _, _, tree = twins
    fresh = RAIN_GAN(seed=1, device="cpu")
    fresh._prepare((blob_dataset.tr_samples, blob_dataset.tr_labels))
    rain_gan_state_from_jax(tree, fresh.state)


def test_generator_and_classifier_forwards(twins, blob_dataset):
    jt, port, _ = twins
    rng = np.random.default_rng(1)
    z = rng.standard_normal((200, Z)).astype(np.float32)
    y = _labels(200)
    want = jt._generator_forward(jt.state, jnp.asarray(z), jnp.asarray(y), None)
    got = port._generator_forward(port.state, torch.from_numpy(z), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    x = blob_dataset.te_samples
    np.testing.assert_allclose(
        port._classifier_logits(port.state, torch.from_numpy(x)).numpy(),
        np.asarray(jt._classifier_logits(jt.state, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("label", [0, 3])
def test_generate_samples_distribution(twins, label):
    jt, port, _ = twins
    want = jt.generate_samples(label, DRAWS)
    got = port.generate_samples(label, DRAWS)
    assert got.shape == (DRAWS, FEATURES) and got.dtype == np.float32
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    _same_means(got, want)


def test_reconstruct_samples_distribution(twins, blob_dataset):
    jt, port, _ = twins
    x, y = blob_dataset.tr_samples, blob_dataset.tr_labels
    want = jt.reconstruct_samples(x, y)
    got = port.reconstruct_samples(x, y)
    assert got.shape == want.shape and got.dtype == np.float32
    _same_means(got, want)


def test_qualified_rows_pass_the_filter(twins):
    _, port, _ = twins
    total = 0
    for target in range(CLASSES):
        for thr in (None, 0.0):
            out = port.generate_qualified_samples(target, 64, confidence_threshold=thr)
            assert out.shape[1] == FEATURES and len(out) <= 64
            if len(out):
                probs = torch.softmax(
                    port._classifier_logits(port.state, torch.from_numpy(out)), -1)
                assert (probs.argmax(-1) == target).all()
                assert (probs.amax(-1) > (0.5 if thr is None else thr)).all()
            total += len(out)
    assert total > 0


def test_visualize_attention_equals_jax(twins, blob_dataset):
    jt, port, _ = twins
    x, y = blob_dataset.te_samples[:40], blob_dataset.te_labels[:40]
    want, got = jt.visualize_attention(x, y), port.visualize_attention(x, y)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == (40, 4, 1, 1)
        np.testing.assert_array_equal(got[key], want[key])


def test_no_attention_kernel_on_the_serving_path(twins):
    """Singleton sequences take the dense branch, as in the JAX package;
    `generate_samples_fast` has no MLP generator to fuse and raises."""
    _, port, _ = twins
    before = (tba.LAUNCHES, tba.ENTROPY_LAUNCHES)
    port.generate_samples(1, 64)
    assert (tba.LAUNCHES, tba.ENTROPY_LAUNCHES) == before
    with pytest.raises(NotImplementedError, match="rain_gan"):
        port.generate_samples_fast(0, 4)


def test_load_jax_state_accounts_for_every_leaf(twins):
    _, _, tree = twins
    port = RAIN_GAN(device="cpu")
    missing = copy.deepcopy(tree)
    del missing["discriminator"]["spectral"]["ResidualAttentionBlock_1"]["SpectralDense_2"]
    with pytest.raises(ValueError, match="missing"):
        port.load_jax_state(missing)
    extra = copy.deepcopy(tree)
    extra["encoder"]["params"]["ResidualAttentionBlock_0"]["Dense_2"] = {
        "kernel": np.zeros((256, 256), np.float32), "bias": np.zeros(256, np.float32)}
    with pytest.raises(ValueError, match="no place"):
        port.load_jax_state(extra)
