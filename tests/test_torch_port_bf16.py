"""The bf16 compute policy of the PyTorch port against the JAX package's.

Under `compute_dtype="bfloat16"` both packages run matmuls and
activations in bf16 from float32 parameters, and keep parameters, Adam
state, normalisation statistics, spectral sigma and losses in float32
(`cvaegan_tpu/core/config.py:35-51`). The same numpy-made weights (carried
across by `cvaegan_tpu_torch.convert`) and inputs go through both, each
under the policy. Each output's dtype must equal JAX's.

bf16 rounds at other places in the two frameworks (XLA on the CPU and
torch sum a bf16 product in other orders, and torch's softmax rounds once
where XLA's rounds per op), so outputs are not compared element by element
at a fixed tolerance. Each is held to a float64 run of the port's own
module on the same bf16-rounded input (`as_exact_as`): the port's largest
error from it is within BF16_TOL of the output's scale, or no more than
twice the JAX package's own largest error. BF16_TOL: bf16 keeps 8
significant bits, so each rounding moves a value by at most 2^-9 of it;
an output built through a few roundings of its operands (input, weights,
product, bias add) lies within a few 2^-9 of the exact one, and 2^-6 of
its largest element covers eight.

Also here: one CVAE-GAN D, C and E+G step under the policy against JAX's
(from drawn Adam moments, as `tests/test_torch_port_training.py` does in
float32), and the gates of `tests/test_mixed_precision.py` on the port:
float32 state, finite losses for every trainer and for a bank, epoch-0
losses near the float32 run's, float32 generation (the fused kernel's path
unchanged by the policy), the downstream classifier pinned to float32, and
captures and generation caches kept per policy.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_layers import _flax_masks, _inputs, _twin
from test_torch_port_training import _d_inputs, _port, _tree
from test_torch_port_training import warm  # noqa: F401  (a fixture)

import cvaegan_tpu_torch
from cvaegan_tpu.core import config as jconfig
from cvaegan_tpu.models import attention as jattn
from cvaegan_tpu.models import layers as jl
from cvaegan_tpu.models import mlp as jm
from cvaegan_tpu_torch.algorithms.seed_bank import SeedBank
from cvaegan_tpu_torch.core import config as tconfig
from cvaegan_tpu_torch.core.schedules import progressive_lambda
from cvaegan_tpu_torch.eval.classifier import Classifier
from cvaegan_tpu_torch.kernels import block_attention as tba
from cvaegan_tpu_torch.models import attention as tattn
from cvaegan_tpu_torch.models import layers as tl
from cvaegan_tpu_torch.models import mlp as tm

BF16_TOL = dict(rtol=2.0 ** -6, atol=1e-6)
N = 48
EPOCH = 350.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def bf16():
    """Both packages' process-wide policy set to bfloat16 (the JAX package
    reads it when it traces; the port when a module runs outside a
    trainer's own settings)."""
    jconfig.settings.gan.compute_dtype = "bfloat16"
    tconfig.settings.gan.compute_dtype = "bfloat16"
    yield
    jconfig.settings.gan.compute_dtype = "float32"
    tconfig.settings.gan.compute_dtype = "float32"


def _bf16_rounded(x: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def _f64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32), np.float64)


def as_exact_as(got, theirs, exact, tol=BF16_TOL):
    """`got`'s largest |error| from `exact` is within tol of exact's scale
    or no more than twice `theirs`'s (see the module docstring)."""
    exact = np.asarray(exact, np.float64)
    err = float(np.abs(_f64(got) - exact).max())
    their_err = float(np.abs(_f64(theirs) - exact).max())
    limit = max(tol["atol"] + tol["rtol"] * float(np.abs(exact).max()), 2.0 * their_err)
    assert err <= limit, (err, their_err, limit)


def _exact(module, *args, **kwargs):
    """The port module run in float64 under the float32 policy (no casts)."""
    m = copy.deepcopy(module).double()
    with torch.no_grad(), tl.dtype_override(torch.float32):
        return m(*[torch.from_numpy(np.asarray(a, np.float64)) for a in args], **kwargs)


def _jax_twin(jax_module, torch_module, x, **init_kwargs):
    """`_twin`, with the Flax variables as jax arrays: on numpy leaves a
    Flax module would multiply with numpy, not XLA."""
    variables, port = _twin(jax_module, torch_module, jnp.asarray(x), **init_kwargs)
    return jax.tree.map(jnp.asarray, variables), port


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


# ------------------------------------------------------------------- layers
def test_policy_routing():
    """The override block wins over a trainer's policy, which wins over the
    process-wide setting; anything but the two policies raises."""
    settings = tconfig.Settings()
    settings.gan.compute_dtype = "bfloat16"
    assert tl.compute_dtype() == torch.float32
    with tl.policy(settings.gan):
        assert tl.compute_dtype() == torch.bfloat16
        with tl.dtype_override("float32"):
            assert tl.compute_dtype() == torch.float32
        assert tl.compute_dtype() == torch.bfloat16
    assert tl.compute_dtype() == torch.float32
    settings.gan.compute_dtype = "float16"
    with pytest.raises(ValueError, match="compute_dtype"), tl.policy(settings.gan):
        pass


def test_dense_rounds_the_product_before_the_bias(bf16):
    """JAX rounds the bf16 product, then adds the bias in bf16 (two
    roundings); a fused bias would round once. The port's output equals
    the twice-rounded sum exactly, and differs from the once-rounded one
    somewhere on these inputs."""
    x = _inputs(0, N, 20)
    variables, port = _jax_twin(jl.Dense(7), tl.Dense(20, 7), x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        xb, wb, bb = (t.to(torch.bfloat16) for t in (torch.from_numpy(x), port.weight,
                                                      port.bias))
        product = (xb.double() @ wb.double().T)
        twice = (product.to(torch.bfloat16).double() + bb.double()).to(torch.bfloat16)
        once = (product + bb.double()).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, twice)
    assert not torch.equal(twice, once)
    want = jl.Dense(7).apply(variables, jnp.asarray(x))
    assert _dtype(got) == str(want.dtype)
    as_exact_as(got, want, _exact(port, _bf16_rounded(x)))


@pytest.mark.parametrize("train", [False, True])
def test_spectral_dense(bf16, train):
    """Power iteration and sigma stay float32: u/v after a train forward
    agree with JAX's at float32's tolerance; the product is bf16."""
    x = _inputs(2, N, 24)
    jmod = jl.SpectralDense(12)
    variables, port = _jax_twin(jmod, tl.SpectralDense(24, 12), x)
    exact = _exact(port.train(train), _bf16_rounded(x))
    got = port(torch.from_numpy(x))
    want, new = jmod.apply(variables, jnp.asarray(x), update_stats=train,
                           mutable=["spectral"])
    assert _dtype(got) == str(want.dtype) == "bfloat16"
    assert port.u.dtype == port.v.dtype == torch.float32
    for name in ("u", "v"):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(new["spectral"][name]), rtol=1e-5, atol=1e-6)
    as_exact_as(got, want, exact)


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm(bf16, train):
    """A bf16 input (a Dense output under the policy) is widened exactly,
    so the statistics are float32's: the running averages agree with
    JAX's at float32's tolerance; the output is cast to bf16."""
    x = _bf16_rounded(2.0 * _inputs(1, N, 16) + 0.5)
    jmod = jl.BatchNorm()
    variables, port = _jax_twin(jmod, tl.BatchNorm(16), x, train=False)
    port.train(train)
    exact = _exact(port, x)
    xb = jnp.asarray(x, jnp.bfloat16)
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(torch.bfloat16))
    if train:
        want, new = jmod.apply(variables, xb, train=True, mutable=["batch_stats"])
        stats = new["batch_stats"]["BatchNorm_0"]
        for name, buf in (("mean", port.running_mean), ("var", port.running_var)):
            assert buf.dtype == torch.float32
            np.testing.assert_allclose(buf.numpy(), np.asarray(stats[name]),
                                       rtol=1e-5, atol=1e-6)
    else:
        want = jmod.apply(variables, xb, train=False)
    assert _dtype(got) == str(want.dtype) == "bfloat16"
    as_exact_as(got, want, exact)


def test_layernorm_returns_float32(bf16):
    """Flax's LayerNorm promotes a bf16 input to its float32 parameters and
    returns float32; so does the port's, with float32 statistics: the
    output agrees with JAX's at float32's tolerance."""
    import flax.linen as fnn

    x = _bf16_rounded(3.0 * _inputs(3, N, 40) - 1.0)
    jmod = fnn.LayerNorm(epsilon=1e-5)
    variables, port = _jax_twin(jmod, tl.LayerNorm(40), x)
    got = port(torch.from_numpy(x).to(torch.bfloat16))
    want = jmod.apply(variables, jnp.asarray(x, jnp.bfloat16))
    assert _dtype(got) == str(want.dtype) == "float32"
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_classifier_mlp(bf16, train, monkeypatch):
    """The companion classifier: bf16 Dense layers, its LayerNorm in
    float32 and cast back, bf16 logits; train mode on Flax's dropout
    masks."""
    x = _inputs(10, N, 30)
    jmod = jm.Classifier(num_classes=5)
    variables, port = _jax_twin(jmod, tm.Classifier(30, 5), x, train=False)
    exact = _exact(port.eval(), _bf16_rounded(x))
    if train:
        want, _, masks = _flax_masks(jmod, variables, jnp.asarray(x), rng=jax.random.PRNGKey(2),
                                     mutable=[])
        mask_it = iter(torch.from_numpy(m) for m in masks)
        monkeypatch.setattr(tl, "_keep_mask", lambda x, keep_prob, generator: next(mask_it))
        # the float64 yardstick takes the same masks
        exact_masks = iter(torch.from_numpy(m) for m in masks)
        m64 = copy.deepcopy(port).double().train()
        with torch.no_grad(), tl.dtype_override(torch.float32), monkeypatch.context() as mp:
            mp.setattr(tl, "_keep_mask", lambda x, keep_prob, generator: next(exact_masks))
            exact = m64(torch.from_numpy(_bf16_rounded(x).astype(np.float64)))
    else:
        want = jmod.apply(variables, jnp.asarray(x), train=False)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert _dtype(got) == str(want.dtype) == "bfloat16"
    as_exact_as(got, want, exact)


class _KernelMHSA(jattn.MultiHeadSelfAttention):
    """JAX's attention with the blockwise kernel forced (interpret mode on
    the CPU), under the base class's name so its parameters keep their
    names."""

    use_kernel: bool = True


_KernelMHSA.__name__ = "MultiHeadSelfAttention"


@pytest.mark.parametrize("kernel", [False, True])
def test_residual_attention_block(bf16, kernel, monkeypatch):
    """A RAIN block at seq 128 (4 heads of d 16). On the kernel path JAX's
    bf16 q, k, v go to the Pallas kernel in interpret mode, and the port's
    to the plain version of its kernel (bf16 widened to float32, as the
    kernel computes): the output and the row entropies come back float32.
    The pre-LN outputs are float32 in both; the block's output follows
    JAX's promotion (float32 residual + bf16 feed-forward)."""
    x = _inputs(12, 2, 128, 64)
    if kernel:
        monkeypatch.setattr(jattn, "MultiHeadSelfAttention", _KernelMHSA)
    jmod = jattn.ResidualAttentionBlock(64)
    variables, port = _jax_twin(jmod, tattn.ResidualAttentionBlock(64, 64), x, train=False)
    port.attention.use_kernel = False  # the yardstick: dense, in float64
    exact_out, exact_probs = _exact(port.eval(), _bf16_rounded(x))
    port.attention.use_kernel = kernel
    with torch.no_grad():
        got, stats = port(torch.from_numpy(x).to(torch.bfloat16))
    want, want_stats = jmod.apply(variables, jnp.asarray(x, jnp.bfloat16), train=False)
    assert _dtype(got) == str(want.dtype)
    if kernel:
        assert isinstance(stats, tattn.AttentionRowEntropy)
        assert _dtype(stats.value) == str(want_stats.value.dtype) == "float32"
        exact_ent = -(exact_probs * torch.log(exact_probs)).sum(-1)
        as_exact_as(stats.value, want_stats.value, exact_ent)
    else:
        assert _dtype(stats) == str(want_stats.dtype) == "bfloat16"
    as_exact_as(got, want, exact_out)


def test_attention_kernel_plain_version_takes_bf16():
    """On the CPU the bf16 inputs widen to float32 (exact), which is what
    the Pallas kernel in interpret mode computes on them: the two agree at
    the float32 kernels' tolerance, and nothing launches."""
    from cvaegan_tpu.kernels import block_attention as jba

    rng = np.random.default_rng(4)
    q, k, v = (_bf16_rounded(rng.standard_normal((4, 128, 32))) for _ in range(3))
    before = (tba.BF16_LAUNCHES, tba.BF16_ENTROPY_LAUNCHES)
    want_out, want_ent = jba.block_attention_with_entropy(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), interpret=True)
    out, ent = tba.block_attention_with_entropy(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert out.dtype == ent.dtype == torch.float32
    assert str(want_out.dtype) == str(want_ent.dtype) == "float32"
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ent.numpy(), np.asarray(want_ent), rtol=2e-5, atol=2e-5)
    assert (tba.BF16_LAUNCHES, tba.BF16_ENTROPY_LAUNCHES) == before


# -------------------------------------------------------------------- steps
def _step_runs(kind, warm, blob_dataset, monkeypatch):
    """One CVAE-GAN step from the warm state (drawn Adam moments) three
    ways, on the same inputs and dropout masks: JAX's under the bf16
    policy (its new state carried into a port trainer), the port's under
    the bf16 policy, and the port's in float64 under no policy (the exact
    step). Returns (port, from JAX, float64, port losses, JAX losses)."""
    from test_torch_port_sngan_ctgan import _replayed_masks

    from cvaegan_tpu_torch.core import losses as tlosses

    replay = _replayed_masks(monkeypatch)
    jt, state, _ = warm
    key, class_id = jax.random.PRNGKey(21 + "dcg".index(kind)), 3
    cfg = jt.gan_cfg
    if kind == "g":
        new_state, want = jax.jit(
            lambda s, k: jt._g_step(s, jt._data, class_id, jnp.float32(EPOCH), k))(state, key)
        k_x, k_eps, k_z, _, _ = jax.random.split(key, 5)
        x_real, y = jt._sample_batch(k_x, jt._data, class_id)
        arrays = (x_real, y, jax.random.normal(k_z, (cfg.batch_size, cfg.z_size)),
                  # JAX's reparameterisation draws eps in the activations' dtype
                  jax.random.normal(k_eps, (cfg.batch_size, cfg.z_size), jnp.bfloat16))
        lam = progressive_lambda(torch.tensor(EPOCH), 0.5, 200, 500)

        def run(port, dtype):
            x, yy, z, eps = (torch.from_numpy(np.array(a, np.float32)) for a in arrays)
            return port._g_step(x.to(dtype), yy.long(), z.to(dtype), eps.to(dtype),
                                lam.to(dtype))
    else:
        step = jt._d_step if kind == "d" else jt._c_step
        new_state, want = jax.jit(lambda s, k: step(s, jt._data, class_id, k))(state, key)
        arrays = _d_inputs(jt, class_id, key)

        def run(port, dtype):
            x, yy, z = arrays
            return (port._d_step if kind == "d" else port._c_step)(
                x.to(dtype), yy.long(), z.to(dtype))

    port, exact = _port(warm, blob_dataset), _port(warm, blob_dataset)
    replay()
    got = run(port, torch.float32)
    from_jax = _port(warm, blob_dataset)
    from_jax.load_jax_state(_tree(new_state))
    exact.state.double()
    for opt in exact.optimizers.values():
        opt.m, opt.v = [m.double() for m in opt.m], [v.double() for v in opt.v]
    monkeypatch.setattr(tlosses, "_f32", lambda *xs: xs[0] if len(xs) == 1 else xs)
    replay()
    with tl.dtype_override(torch.float32):
        run(exact, torch.float64)
    return port, from_jax, exact, got, want


@pytest.mark.parametrize("kind", ["d", "c", "g"])
def test_cvaegan_steps_as_exact_as_jax(kind, warm, blob_dataset, bf16, monkeypatch):  # noqa: F811
    """One D, C or E+G step under the policy: its losses agree with JAX's
    within BF16_TOL (each a float32 reduction of bf16 activations), every
    parameter, buffer and Adam tensor stays float32, and each is as exact
    as JAX's: per tensor, its largest error from the float64 step is within
    BF16_TOL of the tensor's scale or no more than twice JAX's. Not
    element by element: gradients that are 0 in exact arithmetic (a bias
    before BatchNorm) carry bf16 rounding noise of another pattern in each
    framework, which Adam from the drawn moments normalises."""
    port, from_jax, exact, got, want = _step_runs(kind, warm, blob_dataset, monkeypatch)
    pairs = ([(float(got[k]), float(want[k])) for k in port.loss_keys] if kind == "g"
             else [(float(got), float(want))])
    for g, w in pairs:
        assert abs(g - w) <= BF16_TOL["atol"] + BF16_TOL["rtol"] * abs(w), (g, w)
    for a, o, r in zip(port._static_tensors(), from_jax._static_tensors(),
                       exact._static_tensors()):
        assert a.dtype in (torch.float32, torch.int32)
        as_exact_as(a, o, r.detach().double().numpy())


# -------------------------------------------------- the mixed-precision gates
ZOO = ("CVAE", "VAEGAN", "GAN", "CGAN", "SNGAN", "CTGAN", "TMGGAN", "QG_SMOTE", "RAIN_GAN")


def _settings(dtype, epochs=2, batch_size=16):
    settings = tconfig.Settings()
    settings.gan.compute_dtype = dtype
    settings.gan.epochs = epochs
    settings.gan.batch_size = batch_size
    settings.classifier.epochs = 2
    return settings


def _small_data(rows=100, features=12, classes=5):
    rng = np.random.default_rng(0)
    return (rng.random((rows, features), dtype=np.float32),
            (np.arange(rows) % classes).astype(np.int32))


def _fitted(cls, dtype, data, **settings_kwargs):
    model = cls(seed=0, device="cpu", settings=_settings(dtype, **settings_kwargs))
    model.verbose = False
    model.fit(data)
    return model


def _assert_float32_state(model):
    for t in model._static_tensors():
        assert t.dtype in (torch.float32, torch.int32), t.dtype
    for k, vals in model.loss_history.items():
        assert np.isfinite(vals).all(), k


def test_bf16_fit_keeps_float32_state_and_finite_losses():
    """Master weights: every parameter, buffer (BatchNorm statistics,
    spectral u/v), Adam moment and the losses stay float32 under bf16
    (`tests/test_mixed_precision.py:33-52`)."""
    model = _fitted(cvaegan_tpu_torch.CVAEGAN, "bfloat16", _small_data())
    _assert_float32_state(model)


@pytest.mark.parametrize("name", ZOO)
def test_bf16_zoo_trains_finite(name):
    """Every other trainer fits under the policy with float32 state and
    finite losses (`tests/test_mixed_precision.py:140-155`)."""
    model = _fitted(getattr(cvaegan_tpu_torch, name), "bfloat16", _small_data(), epochs=1)
    _assert_float32_state(model)


def test_bf16_epoch0_losses_match_float32_scale(blob_dataset):
    """bf16 is reduced precision, not other math: epoch-0 losses on the blob
    fixture lie within max(0.05, 8%) of the float32 run's
    (`tests/test_mixed_precision.py:62-80`)."""
    data = (blob_dataset.tr_samples, blob_dataset.tr_labels)
    ref, got = (_fitted(cvaegan_tpu_torch.CVAEGAN, dtype, data, epochs=1, batch_size=128)
                for dtype in ("float32", "bfloat16"))
    for k in ref.loss_keys:
        r, g = ref.loss_history[k][0], got.loss_history[k][0]
        assert abs(g - r) <= max(0.05, 0.08 * abs(r)), (k, g, r)


def test_bf16_generation_returns_float32_and_fast_path_is_unchanged():
    """Generation returns float32 arrays at the API under bf16; the fused
    kernel's path (`generate_samples_fast`, float32 under either policy,
    as JAX's) gives the same rows bitwise whatever the policy."""
    model = _fitted(cvaegan_tpu_torch.CVAEGAN, "bfloat16", _small_data())
    for out in (model.generate_samples(0, 16),
                model.generate_qualified_samples(0, 8, confidence_threshold=0.0),
                model.reconstruct_samples(*(a[:8] for a in _small_data()))):
        assert out.dtype == np.float32 and np.isfinite(out).all()
    state = model.generator.get_state()
    fast_bf16 = model.generate_samples_fast(1, 64)
    model.generator.set_state(state)
    model.gan_cfg.compute_dtype = "float32"
    fast_f32 = model.generate_samples_fast(1, 64)
    assert fast_bf16.dtype == np.float32
    np.testing.assert_array_equal(fast_bf16, fast_f32)


def test_bf16_seed_bank_keeps_float32_state():
    """A bank of 2 under the policy (`tests/test_mixed_precision.py:97-111`)."""
    bank = SeedBank(cvaegan_tpu_torch.CVAEGAN, seeds=[0, 1], device="cpu",
                    settings=_settings("bfloat16", epochs=1))
    for t in bank.trainers:
        t.verbose = False
    bank.fit([_small_data()] * 2)
    for t in bank.trainers:
        _assert_float32_state(t)


def test_downstream_classifier_pinned_to_float32(blob_dataset, bf16):
    """The evaluation instrument does not move with the policy
    (`tests/test_mixed_precision.py:114-127`): under a process-wide bf16
    policy the downstream classifier fits and predicts exactly as under
    float32, in float32, also when warm-started from a bf16 companion."""
    from cvaegan_tpu_torch.data.tabular import TabularDataset

    blob_dataset = TabularDataset(blob_dataset.tr_samples, blob_dataset.tr_labels,
                                  blob_dataset.te_samples, blob_dataset.te_labels)
    outs = []
    for dtype in ("bfloat16", "float32"):
        tconfig.settings.gan.compute_dtype = dtype
        clf = Classifier("pin", seed=0, settings=_settings(dtype), device="cpu")
        clf.fit(blob_dataset)
        outs.append(clf.predict(blob_dataset.te_samples, use_prob=True))
        assert {p.dtype for p in clf.module.parameters()} == {torch.float32}
    tconfig.settings.gan.compute_dtype = "bfloat16"
    assert outs[0].dtype == np.float32
    np.testing.assert_array_equal(outs[0], outs[1])
    clf.test(blob_dataset)
    assert clf.metrics["F1"] > 0.9
    companion = _fitted(cvaegan_tpu_torch.CVAEGAN, "bfloat16",
                        (blob_dataset.tr_samples, blob_dataset.tr_labels), epochs=1)
    warm_clf = Classifier("pin_warm", seed=0, settings=_settings("bfloat16"), device="cpu")
    warm_clf.warm_start_from(companion)
    warm_clf.fit(blob_dataset)
    assert warm_clf.predict(blob_dataset.te_samples, use_prob=True).dtype == np.float32


def test_policy_flip_keys_captures_and_generation_caches():
    """Flipping a trainer's policy starts another capture key and another
    generation-cache namespace and keeps the old one; an override block
    routes to its own; a fit drops every namespace
    (`tests/test_mixed_precision.py:138-173`)."""
    model = _fitted(cvaegan_tpu_torch.CVAEGAN, "float32", _small_data())
    with tl.policy(model.gan_cfg):
        f32_key = model._capture_key()
    model.generate_qualified_samples(0, 8, confidence_threshold=0.0)
    assert set(model._gen_caches) == {"float32"}
    f32_cache = model._gen_caches["float32"]
    model.gan_cfg.compute_dtype = "bfloat16"
    with tl.policy(model.gan_cfg):
        assert model._capture_key() != f32_key
        assert model._capture_key()[0] == "bfloat16"
    model.generate_qualified_samples(0, 8, confidence_threshold=0.0)
    assert set(model._gen_caches) == {"float32", "bfloat16"}
    assert model._gen_caches["float32"] is f32_cache
    with tl.dtype_override("float32"):
        assert model._gen_cache is f32_cache
    model.fit(_small_data())
    assert model._gen_caches == {}


def test_bf16_pipeline_runs_on_the_cpu(tmp_path):
    """The balance pipeline under the policy: the GAN fits in bf16, the
    augmented rows are float32 and the downstream classifier float32."""
    from cvaegan_tpu_torch.data.tabular import TabularDataset
    from cvaegan_tpu_torch.pipelines.balance import run_balance_pipeline

    x, y = _small_data(rows=200)
    ds = TabularDataset(x[:160], y[:160], x[160:], y[160:])
    settings = _settings("bfloat16", epochs=2)
    settings.paths = tconfig.Paths(root=tmp_path)
    result = run_balance_pipeline(cvaegan_tpu_torch.CVAEGAN, "CVAE_GAN", ds,
                                  out_dir=tmp_path, settings=settings, plot=False,
                                  device="cpu")
    assert result["model"].gan_cfg.compute_dtype == "bfloat16"
    assert result["augmented"].tr_samples.dtype == np.float32
    assert {p.dtype for p in result["classifier"].module.parameters()} == {torch.float32}
    assert 0.0 <= result["multiclass_metrics"]["F1"] <= 1.0
