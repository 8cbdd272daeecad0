"""The port's fused generator forward against the JAX package's.

On the CPU `fused_mlp4` takes its plain PyTorch version, so these tests
hold that version, the BatchNorm fold and the generator's fast path to
the Pallas kernel run in interpret mode (as `tests/test_kernels.py` runs
it) at the serving widths 133->256->128->64->30, rtol 1e-5, atol 1e-6.
The CUDA kernels themselves are held to the plain version run in float64
on the card (`chip_smoke.py`, `tests/test_torch_port_cuda.py`); their
numerics are emulated in `tests/test_torch_port_fused_mlp_tf32.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvaegan_tpu.core.state import adam, init_net
from cvaegan_tpu.kernels import fused_mlp as jf
from cvaegan_tpu.models import mlp as jm
from cvaegan_tpu_torch.convert import load_net
from cvaegan_tpu_torch.core.state import apply_eval, apply_train
from cvaegan_tpu_torch.kernels import fused_mlp as tf
from cvaegan_tpu_torch.models import mlp as tm
from cvaegan_tpu_torch.models.layers import one_hot

TOL = dict(rtol=1e-5, atol=1e-6)
DIMS = (133, 256, 128, 64, 30)
Z, CLASSES, FEATURES = 128, 5, 30
NS = (1, 7, 100, 511, 513)
FINALS = ("sigmoid", "tanh", "none")


def _random_mlp(seed):
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((DIMS[i], DIMS[i + 1])) * 0.1).astype(np.float32)
          for i in range(4)]
    bs = [(rng.standard_normal(DIMS[i + 1]) * 0.1).astype(np.float32)
          for i in range(4)]
    return ws, bs


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("final", FINALS)
@pytest.mark.parametrize("n", NS)
def test_mlp4_reference_matches_pallas(n, final):
    ws, bs = _random_mlp(0)
    x = np.random.default_rng(n).standard_normal((n, DIMS[0])).astype(np.float32)
    want = jf.fused_mlp4(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                         [jnp.asarray(b) for b in bs], final=final, interpret=True)
    got = tf.mlp4_reference(torch.from_numpy(x), _t(ws), _t(bs), final=final)
    assert got.shape == (n, DIMS[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_mlp4_cpu_route_and_checks():
    """A CPU tensor takes the plain version and launches nothing; bad
    arguments raise before any launch."""
    ws, bs = _t(_random_mlp(1)[0]), _t(_random_mlp(1)[1])
    x = torch.randn(9, DIMS[0], generator=torch.Generator().manual_seed(0))
    before = (tf.LAUNCHES, tf.TC_LAUNCHES, tf.SIMT_LAUNCHES)
    torch.testing.assert_close(tf.fused_mlp4(x, ws, bs, final="tanh"),
                               tf.mlp4_reference(x, ws, bs, final="tanh"),
                               rtol=0, atol=0)
    assert (tf.LAUNCHES, tf.TC_LAUNCHES, tf.SIMT_LAUNCHES) == before
    with pytest.raises(ValueError):
        tf.fused_mlp4(x, ws, bs, final="relu")
    with pytest.raises(ValueError):
        tf.fused_mlp4(x[:, :100], ws, bs)
    with pytest.raises(ValueError):
        tf.fused_mlp4(x, ws[:3], bs[:3])
    with pytest.raises(TypeError):
        tf.fused_mlp4(x.double(), ws, bs)


@pytest.fixture(scope="module")
def generator_pair():
    """A JAX generator with BatchNorm statistics moved off their initial
    values, and the port generator holding the same state."""
    gen = jm.Generator(output_dim=FEATURES, num_classes=CLASSES)
    st = init_net(gen, jax.random.PRNGKey(0), adam(1e-3),
                  jnp.zeros((2, Z)), jnp.zeros((2,), jnp.int32))
    rng = np.random.default_rng(7)
    zs = (2.0 * rng.standard_normal((64, Z))).astype(np.float32)
    ys = (np.arange(64) % CLASSES).astype(np.int32)
    _, mut = gen.apply({"params": st.params, **st.mutables}, zs, ys,
                       train=True, mutable=["batch_stats"])
    st = st.replace(mutables=dict(mut))
    tree = jax.device_get({"params": st.params, **st.mutables})
    return st, tree


def _port_generator(tree, final):
    port = tm.Generator(Z, FEATURES, num_classes=CLASSES,
                        out_activation=None if final == "none" else final)
    load_net(port, tree)
    return port


def test_fold_dense_bn_matches_jax():
    rng = np.random.default_rng(3)
    args = [rng.standard_normal((20, 8)), rng.standard_normal(8),
            1 + 0.1 * rng.standard_normal(8), rng.standard_normal(8),
            rng.standard_normal(8), rng.uniform(0.5, 1.5, 8)]
    args = [a.astype(np.float32) for a in args]
    jw, jb = jf.fold_dense_bn(*[jnp.asarray(a) for a in args])
    tw, tb = tf.fold_dense_bn(*_t(args))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)


def test_generator_fast_params_match_jax(generator_pair):
    st, tree = generator_pair
    jw, jb = jf.generator_fast_params(st)
    tw, tb = tf.generator_fast_params(_port_generator(tree, "sigmoid"))
    for a, b in zip(tw + tb, jw + jb):
        assert a.is_contiguous()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("final", FINALS)
@pytest.mark.parametrize("n", NS)
def test_fast_generator_forward_matches_pallas(generator_pair, n, final):
    st, tree = generator_pair
    rng = np.random.default_rng(100 + n)
    z = rng.standard_normal((n, Z)).astype(np.float32)
    y = (np.arange(n) % CLASSES).astype(np.int32)
    onehot = jax.nn.one_hot(y, CLASSES)
    want = jf.fast_generator_forward(st, jnp.asarray(z), onehot, final=final,
                                     interpret=True)
    port = _port_generator(tree, final)
    got = tf.fast_generator_forward(port, torch.from_numpy(z),
                                    one_hot(torch.from_numpy(y), CLASSES), final=final)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # ... and the fold reproduces the module's own eval forward.
    module_out, _ = apply_eval(port, torch.from_numpy(z), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), module_out.numpy(), **TOL)


def test_fast_path_rejects_other_generators():
    spectral = tm.Generator(Z, FEATURES, num_classes=CLASSES, spectral=True)
    with pytest.raises(NotImplementedError):
        tf.generator_fast_params(spectral)
    with pytest.raises(NotImplementedError):
        tf.fast_generator_forward(spectral, torch.zeros(2, Z), torch.zeros(2, CLASSES))


def test_fold_follows_batchnorm_statistics(generator_pair):
    """A train-mode forward moves the running statistics in place; the
    fast path must see the new ones."""
    _, tree = generator_pair
    port = _port_generator(tree, "sigmoid")
    g = torch.Generator().manual_seed(0)
    z = torch.randn(32, Z, generator=g)
    y = torch.arange(32) % CLASSES
    before = tf.fast_generator_forward(port, z, one_hot(y, CLASSES))
    apply_train(port, 3.0 * torch.randn(64, Z, generator=g) + 1.0,
                torch.arange(64) % CLASSES)
    after = tf.fast_generator_forward(port, z, one_hot(y, CLASSES))
    module_out, _ = apply_eval(port, z, y)
    assert not torch.allclose(before, after)
    torch.testing.assert_close(after, module_out, **TOL)
