"""The port's block attention (kernels B2, B3), attention entropy and
multi-head self-attention against the JAX package, on the CPU.

The same numpy-made inputs go through the JAX functions (the Pallas
kernels in interpret mode, as `tests/test_kernels.py` runs them) and the
port's wrappers, which take their plain PyTorch versions for CPU tensors.
Tolerances are the JAX tests' own: rtol = atol = 2e-5 for outputs and row
entropies (float32 sums in another order, exp/log rounding), and for the
per-row entropy of the module's kernel path against dense probabilities
rtol 2e-4, atol 2e-5 (`tests/test_kernels.py:99-100,152-155,183-184`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvaegan_tpu.core import losses as jlosses
from cvaegan_tpu.kernels import block_attention as jba
from cvaegan_tpu.models.attention import MultiHeadSelfAttention as JaxMHSA
from cvaegan_tpu_torch.convert import load_net
from cvaegan_tpu_torch.core import losses as tlosses
from cvaegan_tpu_torch.kernels import block_attention as tba
from cvaegan_tpu_torch.models.attention import MultiHeadSelfAttention

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, bh, seq, d, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal((bh, seq, d))).astype(np.float32)
            for _ in range(3)]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture(autouse=True)
def _no_launches():
    """On the CPU the wrappers take their plain versions: nothing launches."""
    before = (tba.LAUNCHES, tba.ENTROPY_LAUNCHES)
    yield
    assert (tba.LAUNCHES, tba.ENTROPY_LAUNCHES) == before


@pytest.mark.parametrize("bh,seq,d", [(8, 256, 64), (8, 256, 16), (2, 100, 32)])
def test_block_attention_matches_jax(bh, seq, d):
    q, k, v = _qkv(seq + d, bh, seq, d)
    want = jba.block_attention(q, k, v, interpret=True)
    got = tba.block_attention(*_torch(q, k, v))
    assert got.shape == (bh, seq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bh,seq,d", [(4, 128, 32), (4, 256, 32), (2, 100, 32)])
def test_block_attention_with_entropy_matches_jax(bh, seq, d):
    q, k, v = _qkv(seq, bh, seq, d)
    want_out, want_ent = jba.block_attention_with_entropy(q, k, v, interpret=True)
    out, ent = tba.block_attention_with_entropy(*_torch(q, k, v))
    assert ent.shape == (bh, seq)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(ent.numpy(), np.asarray(want_ent), **TOL)


def test_oracles_match_jax():
    q, k, v = _qkv(7, 3, 50, 8)
    np.testing.assert_allclose(tba.reference_attention(*_torch(q, k, v)).numpy(),
                               np.asarray(jba.reference_attention(q, k, v)), **TOL)
    np.testing.assert_allclose(tba.reference_attention_entropy(*_torch(q, k)).numpy(),
                               np.asarray(jba.reference_attention_entropy(q, k)), **TOL)


def test_plain_versions_chunk_over_heads(monkeypatch):
    """Chunking the heads to bound the score matrix changes nothing."""
    q, k, v = _torch(*_qkv(8, 5, 64, 16))
    whole = tba.block_attention_with_entropy_reference(q, k, v)
    monkeypatch.setattr(tba, "PLAIN_CHUNK_ELEMENTS", 2 * 64 * 64)
    for got, want in zip(tba.block_attention_with_entropy_reference(q, k, v), whole):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(tba.block_attention_reference(q, k, v), whole[0],
                               rtol=0, atol=0)


def test_peaked_rows_entropy_differs_from_jax_kernel():
    """Records the JAX kernel's cancellation (ROADMAP section C): at inputs
    of scale 10 the rows are peaked (scores ~ 300), and its
    m + log l - sl / l misses the dense entropy by more than the tolerance
    in float32. On the CPU the port's wrapper is its dense plain version,
    so the first assertion holds that plain version to the JAX oracle; the
    port's kernel, which carries sl relative to the running max, is held
    to it at scale 10 by `test_block_attention_with_entropy_matches_plain
    [*-10.0]` in `tests/test_torch_port_cuda.py`."""
    q, k, v = _qkv(3, 4, 256, 64, scale=10.0)
    oracle = np.asarray(jba.reference_attention_entropy(q, k))
    _, ent = tba.block_attention_with_entropy(*_torch(q, k, v))
    np.testing.assert_allclose(ent.numpy(), oracle, **TOL)
    _, jax_ent = jba.block_attention_with_entropy(q, k, v, interpret=True)
    jax_err = np.abs(np.asarray(jax_ent) - oracle) / (2e-5 + 2e-5 * np.abs(oracle))
    assert jax_err.max() > 1.0


def test_attention_entropy_matches_jax():
    rng = np.random.default_rng(4)
    probs = rng.random((2, 4, 16, 16)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    np.testing.assert_allclose(
        float(tlosses.attention_entropy(torch.from_numpy(probs))),
        float(jlosses.attention_entropy(jnp.asarray(probs))), rtol=1e-6)
    rows = rng.random((2, 4, 16)).astype(np.float32)
    got = tlosses.attention_entropy(tlosses.AttentionRowEntropy(torch.from_numpy(rows)))
    want = jlosses.attention_entropy(jlosses.AttentionRowEntropy(jnp.asarray(rows)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# --------------------------------------------------- multi-head attention
@pytest.fixture(scope="module")
def mhsa_twin():
    """JAX MultiHeadSelfAttention(64, 4) variables from numpy, and the
    input `[2, 128, 64]`."""
    x = np.random.default_rng(5).standard_normal((2, 128, 64)).astype(np.float32)
    variables = JaxMHSA(embed_dim=64, num_heads=4).init(jax.random.PRNGKey(1), x)
    rng = np.random.default_rng(6)
    variables = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(np.shape(a)) / 8.0).astype(np.float32),
        jax.device_get(variables))
    return variables, x


def _port_mhsa(variables, use_kernel):
    port = MultiHeadSelfAttention(64, 4, use_kernel=use_kernel)
    load_net(port, variables)
    return port


def test_mhsa_dense_path_matches_jax(mhsa_twin):
    variables, x = mhsa_twin
    want_out, want_probs = JaxMHSA(64, 4, use_kernel=False).apply(variables, x)
    with torch.no_grad():
        out, probs = _port_mhsa(variables, False)(torch.from_numpy(x))
    assert probs.shape == (2, 4, 128, 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_probs), rtol=1e-5, atol=1e-6)


def test_mhsa_kernel_path_matches_jax(mhsa_twin):
    variables, x = mhsa_twin
    want_out, want_stats = JaxMHSA(64, 4, use_kernel=True).apply(variables, x)
    _, dense_probs = JaxMHSA(64, 4, use_kernel=False).apply(variables, x)
    with torch.no_grad():
        out, stats = _port_mhsa(variables, True)(torch.from_numpy(x))
    assert isinstance(stats, tlosses.AttentionRowEntropy)
    assert stats.value.shape == (2, 4, 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(stats.value.numpy(), np.asarray(want_stats.value), **TOL)
    p = np.asarray(dense_probs)
    dense_ent = -np.sum(p * np.log(p + 1e-12), axis=-1)
    np.testing.assert_allclose(stats.value.numpy(), dense_ent, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(tlosses.attention_entropy(stats)),
                               float(jlosses.attention_entropy(want_stats)), rtol=2e-5)


def test_mhsa_auto_dispatch_stays_dense_on_the_cpu(mhsa_twin):
    """Auto dispatch takes the kernel only on CUDA, as the JAX package
    takes it only on a TPU; `use_kernel=True` forces it anywhere."""
    variables, x = mhsa_twin
    port = _port_mhsa(variables, None)
    with torch.no_grad():
        _, probs = port(torch.from_numpy(x))
    assert probs.shape == (2, 4, 128, 128)


def test_mhsa_kernel_path_raises_for_a_head_dim_the_kernel_lacks():
    """The kernel path hands a head dim of 48 to the wrapper, which raises;
    the module does not drop to its dense path."""
    port = MultiHeadSelfAttention(192, 4, use_kernel=True)
    with torch.no_grad(), pytest.raises(ValueError, match="head dim"):
        port(torch.zeros(2, 128, 192))


# ------------------------------------------------------------ wrapper checks
@pytest.mark.parametrize("fn", [tba.block_attention, tba.block_attention_with_entropy])
def test_wrappers_reject_what_the_kernels_cannot_run(fn):
    q, k, v = _torch(*_qkv(9, 2, 16, 32))
    with pytest.raises(ValueError, match="head dim"):
        fn(*_torch(*_qkv(9, 2, 16, 48)))
    with pytest.raises(ValueError, match="head dim"):
        fn(*_torch(*_qkv(9, 2, 16, 8)))
    with pytest.raises(TypeError, match="float32"):
        fn(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="shape"):
        fn(q, k[:, :8], v)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fn(*(t.to("meta") for t in (q, k, v)))
    with pytest.raises(RuntimeError, match="forward-only"):
        fn(q.clone().requires_grad_(), k, v)
    with torch.no_grad():
        fn(q.clone().requires_grad_(), k, v)
