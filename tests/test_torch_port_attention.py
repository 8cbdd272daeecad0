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


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Under several test workers torch's intra-op threads oversubscribe
    the cores and spin; one thread keeps this module's small products
    near their single-process time."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


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
    at scale 10 to that plain version run in float64 (`float64_rule`) by
    `test_block_attention_with_entropy_matches_plain[*-10.0]` in
    `tests/test_torch_port_cuda.py`."""
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


# ------------------------------------------- numerics of the tensor-core kernel
# The card's kernel (`csrc/block_attention.cu`) runs both products on the
# tensor cores as TF32 in three passes: x = hi + lo with hi = tf32(x) and
# lo = tf32(x - hi), a.b ~ hi.lo + lo.hi + hi.hi. This CPU emulation of its
# numerics (TF32 rounding by bit arithmetic, as cvt.rna does; one key tile)
# shows why three passes and not one.


def _tf32(x):
    """Round float32 to TF32 as cvt.rna.tf32.f32 does: to nearest, ties away
    from zero, keeping 10 mantissa bits (the low 13 bits cleared)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_matmul(a, b, passes):
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


def _emulated_kernel(q, k, v, passes):
    """(out, row entropy) with both products in `passes` TF32 passes and
    the softmax and entropy in float32, in the kernel's formulas."""
    s = _tf32_matmul(q, k.transpose(-1, -2), passes) * q.shape[-1] ** -0.5
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1)
    return (_tf32_matmul(p, v, passes) / l[..., None],
            torch.log(l) - (p * (s - m)).sum(-1) / l)


def _worst_over_tol(got, want):
    return float(((got - want).abs() / (TOL["atol"] + TOL["rtol"] * want.abs())).max())


def _emulation_case(d, scale):
    """The emulated kernel in three and one passes, the plain float32
    version and the plain version in float64, at `[4, 256, d]`."""
    q, k, v = _torch(*_qkv(d, 4, 256, d, scale=scale))
    exact = tba.block_attention_with_entropy_reference(q.double(), k.double(),
                                                       v.double())
    return ({p: _emulated_kernel(q, k, v, p) for p in (3, 1)},
            tba.block_attention_with_entropy_reference(q, k, v), exact)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0 + 0.49 * one_ulp, 1.0 + 0.5 * one_ulp,
                      -(1.0 + 0.5 * one_ulp), 3.0 + 1.51 * 2 * one_ulp])
    want = torch.tensor([1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 3.0 + 4 * one_ulp])
    torch.testing.assert_close(_tf32(x), want, rtol=0, atol=0)
    hi = _tf32(x)
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32(_tf32(x - hi)), _tf32(x - hi))


@pytest.mark.parametrize("d", tba.HEAD_DIMS)
def test_three_tf32_passes_keep_the_float32_tolerance(d):
    """At unit scale three passes stay within rtol = atol = 2e-5 of the
    plain float32 version, output and entropy; one pass misses it."""
    emulated, plain, _ = _emulation_case(d, 1.0)
    three = max(_worst_over_tol(g, w) for g, w in zip(emulated[3], plain))
    one = _worst_over_tol(emulated[1][0], plain[0])
    assert three <= 0.1, three
    assert one > 3.0, one


@pytest.mark.parametrize("d", tba.HEAD_DIMS)
def test_three_tf32_passes_meet_the_float64_rule_at_scale_10(d):
    """At inputs of scale 10 three passes meet `float64_rule`, output and
    entropy; one pass fails it by orders of magnitude."""
    emulated, plain, exact = _emulation_case(d, 10.0)
    three = max(tba.float64_rule(g, p, x)[1]
                for g, p, x in zip(emulated[3], plain, exact))
    one = max(tba.float64_rule(g, p, x)[1]
              for g, p, x in zip(emulated[1], plain, exact))
    assert three <= 1.0, three
    assert one > 50.0, one


def test_float64_rule_accepts_plain_and_refuses_one_pass():
    """The rule passes the plain float32 version itself (with room for the
    factor 3 and atol) and refuses the one-pass emulation."""
    emulated, plain, exact = _emulation_case(64, 10.0)
    for got, x in zip(plain, exact):
        err, ratio = tba.float64_rule(got, got, x)
        assert err > 2e-5 and ratio < 1.0 / 3.0
    assert all(tba.float64_rule(g, p, x)[1] > 1.0
               for g, p, x in zip(emulated[1], plain, exact))
    err, ratio = tba.float64_rule(plain[0] + 1.0, plain[0], exact[0])
    assert err > 1.0 and ratio > 1.0


def test_plain_versions_take_float64():
    """`float64_rule`'s exact side: the plain versions run float64 inputs in
    float64 (the wrappers' checks are not on their path)."""
    q, k, v = (t.double() for t in _torch(*_qkv(11, 2, 40, 16)))
    out, ent = tba.block_attention_with_entropy_reference(q, k, v)
    assert out.dtype == ent.dtype == torch.float64
    assert tba.block_attention_reference(q, k, v).dtype == torch.float64
    torch.testing.assert_close(out, tba.reference_attention(q, k, v), rtol=0, atol=0)


def _online_emulated_kernel(q, k, v, drop_alpha=False):
    """(out, row entropy) as the card's kernel sweeps the keys: tiles of
    min(64, 2048 / d) keys (the last one ragged), both products in three
    TF32 passes, scores prescaled by d^-0.5 log2(e) and exponentials in
    base 2, the running max from -1e30, each tile's P V folded into the
    output by alpha, and the entropy carried relative to the running max,
    sl' = alpha (sl' + (m_old - m_new) l_old) + sum p (s - m_new), with
    H = log l - ln 2 sl' / l. `drop_alpha` leaves the output unrescaled."""
    bh, seq, d = q.shape
    keys = min(64, 2048 // d)
    scale_log2 = d ** -0.5 * np.log2(np.e)
    m = torch.full((bh, seq), -1e30)
    l, sl, acc = torch.zeros(bh, seq), torch.zeros(bh, seq), torch.zeros(bh, seq, d)
    for k0 in range(0, seq, keys):
        kt, vt = k[:, k0:k0 + keys], v[:, k0:k0 + keys]
        s = _tf32_matmul(q, kt.transpose(-1, -2), 3) * scale_log2
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        x = s - m_new[..., None]
        p = torch.exp2(x)
        sl = alpha * (sl + (m - m_new) * l) + (p * x).sum(-1)
        l = alpha * l + p.sum(-1)
        pv = _tf32_matmul(p, vt, 3)
        acc = acc + pv if drop_alpha else alpha[..., None] * acc + pv
        m = m_new
    return acc / l[..., None], torch.log(l) - np.log(2.0) * sl / l


@pytest.mark.parametrize("d", tba.HEAD_DIMS)
@pytest.mark.parametrize("scale", [1.0, 10.0])
def test_online_three_pass_sweep_meets_the_checks(d, scale):
    """The kernel's tiled sweep (ragged seq 200: the last tile is short at
    every head dim) holds the card's checks: rtol = atol = 2e-5 against the
    plain float32 version at unit scale, `float64_rule` at scale 10. With
    the output's alpha rescale dropped it fails them."""
    q, k, v = _torch(*_qkv(d + 1, 4, 200, d, scale=scale))
    plain = tba.block_attention_with_entropy_reference(q, k, v)
    exact = tba.block_attention_with_entropy_reference(q.double(), k.double(),
                                                       v.double())

    def worst(got):
        if scale == 1.0:
            return max(_worst_over_tol(g, p) for g, p in zip(got, plain))
        return max(tba.float64_rule(g, p, x)[1] for g, p, x in zip(got, plain, exact))

    assert worst(_online_emulated_kernel(q, k, v)) <= 1.0
    assert worst(_online_emulated_kernel(q, k, v, drop_alpha=True)) > 10.0
