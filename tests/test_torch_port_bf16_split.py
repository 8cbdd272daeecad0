"""The numerics of the bf16 block-attention kernels' P V product, on the CPU.

`cvaegan_tpu_torch/csrc/block_attention_sm90.cu` runs every product of
B2/B3 on bf16 operands as bf16 `wgmma`: Q K^T in one pass (a product of
two bf16 values is exact in float32), and P V with the float32
probabilities P split per 128-key tile into hi = bf16(P) and lo =
bf16(P - hi), P V = lo V + hi V, V exact in bf16. The JAX kernels keep P in
float32 (`cvaegan_tpu/kernels/block_attention.py:44,81`). `_emulate`
repeats the kernel's sweep in plain float32 torch (128-key tiles, running
max from -1e30, exp2 of prescaled scores, alpha rescale, one fold per
tile) with P rounded as the kernel rounds it, so that the split can be
held to the tolerances the kernel is held to on the card: rtol = atol =
2e-5 against the plain version at unit scale (the JAX tests' tolerance,
`tests/test_kernels.py:99-100`), `float64_rule` at scale 10, and the JAX
package's `reference_attention` on the same inputs widened to float32.
One bf16 pass of P, as `scaled_dot_product_attention` rounds it, misses
that tolerance: the last test shows it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvaegan_tpu.kernels import block_attention as jba
from cvaegan_tpu_torch.kernels import block_attention as tba

TOL = dict(rtol=2e-5, atol=2e-5)
KEYS = 128  # keys per tile of the emulated sweep
CASES = [(d, seq) for d in tba.HEAD_DIMS for seq in (127, 1000)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Under several test workers torch's intra-op threads oversubscribe
    the cores and spin; one thread keeps these small products fast."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _qkv(d, seq, scale=1.0, bh=2):
    """bf16 q, k, v made with numpy from a seed."""
    rng = np.random.default_rng(1000 * d + seq)
    return [torch.from_numpy((scale * rng.standard_normal((bh, seq, d))).astype(np.float32))
            .bfloat16() for _ in range(3)]


def _bf16(x):
    return x.bfloat16().float()


def _emulate(q, k, v, passes=2):
    """softmax(q k^T d^-0.5) v over bf16 inputs as the kernel sweeps it,
    in float32, with P in `passes` bf16 terms (2: hi + lo; 1: hi)."""
    q, k, v = (t.float() for t in (q, k, v))
    bh, seq, d = q.shape
    scale_log2 = float(np.float32(np.log2(np.e) / np.sqrt(d)))
    m = torch.full((bh, seq, 1), -1e30)
    l = torch.zeros(bh, seq, 1)
    acc = torch.zeros(bh, seq, d)
    for k0 in range(0, seq, KEYS):
        s = (q @ k[:, k0:k0 + KEYS].transpose(1, 2)) * scale_log2
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        alpha = torch.exp2(m - m_new)
        hi = _bf16(p)
        terms = [_bf16(p - hi), hi] if passes == 2 else [hi]
        pv = sum(t @ v[:, k0:k0 + KEYS] for t in terms)
        acc = alpha * acc + pv
        l = alpha * l + p.sum(-1, keepdim=True)
        m = m_new
    return acc / l


def _over_tolerance(got, want):
    return float(((got - want).abs() / (TOL["atol"] + TOL["rtol"] * want.abs())).max())


@pytest.mark.parametrize("d,seq", CASES)
def test_two_passes_hold_the_tolerance_against_the_plain_version(d, seq):
    q, k, v = _qkv(d, seq)
    torch.testing.assert_close(_emulate(q, k, v), tba.block_attention_reference(q, k, v), **TOL)


@pytest.mark.parametrize("d,seq", CASES)
def test_two_passes_hold_float64_rule_at_scale_10(d, seq):
    q, k, v = _qkv(d, seq, scale=10.0)
    exact = tba.block_attention_reference(q.double(), k.double(), v.double())
    assert exact.dtype == torch.float64
    err, ratio = tba.float64_rule(_emulate(q, k, v), tba.block_attention_reference(q, k, v),
                                  exact, TOL["atol"])
    assert ratio <= 1.0, (err, ratio)


@pytest.mark.parametrize("d,seq", CASES)
def test_two_passes_match_jax_reference_attention(d, seq):
    q, k, v = _qkv(d, seq)
    want = jba.reference_attention(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    torch.testing.assert_close(_emulate(q, k, v), torch.from_numpy(np.array(want)), **TOL)


@pytest.mark.parametrize("d,seq", CASES)
def test_one_bf16_pass_misses_the_tolerance(d, seq):
    """P rounded once to bf16 misses rtol = atol = 2e-5 by an order of
    magnitude, while the two-pass split stays well inside it: SDPA's
    rounding is not the JAX function."""
    q, k, v = _qkv(d, seq)
    plain = tba.block_attention_reference(q, k, v)
    assert _over_tolerance(_emulate(q, k, v, passes=1), plain) > 10.0
    assert _over_tolerance(_emulate(q, k, v), plain) < 0.5
