"""The fused MLP kernel B1 on the tensor cores: its numerics, and which of
its two kernels each set of layer widths takes, on the CPU.

The card's tensor-core kernel (`csrc/fused_mlp4.cu`, `tc_kernel`) runs
every product as TF32 in three passes: x = hi + lo with hi = tf32(x) and
lo = tf32(x - hi), a.b ~ hi.lo + lo.hi + hi.hi. The unit sums each 8-wide
k step's products into its float32 accumulator with truncation, so each
step's three passes start from zero and are folded into the float32 sum
by a rounded add. This emulation of those numerics, at the serving widths
133->256->128->64->30 with `chip_smoke.py`'s weights, shows why three
passes and the fold: against the plain version run in float64 at
rtol 1e-5, atol 1e-6 (the kernel's check on the card), three passes with
the fold pass, one pass misses by orders of magnitude, and a truncating
sum over a whole layer misses too. The kernel itself runs only on the
card, where `chip_smoke.py` and `tests/test_torch_port_cuda.py` hold it
to the same yardstick.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cvaegan_tpu_torch.kernels import fused_mlp
from cvaegan_tpu_torch.models.layers import LEAKY_SLOPE, hidden_sizes

TOL = dict(rtol=1e-5, atol=1e-6)
DIMS = (133, 256, 128, 64, 30)
FINALS = ("sigmoid", "tanh", "none")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Under several test workers torch's intra-op threads oversubscribe
    the cores and spin; one thread keeps this module's small products
    near their single-process time."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _tf32(x):
    """Round float32 to TF32 as the kernel's split does (cvt.rna.tf32.f32):
    to nearest, ties away from zero, the low 13 bits cleared."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _truncate(x):
    """float64 -> float32 rounded toward zero, as the unit's accumulator adds."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def _tensor_core_matmul(a, w, passes=3, fold=True):
    """a @ w as the kernel computes it: K zero-padded to a multiple of 8;
    per 8-wide k step the passes' products (exact in float64) go into the
    unit's truncating accumulator, which starts from zero at each step and
    is added to a float32 sum (`fold`), or runs over the whole layer."""
    k = a.shape[1]
    kp = (k + 7) // 8 * 8
    a, w = F.pad(a, (0, kp - k)), F.pad(w, (0, 0, 0, kp - k))
    ah, wh = _tf32(a), _tf32(w)
    al, wl = _tf32(a - ah), _tf32(w - wh)
    pairs = [(ah, wl), (al, wh), (ah, wh)][3 - passes:]
    acc = torch.zeros(a.shape[0], w.shape[1])
    unit = acc
    for k0 in range(0, kp, 8):
        step = slice(k0, k0 + 8)
        if fold:
            unit = torch.zeros_like(acc)
        for x, y in pairs:
            unit = _truncate(unit.double() + x[:, step].double() @ y[step].double())
        if fold:
            acc = acc + unit
    return acc if fold else unit


def _emulated_kernel(x, ws, bs, final, **how):
    h = x
    for w, b in zip(ws[:3], bs[:3]):
        h = F.leaky_relu(_tensor_core_matmul(h, w, **how) + b, LEAKY_SLOPE)
    return fused_mlp._final_act(_tensor_core_matmul(h, ws[3], **how) + bs[3], final)


def _serving_case(n, seed=0):
    """`chip_smoke.py`'s serving weights (N(0, 0.1^2)) and unit inputs."""
    rng = np.random.default_rng(seed)
    ws = [torch.tensor(rng.standard_normal((DIMS[i], DIMS[i + 1])) * 0.1, dtype=torch.float32)
          for i in range(4)]
    bs = [torch.tensor(rng.standard_normal(DIMS[i + 1]) * 0.1, dtype=torch.float32)
          for i in range(4)]
    x = torch.tensor(rng.standard_normal((n, DIMS[0])), dtype=torch.float32)
    return x, ws, bs


def _over_tol_against_float64(got, x, ws, bs, final):
    exact = fused_mlp.mlp4_reference(x.double(), [w.double() for w in ws],
                                     [b.double() for b in bs], final=final)
    assert exact.dtype == torch.float64
    return float(((got.double() - exact).abs()
                  / (TOL["atol"] + TOL["rtol"] * exact.abs())).max())


def test_tf32_split_is_exact_to_float32():
    """hi + lo recovers x to ~2^-22 relative, and both halves are TF32."""
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = _tf32(x)
    lo = _tf32(x - hi)
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32(lo), lo)
    assert float(((hi.double() + lo.double() - x.double()).abs() / x.abs()).max()) < 2.0 ** -21


@pytest.mark.parametrize("final", FINALS)
@pytest.mark.parametrize("n", (100, 513))
def test_three_passes_meet_the_float64_tolerance(n, final):
    x, ws, bs = _serving_case(n)
    assert _over_tol_against_float64(_emulated_kernel(x, ws, bs, final), x, ws, bs, final) <= 1.0


def test_one_pass_misses_the_float64_tolerance():
    x, ws, bs = _serving_case(513)
    got = _emulated_kernel(x, ws, bs, "none", passes=1)
    assert _over_tol_against_float64(got, x, ws, bs, "none") > 50.0


def test_a_truncating_sum_over_the_layer_misses_without_the_fold():
    x, ws, bs = _serving_case(513)
    got = _emulated_kernel(x, ws, bs, "none", fold=False)
    assert _over_tol_against_float64(got, x, ws, bs, "none") > 1.0


# ------------------------------------------------------ which kernel runs
# Input widths (hidden sizes by the reference's rule, 30 outputs): the
# kernel, the tensor-core kernel's shared memory and the SIMT kernel's rows
# per block, against one block's 232,448 bytes on an H100.
WIDTH_CASES = [
    (5, "tensor_core", 190_464, 32),
    (133, "tensor_core", 192_512, 32),   # the serving widths
    (256, "tensor_core", 223_232, 32),
    (257, "simt", 227_328, 32),          # a 257-wide hidden layer
    (1100, "simt", 657_408, 16),
    (2000, "simt", 1_116_160, 8),
]


@pytest.mark.parametrize("d0,variant,tc_bytes,simt_rows", WIDTH_CASES)
def test_kernel_variant_follows_the_widths(d0, variant, tc_bytes, simt_rows):
    dims = (d0, *hidden_sizes(d0), 30)
    assert fused_mlp.tc_smem_bytes(dims) == tc_bytes
    assert fused_mlp.simt_tile_rows(dims) == simt_rows
    assert fused_mlp.kernel_variant(dims) == variant


def test_tensor_core_shared_memory_arithmetic():
    """Fixed tiles (two split stages of 4096 weights, 32 KB each, the
    landing area, 20 KB, and the biases, 4 KB), then 64 rows of the two
    activation buffers at pitches max(K) rounded up to 8, plus 4. At d0 ->
    256 -> 256 -> 256 -> 30 the limit falls between d0 288 and 289."""
    assert fused_mlp.tc_layout((133, 256, 128, 64, 30)) == (140, 260,
                                                            90_112 + 256 * (140 + 260))
    fits, over = (288, 256, 256, 256, 30), (289, 256, 256, 256, 30)
    assert fused_mlp.tc_smem_bytes(fits) == 231_424 <= fused_mlp.SMEM_LIMIT
    assert fused_mlp.tc_smem_bytes(over) == 233_472 > fused_mlp.SMEM_LIMIT
    assert fused_mlp.kernel_variant(fits) == "tensor_core"
    assert fused_mlp.kernel_variant(over) == "simt"
    assert fused_mlp.kernel_variant((133, 256, 128, 64, 300)) == "simt"  # output > 256


def test_widths_that_fit_no_kernel_raise():
    with pytest.raises(ValueError, match="shared memory"):
        fused_mlp.kernel_variant((4000, *hidden_sizes(4000), 30))
