"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and `nvcc`; without a card every one of
them skips. They import neither JAX nor the JAX package, so on a machine
that has no JAX they run without the repository's `conftest.py`:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

`chip_smoke.py` holds the same kernels to the same plain versions at the
serving shapes; these add the other layer widths the fused MLP kernels
take at run time (the hidden sizes grow with the input width), which of
its two kernels each width takes, its shared-memory limits, the
block-attention kernels over every head dim and ragged sequence lengths,
and the wrappers' launch checks.
"""

import copy

import numpy as np
import pytest
import torch

from cvaegan_tpu_torch import CVAEGAN
from cvaegan_tpu_torch.core.state import apply_eval, apply_train
from cvaegan_tpu_torch.core.losses import AttentionRowEntropy
from cvaegan_tpu_torch.kernels import block_attention, fused_mlp
from cvaegan_tpu_torch.models.attention import (
    MultiHeadSelfAttention,
    ResidualAttentionBlock,
)
from cvaegan_tpu_torch.models.layers import hidden_sizes, one_hot

pytestmark = pytest.mark.cuda

FINALS = ("sigmoid", "tanh", "none")
NS = (1, 7, 100, 511, 513, 4096)
# Input widths and the kernel each one takes: 5 and 133 (the serving
# width) the tensor-core kernel; 1100 (hidden layers 1100 wide) the SIMT
# kernel at 16 rows per block, 2000 at 8.
IN_WIDTHS = (5, 133, 1100, 2000)
VARIANTS = {5: "tensor_core", 133: "tensor_core", 1100: "simt", 2000: "simt"}
OUT = 30


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _mlp(d0, device, seed=0, dims=None):
    dims = dims or (d0, *hidden_sizes(d0), OUT)
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal((dims[i], dims[i + 1])) / np.sqrt(dims[i])
          for i in range(4)]
    bs = [0.1 * rng.standard_normal(dims[i + 1]) for i in range(4)]
    return ([torch.tensor(w, dtype=torch.float32, device=device) for w in ws],
            [torch.tensor(b, dtype=torch.float32, device=device) for b in bs])


def _tolerance(d0):
    # The kernels are held to the plain version run in float64. A float32
    # sum of K unit-scale terms rounds by ~sqrt(K), so the absolute
    # tolerance of the serving widths (K <= 256) is scaled by sqrt(K / 256)
    # for the wider layers.
    k = max(d0, *hidden_sizes(d0))
    return dict(rtol=1e-5, atol=1e-6 * max(1.0, float(np.sqrt(k / 256))))


def _exact(x, ws, bs, final):
    """The plain version in float64: the yardstick of both kernels (three
    TF32 passes and float32 FMA each round differently from float32 GEMMs)."""
    return fused_mlp.mlp4_reference(x.double(), [w.double() for w in ws],
                                    [b.double() for b in bs], final=final)


def _counts():
    return fused_mlp.TC_LAUNCHES, fused_mlp.SIMT_LAUNCHES, fused_mlp.LAUNCHES


def _moved(before, variant):
    tc, simt, total = before
    return (tc + (variant == "tensor_core"), simt + (variant == "simt"), total + 1)


@pytest.mark.parametrize("final", FINALS)
@pytest.mark.parametrize("d0", IN_WIDTHS)
def test_fused_mlp4_matches_plain(device, d0, final):
    ws, bs = _mlp(d0, device)
    assert fused_mlp.kernel_variant([d0, *(w.shape[1] for w in ws)]) == VARIANTS[d0]
    for n in NS:
        x = torch.tensor(np.random.default_rng(n).standard_normal((n, d0),
                                                                  dtype=np.float32),
                         device=device)
        before = _counts()
        got = fused_mlp.fused_mlp4(x, ws, bs, final=final)
        torch.cuda.synchronize()
        assert _counts() == _moved(before, VARIANTS[d0])
        assert got.shape == (n, OUT)
        torch.testing.assert_close(got.double(), _exact(x, ws, bs, final),
                                   **_tolerance(d0))


@pytest.mark.parametrize("variant", ("tensor_core", "simt"))
def test_both_kernels_match_float64_at_the_serving_widths(device, variant):
    """The SIMT kernel too runs the serving widths (`chip_smoke.py` times
    the two there), through the private launch."""
    ws, bs = _mlp(133, device)
    for n in NS:
        x = torch.tensor(np.random.default_rng(n).standard_normal((n, 133),
                                                                  dtype=np.float32),
                         device=device)
        for final in FINALS:
            before = _counts()
            got = fused_mlp._launch(variant, x, ws, bs, final)
            torch.cuda.synchronize()
            assert _counts() == _moved(before, variant)
            torch.testing.assert_close(got.double(), _exact(x, ws, bs, final),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d0,variant", [(288, "tensor_core"), (289, "simt")])
def test_variant_rule_matches_the_card(device, monkeypatch, d0, variant):
    """At the edge of the tensor-core kernel's shared memory (widths
    d0 -> 256 -> 256 -> 256 -> 30: 231,424 bytes at d0 288, 233,472 at 289)
    the rule's choice launches and is right, and the launch refuses a
    layout 4 bytes short of the kernel's own carve-up."""
    dims = (d0, 256, 256, 256, OUT)
    assert fused_mlp.kernel_variant(dims) == variant
    ws, bs = _mlp(d0, device, dims=dims)
    pa, pb, nbytes = fused_mlp.tc_layout(dims)
    with monkeypatch.context() as m:
        m.setattr(fused_mlp, "tc_layout", lambda _: (pa, pb, nbytes - 4))
        before = _counts()
        with pytest.raises(RuntimeError, match="launch failed"):
            fused_mlp._launch("tensor_core", torch.randn(8, d0, device=device), ws, bs,
                              "none")
        assert _counts() == before
    x = torch.randn(300, d0, device=device)
    before = _counts()
    got = fused_mlp.fused_mlp4(x, ws, bs, final="none")
    torch.cuda.synchronize()
    assert _counts() == _moved(before, variant)
    torch.testing.assert_close(got.double(), _exact(x, ws, bs, "none"),
                               **_tolerance(d0))


@pytest.mark.parametrize("dims", [(133, 200, 72, 40, 30), (7, 136, 17, 9, 3)])
def test_tensor_core_kernel_at_ragged_widths(device, dims):
    """Widths whose n-tiles do not fill every warp's share (the kernel
    multiplies those tiles and stores none of them), K not a multiple of
    8, and rows that are not 16-byte aligned (copied a float at a time)."""
    assert fused_mlp.kernel_variant(dims) == "tensor_core"
    ws, bs = _mlp(dims[0], device, dims=dims)
    for n in (1, 100, 513):
        x = torch.randn(n, dims[0], device=device)
        for final in FINALS:
            before = _counts()
            got = fused_mlp.fused_mlp4(x, ws, bs, final=final)
            torch.cuda.synchronize()
            assert _counts() == _moved(before, "tensor_core")
            assert got.shape == (n, dims[-1])
            torch.testing.assert_close(got.double(), _exact(x, ws, bs, final),
                                       rtol=1e-5, atol=1e-6)


def test_fused_mlp4_rejects_what_it_cannot_run(device):
    ws, bs = _mlp(133, device)
    x = torch.randn(64, 266, device=device)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fused_mlp.fused_mlp4(x, ws, bs)
    with pytest.raises(ValueError, match="one device"):
        fused_mlp.fused_mlp4(torch.zeros(4, 133, device=device), ws[:3] + [ws[3].cpu()], bs)
    wide_ws, wide_bs = _mlp(4000, device)
    before = _counts()
    with pytest.raises(ValueError, match="shared memory"):
        fused_mlp.fused_mlp4(torch.zeros(4, 4000, device=device), wide_ws, wide_bs)
    assert _counts() == before
    empty = fused_mlp.fused_mlp4(torch.zeros(0, 133, device=device), ws, bs)
    assert empty.shape == (0, OUT)


def test_generate_samples_fast_launches_the_kernel(device):
    rng = np.random.default_rng(0)
    x = rng.random((500, 30), dtype=np.float32)
    y = (np.arange(500) % 5).astype(np.int32)
    model = CVAEGAN(seed=0, device="cuda")
    model._prepare((x, y))
    gen = model.state["generator"]
    apply_train(gen, 2.0 * torch.randn(256, 128, device=device),
                torch.arange(256, device=device) % 5)
    before = _counts()
    s = model.generate_samples_fast(2, 1000)
    assert _counts() == _moved(before, "tensor_core")  # the serving widths
    assert s.shape == (1000, 30) and np.isfinite(s).all()
    z = torch.randn(1000, 128, device=device)
    labels = torch.full((1000,), 2, device=device)
    fast = fused_mlp.fast_generator_forward(gen, z, one_hot(labels, 5))
    # Against the module's eval forward on a float64 copy of the generator.
    module_out, _ = apply_eval(copy.deepcopy(gen).double(), z.double(), labels)
    assert module_out.dtype == torch.float64
    torch.testing.assert_close(fast.double(), module_out, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------- block attention
# Kernel against plain version: float32 sums in another order and exp/log
# rounding, so the JAX tests' tolerance (`tests/test_kernels.py:99-100`).
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
ATTN_SEQS = (1, 7, 100, 127, 128, 129, 256, 1000)


def _qkv(bh, seq, d, device, seed=0, scale=1.0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [scale * torch.randn(bh, seq, d, generator=g, device=device)
            for _ in range(3)]


@pytest.mark.parametrize("d", block_attention.HEAD_DIMS)
def test_block_attention_matches_plain(device, d):
    for seq in ATTN_SEQS:
        for bh in (1, 8):
            q, k, v = _qkv(bh, seq, d, device, seed=seq)
            before = block_attention.LAUNCHES
            got = block_attention.block_attention(q, k, v)
            torch.cuda.synchronize()
            assert block_attention.LAUNCHES == before + 1
            torch.testing.assert_close(
                got, block_attention.block_attention_reference(q, k, v), **ATTN_TOL)


@pytest.mark.parametrize("scale", (1.0, 10.0))
@pytest.mark.parametrize("d", block_attention.HEAD_DIMS)
def test_block_attention_with_entropy_matches_plain(device, d, scale):
    """Scale 10 makes peaked rows, where m + log l - sl / l would cancel.
    There near-tie rows swing with float32 rounding, so the kernel is held
    to the plain version run in float64 by `float64_rule`."""
    for seq in ATTN_SEQS:
        q, k, v = _qkv(4, seq, d, device, seed=seq, scale=scale)
        before = block_attention.ENTROPY_LAUNCHES
        out, ent = block_attention.block_attention_with_entropy(q, k, v)
        torch.cuda.synchronize()
        assert block_attention.ENTROPY_LAUNCHES == before + 1
        want_out, want_ent = block_attention.block_attention_with_entropy_reference(q, k, v)
        assert ent.shape == (4, seq)
        if scale == 1.0:
            torch.testing.assert_close(out, want_out, **ATTN_TOL)
            torch.testing.assert_close(ent, want_ent, **ATTN_TOL)
            continue
        exact = block_attention.block_attention_with_entropy_reference(
            q.double(), k.double(), v.double())
        for got, plain, want in zip((out, ent), (want_out, want_ent), exact):
            assert want.dtype == torch.float64
            err, ratio = block_attention.float64_rule(got, plain, want,
                                                      ATTN_TOL["atol"])
            assert ratio <= 1.0, (seq, err, ratio)


def test_block_attention_rejects_what_it_cannot_run(device):
    q, k, v = _qkv(2, 64, 32, device)
    before = (block_attention.LAUNCHES, block_attention.ENTROPY_LAUNCHES)
    for fn in (block_attention.block_attention, block_attention.block_attention_with_entropy):
        with pytest.raises(ValueError, match="head dim"):
            fn(*_qkv(2, 64, 48, device))
        with pytest.raises(TypeError, match="float32"):
            fn(q.half(), k.half(), v.half())
        with pytest.raises(ValueError, match="contiguous"):
            fn(q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1))
        with pytest.raises(ValueError, match="aligned"):
            flat = torch.randn(2 * 64 * 32 + 1, device=device)[1:].view(2, 64, 32)
            fn(flat, k, v)
        with pytest.raises(ValueError, match="one device"):
            fn(q, k.cpu(), v)
        with pytest.raises(RuntimeError, match="forward-only"):
            fn(q.clone().requires_grad_(), k, v)
    assert (block_attention.LAUNCHES, block_attention.ENTROPY_LAUNCHES) == before
    empty = block_attention.block_attention(*_qkv(0, 64, 32, device))
    assert empty.shape == (0, 64, 32)


def test_attention_auto_dispatch_launches_once_per_forward(device):
    """At seq >= 128, a multiple of 128, on CUDA: one B3 launch per
    forward, and the same output and row entropies as the dense path."""
    g = torch.Generator().manual_seed(0)
    block = ResidualAttentionBlock(64, 64)
    with torch.no_grad():  # unit-scale scores: neither uniform nor one-hot
        for p in block.parameters():
            p.normal_(0.0, p.shape[-1] ** -0.5 if p.dim() == 2 else 0.1, generator=g)
    block = block.to(device).eval()
    dense = MultiHeadSelfAttention(64, 4, use_kernel=False).to(device)
    dense.load_state_dict(block.attention.state_dict())
    x = torch.randn(2, 256, 64, generator=g).to(device)
    before = block_attention.ENTROPY_LAUNCHES
    with torch.no_grad():
        out, stats = block.attention(x)
        block(x)
        want_out, probs = dense(x)
    torch.cuda.synchronize()
    assert block_attention.ENTROPY_LAUNCHES == before + 2
    assert isinstance(stats, AttentionRowEntropy) and stats.value.shape == (2, 4, 256)
    torch.testing.assert_close(out, want_out, **ATTN_TOL)
    dense_ent = -(probs * torch.log(probs + 1e-12)).sum(-1)
    torch.testing.assert_close(stats.value, dense_ent, rtol=2e-4, atol=2e-5)
    with torch.no_grad():
        _, short = block.attention(x[:, :100])
    assert short.shape == (2, 4, 100, 100)
    assert block_attention.ENTROPY_LAUNCHES == before + 2


def test_attention_auto_dispatch_raises_for_a_head_dim_the_kernel_lacks(device):
    """Auto dispatch is the JAX rule with CUDA for TPU: a head dim of 48 at
    seq 128 goes to the kernel, which raises rather than falling back."""
    mhsa = MultiHeadSelfAttention(192, 4).to(device).eval()
    before = block_attention.ENTROPY_LAUNCHES
    with torch.no_grad(), pytest.raises(ValueError, match="head dim"):
        mhsa(torch.randn(2, 128, 192, device=device))
    assert block_attention.ENTROPY_LAUNCHES == before
