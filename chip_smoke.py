#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`cvaegan_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's serving paths at full width with random weights made
from a seed, on `cuda:0`: the flagship CVAE-GAN (30 features, 5 classes,
z 128, generator 133->256->128->64->30), the RAIN-GAN (the same widths;
four pre-LN residual-attention networks over singleton sequences), and the
long-sequence attention stack that reaches the block-attention kernels:

  1. environment: torch/CUDA versions, card name and power limit; TF32 off;
  2. build: compiles every kernel source from `cvaegan_tpu_torch/csrc`, one
     `nvcc` each, all at once;
  3. kernel against plain: each kernel's wrapper against its plain PyTorch
     version on the card, at the paths' shapes and over the head dims and
     ragged sequence lengths the attention kernels take; both fused MLP
     kernels (tensor-core and SIMT) are held to the plain version run in
     float64, and so are the attention kernels at inputs of scale 10
     (`float64_rule` of `kernels/block_attention.py`);
  4. slice: `generate_samples`, `generate_samples_fast`,
     `generate_qualified_samples` and `reconstruct_samples` for every
     class of the CVAE-GAN, then the RAIN-GAN's entry points and
     `visualize_attention`, then eval forwards of residual attention
     blocks at sequences of 1024 and 8192 (`long_seq`); each path runs with
     the kernels' launch counts set to 0 just before and read just after;
  5. timing: CUDA events in alternating rounds, after warm-up, beside each
     kernel's bound: the two fused MLP kernels and the plain version at
     the serving shape in the same rounds, the attention kernels at T1 and
     T2 with `scaled_dot_product_attention` as the library yardstick of B2
     (and the names of the device kernels it ran), and B3 at the d 32
     launch of the long-sequence path;
  6. breakdown: `torch.profiler` over serving calls and a block forward,
     for the device time per call, its idle share and the kernels that
     take it;
  7. training, on an imbalanced Gaussian-blob stand-in of the blob fixture
     (made with numpy: the card's machine has no sklearn):
     `train_graph_vs_eager` (a one-epoch fit replaying the captured CUDA
     graph against the plain eager epoch, every loss, parameter, buffer and
     Adam tensor at rtol 1e-5, atol 1e-6; after 3 epochs reported only),
     `train` (500-epoch captured fits in strict and balanced mode, gated on
     finite histories, the epoch-0 class loss, the recon loss (falling in
     balanced mode; in strict mode, where the JAX package's own recon loss
     rises, within 5 standard deviations of its last-50 mean over 5 seeds)
     and the companion classifier's training accuracy; qualified yields
     reported),
     `pipeline` (`run_balance_pipeline` end to end: artifact schema, counts,
     macro-F1), then a training `timing` line (epochs/s and steps/s of the
     captured and the eager fit, device time per replayed epoch by CUDA
     events, classifier and pipeline seconds) and `breakdown` lines
     (`torch.profiler` over a replayed and an eager epoch). The kernels'
     launch counts over these phases must read 0: no kernel lies on the
     training path.

Each phase prints one JSON line; then the `kernels` line, the card's name
and power limit as `nvidia-smi` gives them, and as the last line
`{"ok": true, "device": {...}}`. Any failure raises and exits non-zero,
as does a run without CUDA or without the repository beside the script.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import copy
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# Fused MLP tolerance. The tensor-core kernel (three TF32 passes) rounds
# differently from the plain float32 version, which is itself about this
# far from float64, so it is held to the plain version run in float64;
# the SIMT kernel sums in float32 FMA in k order, as the plain version's
# GEMMs do, and is held to the plain float32 version.
RTOL, ATOL = 1e-5, 1e-6
# Block attention vs its plain version: the JAX tests' tolerance
# (`tests/test_kernels.py:99-100,152-155`): float32 sums of seq terms in
# another order, and exp/log rounding in the softmax and the entropy.
ATTN_TOL = 2e-5
# Block forward on the kernel path vs the dense path: the JAX module
# test's tolerance (`tests/test_kernels.py:183-184`).
BLOCK_RTOL, BLOCK_ATOL = 2e-4, 2e-5
ATTN_SEQS = (1, 7, 100, 127, 128, 129, 256, 1000, 1024)
ATTN_BHS = (1, 8)
# Long-sequence shapes at RAIN's 256-wide block (4 heads of d 64):
# x [batch, seq, 256], i.e. kernel inputs [batch * 4, seq, 64].
T1, T2 = (32, 1024), (4, 8192)
HEADS = 4
WIDTHS = (133, 256, 128, 64, 30)
KERNEL_NS = (1, 7, 100, 511, 513, 4096, 8192, 65536)
FINALS = ("sigmoid", "tanh", "none")
FEATURES, CLASSES = 30, 5
SERVE_ROWS = 8192
QUALIFIED_ROWS = 300
RECON_ROWS = 256
# Datasheet peaks: float32 outside the tensor cores, and HBM bandwidth;
# TF32 on the tensor cores (dense), which bounds the kernels that use them.
PEAKS = {"H100 SXM": (67e12, 3.35e12), "H100 PCIe": (51e12, 2.0e12),
         "H100 NVL": (60e12, 3.9e12)}
TF32_PEAKS = {"H100 SXM": 495e12, "H100 PCIe": 378e12, "H100 NVL": 417e12}
# Device cycles (~20 ms) that `cuda_ms` holds the device for while the host
# queues a round of calls: longer than the host takes to launch 50 calls of
# the plain fused MLP version (8 kernels each).
HOLD_CYCLES = 40_000_000
# Training: the captured epoch is held to the eager one at this tolerance
# (both run the same kernels with the same Philox offsets: bitwise
# equality is expected).
TRAIN_RTOL, TRAIN_ATOL = 1e-5, 1e-6
STANDIN_COUNTS = (500, 200, 150, 100, 50)
GAN_EPOCHS, CLF_EPOCHS = 500, 100
STEPS_PER_EPOCH = {"strict": CLASSES * 13, "balanced": 13}
# The JAX package's strict-mode CVAE-GAN on the same stand-in, seeds 0-4,
# on the CPU (`experiments/torch_port_strict_reference.py`): the mean recon
# loss over the last 50 of 500 epochs. In strict mode the reference's recon
# loss rises from epoch 0 (0.089-0.095 on every seed), so the port's strict
# fit is held to these, within 5 standard deviations of their mean, where
# the balanced fit is held to a falling recon loss.
JAX_STRICT_RECON_LAST50 = (0.16611650466918945, 0.1633944422006607,
                           0.16289449065923692, 0.16205778270959853,
                           0.1620414972305298)
REFERENCE_SIGMAS = 5.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return f"H100 {key}", PEAKS[f"H100 {key}"]
    return "H100 SXM", PEAKS["H100 SXM"]


def check(ok, what: str) -> None:
    """Fail the run (unlike `assert`, also under `python -O`)."""
    if not ok:
        raise SystemExit(f"chip_smoke: {what}")


def ptxas_report(log: str):
    """ptxas's registers and spills per kernel of a build log; the block
    attention instantiations are named by head dim (and "entropy" for
    B3), the fused MLP kernels "tensor_core" and "simt <rows>"."""
    report, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
            inst = re.search(r"block_attention_kernelILi(\d+)ELb([01])E", entry)
            if inst:
                entry = f"d{inst[1]}" + (" entropy" if inst[2] == "1" else "")
            elif "tc_kernel" in entry:
                entry = "tensor_core"
            elif inst := re.search(r"simt_kernelILi(\d+)E", entry):
                entry = f"simt {inst[1]}"
            report[entry] = []
        elif entry is not None and ("registers" in ln or "spill" in ln):
            report[entry].append(ln.split("ptxas info    :")[-1].strip())
    return {name: "; ".join(lines) for name, lines in report.items()}


def close_enough(got, ref, rtol=RTOL, atol=ATOL):
    """(max abs error, worst err / (atol + rtol |ref|)); passes at <= 1."""
    err = (got - ref).abs()
    ratio = err / (atol + rtol * ref.abs())
    return float(err.max()), float(ratio.max())


def cuda_ms(torch, fns, iters: int = 100, reps: int = 6, warmup: int = 10):
    """Each function's mean device time over `iters` calls, in ms, timed
    with CUDA events in `reps` rounds in which the functions take turns (a,
    b, b, a, ...). Each round is queued behind a spin kernel that holds the
    device for HOLD_CYCLES, so that the calls run back to back whatever the
    host takes to launch them (a call of B1 takes less device time than its
    Python launch). Returns (the median of each, every round's times of
    each)."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    times = [[] for _ in fns]
    for r in range(reps):
        for i in (range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(HOLD_CYCLES)
            start.record()
            for _ in range(iters):
                fns[i]()
            end.record()
            torch.cuda.synchronize()
            times[i].append(start.elapsed_time(end) / iters)
    return [float(np.median(t)) for t in times], times


def samples_per_s(torch, fns, rows: int, iters: int = 20, reps: int = 6):
    """Each function's rate in rows/s on the host clock (each call returns
    host arrays), over `reps` rounds of `iters` calls in which the
    functions take turns as in `cuda_ms`. Returns the median of each."""
    for fn in fns:
        for _ in range(3):
            fn()
    rates = [[] for _ in fns]
    for r in range(reps):
        for i in (range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fns[i]()
            torch.cuda.synchronize()
            rates[i].append(rows * iters / (time.perf_counter() - t0))
    return [float(np.median(r)) for r in rates]


def breakdown(torch, fn, call_ms: float, calls: int = 10, top: int = 6):
    """Device time of one call of `fn` from a `torch.profiler` trace,
    beside `call_ms`, the call's unprofiled time on the host clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    on_device = sorted((e for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA),
                       key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in on_device) / 1e3 / calls
    if device_ms == 0.0:  # the profiler saw no device activity
        return {"device_ms_per_call": None, "call_ms": call_ms}
    return {"device_ms_per_call": device_ms, "call_ms": call_ms,
            "device_idle_share": 1.0 - device_ms / call_ms,
            "device_ops_per_call": sum(e.count for e in on_device) / calls,
            "top": [[e.key[:60], e.self_device_time_total / 1e3 / calls, e.count / calls]
                    for e in on_device[:top]]}


def fused_counts(fused_mlp):
    return {"tensor_core": fused_mlp.TC_LAUNCHES, "simt": fused_mlp.SIMT_LAUNCHES,
            "total": fused_mlp.LAUNCHES}


def zero_counts(fused_mlp, ba):
    fused_mlp.TC_LAUNCHES = fused_mlp.SIMT_LAUNCHES = fused_mlp.LAUNCHES = 0
    ba.LAUNCHES = ba.ENTROPY_LAUNCHES = 0


def mlp_vs_float64(torch, fused_mlp, rng, device):
    """Both fused MLP kernels (the tensor-core kernel through `fused_mlp4`,
    which the serving widths take, and the SIMT kernel through the private
    launch) over KERNEL_NS x FINALS: each one's distance from the plain
    version in float64 and from the plain float32 version, and the plain
    float32 version's own distance from float64."""
    ws, bs = random_mlp(torch, rng, device)
    ws64, bs64 = [w.double() for w in ws], [b.double() for b in bs]
    check(fused_mlp.kernel_variant(WIDTHS) == "tensor_core",
          "the serving widths do not take the tensor-core kernel")
    stats = {v: {"max_abs_err": 0.0, "err_over_tol": 0.0, "err_over_tol_vs_plain_f32": 0.0}
             for v in ("tensor_core", "simt")}
    plain_worst = 0.0
    for n in KERNEL_NS:
        x = torch.tensor(rng.standard_normal((n, WIDTHS[0]), dtype=np.float32),
                         device=device)
        for final in FINALS:
            exact = fused_mlp.mlp4_reference(x.double(), ws64, bs64, final=final)
            plain = fused_mlp.mlp4_reference(x, ws, bs, final=final)
            check(exact.dtype == torch.float64, "the plain version did not run in float64")
            plain_worst = max(plain_worst, close_enough(plain.double(), exact)[1])
            for variant, got in (("tensor_core", fused_mlp.fused_mlp4(x, ws, bs, final=final)),
                                 ("simt", fused_mlp._launch("simt", x, ws, bs, final))):
                torch.cuda.synchronize()
                check(got.shape == (n, WIDTHS[-1]), f"fused_mlp4 ({variant}) gave shape "
                      f"{tuple(got.shape)}")
                err, ratio = close_enough(got.double(), exact)
                st = stats[variant]
                st["max_abs_err"] = max(st["max_abs_err"], err)
                st["err_over_tol"] = max(st["err_over_tol"], ratio)
                st["err_over_tol_vs_plain_f32"] = max(
                    st["err_over_tol_vs_plain_f32"], close_enough(got, plain)[1])
    return stats, plain_worst


def random_mlp(torch, rng, device):
    ws = [torch.tensor(rng.standard_normal((WIDTHS[i], WIDTHS[i + 1]),
                                           dtype=np.float32) * 0.1, device=device)
          for i in range(4)]
    bs = [torch.tensor(rng.standard_normal(WIDTHS[i + 1], dtype=np.float32) * 0.1,
                       device=device) for i in range(4)]
    return ws, bs


def check_qualified(torch, model, qualified, device):
    """Re-check every row `generate_qualified_samples` returned against the
    filter; returns the yield per class and threshold."""
    default_thr = model.hparams["confidence_threshold"]
    check(sum(len(qualified[(c, 0.0)]) for c in range(CLASSES)) > 0,
          f"{model.name}: no class yields a row at threshold 0: the filter "
          "went unchecked")
    yields = {}
    fstate = model._filter_state(model.state)
    for (c, thr), q in qualified.items():
        thr = default_thr if thr is None else thr
        check(q.shape[1] == FEATURES and len(q) <= QUALIFIED_ROWS,
              f"generate_qualified_samples gave {q.shape}")
        yields[f"{c}@{thr}"] = len(q)
        if len(q):
            probs = torch.softmax(model._classifier_logits(
                fstate, torch.as_tensor(q, device=device)), dim=-1)
            ok = (probs.amax(-1) > thr) & (probs.argmax(-1) == c)
            check(bool(ok.all()), f"{model.name} class {c}: a returned row "
                  "fails the filter")
    return yields


def serve_all_classes(model, entry_points):
    """Every entry point for every class at SERVE_ROWS rows (f32, finite,
    in [0, 1]), and qualified samples at the default threshold and at 0."""
    qualified = {}
    for c in range(CLASSES):
        for fn in entry_points:
            s = fn(c, SERVE_ROWS)
            check(s.shape == (SERVE_ROWS, FEATURES) and s.dtype == np.float32,
                  f"{fn.__name__} gave {s.shape} {s.dtype}")
            check(np.isfinite(s).all() and s.min() >= 0.0 and s.max() <= 1.0,
                  f"{fn.__name__} gave values outside [0, 1]")
        for thr in (None, 0.0):
            qualified[(c, thr)] = model.generate_qualified_samples(
                c, QUALIFIED_ROWS, confidence_threshold=thr)
    return qualified


def attention_vs_plain(torch, ba, device):
    """Both block-attention kernels against their plain versions: over
    head dims x sequence lengths (ragged included) x bh, and at T1 and T2,
    at rtol = atol = ATTN_TOL; and at inputs of scale 10, whose peaked
    rows would make the entropy formula cancel, by `ba.float64_rule`
    against the plain version run in float64 (near-tie rows swing with
    float32 rounding there; see its docstring). Returns {kernel: {case
    group: [max abs err, worst err / limit]}}."""
    g = torch.Generator(device=device).manual_seed(1)
    cases = [("grid", bh, seq, d, 1.0) for d in ba.HEAD_DIMS
             for seq in ATTN_SEQS for bh in ATTN_BHS]
    cases += [("t1", T1[0] * HEADS, T1[1], 64, 1.0),
              ("t2", T2[0] * HEADS, T2[1], 64, 1.0),
              ("scale10", 8, 1024, 64, 10.0)]
    stats = {"block_attention": {}, "block_attention_with_entropy": {}}

    def record(kernel, group, err, ratio):
        old = stats[kernel].get(group, [0.0, 0.0])
        stats[kernel][group] = [max(old[0], err), max(old[1], ratio)]

    for group, bh, seq, d, scale in cases:
        q, k, v = (scale * torch.randn(bh, seq, d, generator=g, device=device)
                   for _ in range(3))
        out = ba.block_attention(q, k, v)
        out_e, ent = ba.block_attention_with_entropy(q, k, v)
        torch.cuda.synchronize()
        check(out.shape == out_e.shape == (bh, seq, d) and ent.shape == (bh, seq),
              f"block attention gave {tuple(out.shape)}, {tuple(ent.shape)}")
        ref_out, ref_ent = ba.block_attention_with_entropy_reference(q, k, v)
        if scale == 1.0:
            for kernel, got, ref in (("block_attention", out, ref_out),
                                     ("block_attention_with_entropy", out_e, ref_out),
                                     ("block_attention_with_entropy", ent, ref_ent)):
                record(kernel, group, *close_enough(got, ref, ATTN_TOL, ATTN_TOL))
            continue
        exact_out, exact_ent = ba.block_attention_with_entropy_reference(
            q.double(), k.double(), v.double())
        check(exact_out.dtype == exact_ent.dtype == torch.float64,
              "the plain version did not run in float64")
        for kernel, got, plain, exact in (
                ("block_attention", out, ref_out, exact_out),
                ("block_attention_with_entropy", out_e, ref_out, exact_out),
                ("block_attention_with_entropy", ent, ref_ent, exact_ent)):
            record(kernel, group, *ba.float64_rule(got, plain, exact, ATTN_TOL))
    return stats


def random_block(torch, input_dim, output_dim, generator, device):
    """A ResidualAttentionBlock with weights ~ N(0, 1/fan_in), biases ~
    N(0, 0.1^2) and LayerNorm scales ~ N(1, 0.1^2): attention scores of
    unit scale, so the softmax is neither uniform nor one-hot."""
    from cvaegan_tpu_torch.models.attention import ResidualAttentionBlock

    block = ResidualAttentionBlock(input_dim, output_dim)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if p.dim() == 2:
                p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
            else:
                p.normal_(1.0 if "norm" in name and name.endswith("weight") else 0.0,
                          0.1, generator=generator)
    return block.to(device).eval()


def attention_bound(part, bh, seq, d, entropy):
    """Least time of one float32-accurate call on the card: the larger of
    QK^T and PV (4 bh seq^2 d FLOP) in three TF32 passes on the tensor
    cores and the entropy's 2 bh seq^2 FLOP at the float32 rate (the two
    pipes overlap), against the bytes (q, k, v read once, out and entropy
    written once) over HBM. The bound of the same work at the float32 rate
    outside the tensor cores stands beside it as `f32_fma_bound_ms`."""
    flop_rate, byte_rate = PEAKS[part]
    products = 4 * bh * seq * seq * d
    extra = 2 * bh * seq * seq if entropy else 0
    nbytes = 4 * (4 * bh * seq * d + (bh * seq if entropy else 0))
    ops_ms = max(3 * products / TF32_PEAKS[part], extra / flop_rate) * 1e3
    bytes_ms = nbytes / byte_rate * 1e3
    return {"flops": products + extra, "tf32_pass_flops": 3 * products,
            "bytes": nbytes, "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "f32_fma_bound_ms": max((products + extra) / flop_rate * 1e3, bytes_ms)}


def mlp_bound(part, x, weights, biases):
    """Least time of one float32-accurate call of the fused MLP: its
    products (2 n sum(K N) FLOP) in three TF32 passes on the tensor cores,
    against the bytes (x, weights and biases read once, the output written
    once) over HBM; the same work at the float32 rate outside the tensor
    cores stands beside it as `f32_fma_bound_ms`."""
    flop_rate, byte_rate = PEAKS[part]
    rows = x.shape[0]
    flops = 2 * rows * sum(w.numel() for w in weights)
    nbytes = 4 * (x.numel() + sum(w.numel() for w in weights)
                  + sum(b.numel() for b in biases) + rows * weights[-1].shape[1])
    ops_ms = 3 * flops / TF32_PEAKS[part] * 1e3
    bytes_ms = nbytes / byte_rate * 1e3
    return {"flops": flops, "tf32_pass_flops": 3 * flops, "bytes": nbytes,
            "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "f32_fma_bound_ms": max(flops / flop_rate * 1e3, bytes_ms)}


def standin_dataset(TabularDataset, minmax_scale):
    """The blob fixture's shape without sklearn: 5 Gaussian blobs (centres
    uniform in [-10, 10], std 1, as `make_blobs` draws them) in 30
    dimensions, 1000 rows of 500/200/150/100/50 per class, min-max scaled
    to [0, 1], split 900/100 at random."""
    rng = np.random.default_rng(0)
    centres = rng.uniform(-10.0, 10.0, (CLASSES, FEATURES))
    x = np.concatenate([centres[c] + rng.standard_normal((n, FEATURES))
                        for c, n in enumerate(STANDIN_COUNTS)]).astype(np.float32)
    y = np.repeat(np.arange(CLASSES), STANDIN_COUNTS).astype(np.int32)
    perm = rng.permutation(len(y))
    x, y = minmax_scale(x[perm]), y[perm]
    return TabularDataset(x[:900], y[:900], x[900:], y[900:], name="blob_standin")


def train_settings(config, epochs):
    settings = config.Settings()
    settings.gan.epochs = epochs
    settings.classifier.epochs = CLF_EPOCHS
    return settings


def state_tensors(model):
    """Every parameter, buffer and Adam tensor of a trainer, in one order."""
    return [t.detach() for t in model._static_tensors()]


def compare_fits(torch, a, b):
    """(max abs difference, worst err / tolerance, bitwise equal) of two
    trainers' loss histories and state tensors."""
    pairs = [(torch.tensor(a.loss_history[k], dtype=torch.float64),
              torch.tensor(b.loss_history[k], dtype=torch.float64)) for k in a.loss_keys]
    pairs += [(x.double(), y.double()) for x, y in zip(state_tensors(a), state_tensors(b))]
    err = ratio = 0.0
    for x, y in pairs:
        e, r = close_enough(x, y, TRAIN_RTOL, TRAIN_ATOL)
        err, ratio = max(err, e), max(ratio, r)
    return err, ratio, all(torch.equal(x, y) for x, y in pairs)


class ReplayCounter:
    """Counts `CUDAGraph.replay` calls and calls of a trainer class's
    `_epoch` (the epoch function, which a capture calls once)."""

    def __init__(self, torch, trainer_cls):
        self.replays = self.epochs = 0
        replay, epoch = torch.cuda.CUDAGraph.replay, trainer_cls._epoch
        counter = self

        def counted_replay(graph):
            counter.replays += 1
            return replay(graph)

        def counted_epoch(model):
            counter.epochs += 1
            return epoch(model)

        torch.cuda.CUDAGraph.replay = counted_replay
        trainer_cls._epoch = counted_epoch
        self._originals = (torch.cuda.CUDAGraph, replay, trainer_cls, epoch)

    def restore(self):
        graph_cls, replay, trainer_cls, epoch = self._originals
        graph_cls.replay, trainer_cls._epoch = replay, epoch

    def reset(self):
        self.replays = self.epochs = 0


def train_checks(torch, model, ds, mode):
    """The gates of one 500-epoch fit, and its qualified yield per class.
    Returns (report, the gates that missed)."""
    hist = {k: np.asarray(v) for k, v in model.loss_history.items()}
    missed = []
    if set(hist) != set(model.loss_keys):
        missed.append(f"{mode}: history keys {sorted(hist)}")
    for k, v in hist.items():
        if not (len(v) == GAN_EPOCHS and np.isfinite(v).all()):
            missed.append(f"{mode}: {k} has {len(v)} entries or non-finite values")
    class0 = float(hist["class_loss"][0])
    if abs(class0 - np.log(CLASSES)) > 0.3:
        missed.append(f"{mode}: epoch-0 class loss {class0}, not within 0.3 of ln 5")
    recon_first, recon_last50 = float(hist["recon_loss"][0]), float(hist["recon_loss"][-50:].mean())
    if mode == "balanced" and not recon_last50 < recon_first:
        missed.append(f"{mode}: recon loss did not fall ({recon_first} -> {recon_last50})")
    ref_mean = float(np.mean(JAX_STRICT_RECON_LAST50))
    ref_band = REFERENCE_SIGMAS * float(np.std(JAX_STRICT_RECON_LAST50, ddof=1))
    if mode == "strict" and abs(recon_last50 - ref_mean) > ref_band:
        missed.append(f"{mode}: last-50 recon loss {recon_last50} outside the JAX "
                      f"reference's {ref_mean} +- {ref_band}")
    x = torch.as_tensor(ds.tr_samples, device=model.device)
    pred = model._classifier_logits(model.state, x).argmax(-1).cpu().numpy()
    accuracy = float(np.mean(pred == ds.tr_labels))
    if accuracy < 0.95:
        missed.append(f"{mode}: companion classifier accuracy {accuracy} < 0.95")
    counts = np.bincount(ds.tr_labels, minlength=CLASSES)
    fstate = model._filter_state(model.state)
    thr = model.hparams["confidence_threshold"]
    yields = {}
    for c in range(CLASSES):
        need = int(counts.max() - counts[c])
        q = model.generate_qualified_samples(c, need)
        check(q.shape[1] == FEATURES and len(q) <= need, f"{mode}: qualified {q.shape}")
        if len(q):
            probs = torch.softmax(model._classifier_logits(
                fstate, torch.as_tensor(q, device=model.device)), dim=-1)
            ok = (probs.amax(-1) > thr) & (probs.argmax(-1) == c)
            check(bool(ok.all()), f"{mode} class {c}: a qualified row fails the filter")
        yields[str(c)] = [len(q), need]
    report = {"recon_gate": ("falls below epoch 0" if mode == "balanced" else
                             f"last-50 mean within {ref_mean} +- {ref_band} (JAX, seeds 0-4)"),
              "epoch0": {k: float(v[0]) for k, v in hist.items()},
              "last50_mean": {k: float(v[-50:].mean()) for k, v in hist.items()},
              "mean_by_100_epochs": {k: [float(v[i:i + 100].mean())
                                         for i in range(0, len(v), 100)]
                                     for k, v in hist.items()},
              "companion_train_accuracy": accuracy, "qualified_yield_of_need": yields}
    return report, missed

def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cvaegan_tpu_torch import CVAEGAN, RAIN_GAN
    from cvaegan_tpu_torch.core.losses import AttentionRowEntropy
    from cvaegan_tpu_torch.core.state import apply_eval, apply_train
    from cvaegan_tpu_torch.kernels import _build, fused_mlp
    from cvaegan_tpu_torch.kernels import block_attention as ba
    from cvaegan_tpu_torch.models.layers import one_hot

    device = torch.device("cuda:0")
    torch.cuda.set_device(device)

    # 1. environment ---------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi("name,power.limit")
    part, _ = peaks_for(card)
    emit({"phase": "environment", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "card": card, "device_count": torch.cuda.device_count()})

    # 2. build: one nvcc per source, all started together --------------------
    sources = {"fused_mlp4": fused_mlp.SOURCE, "block_attention": ba.SOURCE}

    def timed_build(source):
        t = time.perf_counter()
        _build.build(source)
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        seconds = dict(zip(sources.values(), pool.map(timed_build, sources.values())))
    fused_mlp.build()
    ba.build()
    emit({"phase": "build", "wall_seconds": time.perf_counter() - t0})
    for kernel, source in sources.items():
        log = _build.library_path(source).with_suffix(".log").read_text()
        emit({"phase": "build", "kernel": kernel, "seconds": seconds[source],
              "ptxas": ptxas_report(log)})

    # 3. kernels against plain -----------------------------------------------
    rng = np.random.default_rng(0)
    mlp_stats, mlp_plain_worst = mlp_vs_float64(torch, fused_mlp, rng, device)
    emit({"phase": "kernel_vs_plain", "kernel": "fused_mlp4", "ns": KERNEL_NS,
          "finals": FINALS, "rtol": RTOL, "atol": ATOL,
          "gated": {"tensor_core": "float64", "simt": "plain float32"},
          "by_variant": mlp_stats, "plain_f32_err_over_tol": mlp_plain_worst})
    tc_worst = mlp_stats["tensor_core"]["err_over_tol"]
    simt_worst = mlp_stats["simt"]["err_over_tol_vs_plain_f32"]
    check(tc_worst <= 1.0, "fused_mlp4 (tensor_core) disagrees with mlp4_reference "
          f"in float64 ({tc_worst})")
    check(simt_worst <= 1.0, f"fused_mlp4 (simt) disagrees with mlp4_reference ({simt_worst})")

    attn_stats = attention_vs_plain(torch, ba, device)
    attn_err = {}  # over the unit-scale groups: scale 10 has its own rule
    for kernel, groups in attn_stats.items():
        attn_err[kernel] = max(e for group, (e, _) in groups.items() if group != "scale10")
        attn_worst = max(r for _, r in groups.values())
        emit({"phase": "kernel_vs_plain", "kernel": kernel, "seqs": ATTN_SEQS,
              "head_dims": ba.HEAD_DIMS, "bhs": ATTN_BHS,
              "t1": [T1[0] * HEADS, T1[1], 64], "t2": [T2[0] * HEADS, T2[1], 64],
              "scale10": [8, 1024, 64], "scale10_rule": "float64_rule",
              "rtol": ATTN_TOL, "atol": ATTN_TOL,
              "by_case": groups, "max_abs_err": attn_err[kernel],
              "worst_err_over_tol": attn_worst})
        check(attn_worst <= 1.0, f"{kernel} disagrees with its plain version "
              f"({attn_worst})")

    # 4a. slice: CVAE-GAN ----------------------------------------------------
    x_np = rng.random((1000, FEATURES), dtype=np.float32)
    y_np = (np.arange(1000) % CLASSES).astype(np.int32)
    model = CVAEGAN(seed=0, device="cuda")
    model._prepare((x_np, y_np))
    gen = model.state["generator"]
    # One train-mode forward under no-grad moves the BatchNorm running
    # statistics off their initial values, so the fold is not trivial.
    z_bn = 2.0 * torch.randn((512, model.gan_cfg.z_size), generator=model.generator,
                             device=device)
    apply_train(gen, z_bn, torch.arange(512, device=device) % CLASSES)

    zero_counts(fused_mlp, ba)
    qualified = serve_all_classes(
        model, (model.generate_samples, model.generate_samples_fast))
    recon = model.reconstruct_samples(x_np[:RECON_ROWS], y_np[:RECON_ROWS])
    torch.cuda.synchronize()
    launches = fused_counts(fused_mlp)
    attn_launches = (ba.LAUNCHES, ba.ENTROPY_LAUNCHES)

    check(launches == {"tensor_core": CLASSES, "simt": 0, "total": CLASSES},
          f"fused_mlp4 launches on the path: {launches}")
    check(attn_launches == (0, 0), f"attention kernels launched {attn_launches} "
          "times on the CVAE-GAN path")
    check(recon.shape == (RECON_ROWS, FEATURES) and np.isfinite(recon).all(),
          "reconstruct_samples gave a wrong shape or non-finite values")
    yields = check_qualified(torch, model, qualified, device)

    z = torch.randn((SERVE_ROWS, model.gan_cfg.z_size), generator=model.generator,
                    device=device)
    labels = torch.arange(SERVE_ROWS, device=device) % CLASSES
    onehot = one_hot(labels, CLASSES)
    with torch.no_grad():
        fast = fused_mlp.fast_generator_forward(gen, z, onehot)
    # The module's eval forward on a float64 copy of the generator.
    module_out, _ = apply_eval(copy.deepcopy(gen).double(), z.double(), labels)
    module_f32, _ = apply_eval(gen, z, labels)
    check(module_out.dtype == torch.float64, "the module did not run in float64")
    slice_err, slice_ratio = close_enough(fast.double(), module_out)
    emit({"phase": "slice", "model": "cvae_gan", "features": FEATURES,
          "classes": CLASSES, "rows_per_call": SERVE_ROWS,
          "fused_launches": launches, "qualified_rows": yields,
          "recon_shape": list(recon.shape),
          "fused_vs_module_max_abs_err": slice_err,
          "fused_vs_module_err_over_tol": slice_ratio,
          "module_f32_err_over_tol": close_enough(module_f32.double(), module_out)[1],
          "fused_vs_module_f32_err_over_tol": close_enough(fast, module_f32)[1]})
    check(slice_ratio <= 1.0, "fused generator path disagrees with the module")

    # 4b. slice: RAIN-GAN (singleton sequences: the dense attention branch) --
    rain = RAIN_GAN(seed=0, device="cuda")
    rain._prepare((x_np, y_np))
    zero_counts(fused_mlp, ba)
    rain_qualified = serve_all_classes(rain, (rain.generate_samples,))
    rain_recon = rain.reconstruct_samples(x_np[:RECON_ROWS], y_np[:RECON_ROWS])
    attention = rain.visualize_attention(x_np[:RECON_ROWS], y_np[:RECON_ROWS])
    try:
        rain.generate_samples_fast(0, SERVE_ROWS)
        fast_raised = False
    except NotImplementedError:
        fast_raised = True
    torch.cuda.synchronize()
    rain_launches = (fused_mlp.LAUNCHES, ba.LAUNCHES, ba.ENTROPY_LAUNCHES)

    check(rain_launches == (0, 0, 0), "kernels launched on the RAIN-GAN serving "
          f"path (fused, B2, B3): {rain_launches}")
    check(fast_raised, "RAIN_GAN.generate_samples_fast did not raise")
    check(rain_recon.shape == (RECON_ROWS, FEATURES) and np.isfinite(rain_recon).all(),
          "RAIN-GAN reconstruct_samples gave a wrong shape or non-finite values")
    for key, maps in attention.items():
        check(maps.shape == (RECON_ROWS, HEADS, 1, 1) and (maps == 1.0).all(),
              f"visualize_attention {key}: {maps.shape}, not all ones")
    rain_yields = check_qualified(torch, rain, rain_qualified, device)
    emit({"phase": "slice", "model": "rain_gan", "features": FEATURES,
          "classes": CLASSES, "rows_per_call": SERVE_ROWS,
          "launches_fused_b2_b3": rain_launches, "qualified_rows": rain_yields,
          "recon_shape": list(rain_recon.shape),
          "attention_shapes": {k: list(v.shape) for k, v in attention.items()},
          "generate_samples_fast_raises": fast_raised})

    # 4c. slice: long-sequence attention through the auto dispatch ----------
    g = torch.Generator().manual_seed(0)
    gd = torch.Generator(device=device).manual_seed(0)
    wide = random_block(torch, 256, 256, g, device)
    narrow = random_block(torch, 128, 64, g, device)  # the generator's third block
    runs = [("t1", wide, T1), ("t2", wide, T2), ("d32", narrow, (32, 1024))]
    xs = {name: torch.randn(*shape, blk.norm1.weight.shape[0], generator=gd,
                            device=device) for name, blk, shape in runs}
    qkv_t1 = [torch.randn(T1[0] * HEADS, T1[1], 64, generator=gd, device=device)
              for _ in range(3)]
    zero_counts(fused_mlp, ba)
    kernel_outs = {}
    with torch.no_grad():
        for name, blk, _ in runs:
            before = ba.ENTROPY_LAUNCHES
            kernel_outs[name] = blk(xs[name])
            check(ba.ENTROPY_LAUNCHES == before + 1,
                  f"long_seq {name}: B3 launched {ba.ENTROPY_LAUNCHES - before} times")
        b2_out = ba.block_attention(*qkv_t1)
    torch.cuda.synchronize()
    long_launches = (fused_mlp.LAUNCHES, ba.LAUNCHES, ba.ENTROPY_LAUNCHES)
    check(long_launches == (0, 1, len(runs)), "long_seq launches (fused, B2, B3): "
          f"{long_launches}")

    long_report = {}
    for name, blk, shape in runs:
        out, stats = kernel_outs[name]
        check(isinstance(stats, AttentionRowEntropy)
              and stats.value.shape == (shape[0], HEADS, shape[1]),
              f"long_seq {name}: the kernel path gave no row entropies")
        blk.attention.use_kernel = False
        with torch.no_grad():
            dense_out, probs = blk(xs[name])
            dense_ent = -(probs * torch.log(probs + 1e-12)).sum(-1)
        del probs
        blk.attention.use_kernel = None
        out_err, out_ratio = close_enough(out, dense_out, BLOCK_RTOL, BLOCK_ATOL)
        ent_err, ent_ratio = close_enough(stats.value, dense_ent, BLOCK_RTOL, BLOCK_ATOL)
        long_report[name] = {"x": list(xs[name].shape), "out_max_abs_err": out_err,
                             "out_err_over_tol": out_ratio,
                             "entropy_max_abs_err": ent_err,
                             "entropy_err_over_tol": ent_ratio,
                             "mean_row_entropy": float(stats.value.mean())}
        check(max(out_ratio, ent_ratio) <= 1.0,
              f"long_seq {name}: kernel path disagrees with the dense path "
              f"(worst err / tol: output {out_ratio}, entropy {ent_ratio})")
    b2_err, b2_ratio = close_enough(b2_out, ba.block_attention_reference(*qkv_t1),
                                    ATTN_TOL, ATTN_TOL)
    check(b2_ratio <= 1.0, f"long_seq: block_attention disagrees ({b2_ratio})")
    emit({"phase": "slice", "model": "long_seq_attention",
          "launches_fused_b2_b3": long_launches, "rtol": BLOCK_RTOL,
          "atol": BLOCK_ATOL, "blocks": long_report,
          "block_attention_t1_max_abs_err": b2_err})

    # 5. timing --------------------------------------------------------------
    # The tensor-core kernel, the SIMT kernel (its private launch) and the
    # plain version at the serving shape, in the same alternating rounds.
    with torch.no_grad():
        weights, biases = fused_mlp.generator_fast_params(gen)
        x_serve = torch.cat([z, onehot], dim=-1)
        (kernel_ms, simt_ms, plain_ms), rounds = cuda_ms(torch, [
            lambda: fused_mlp.fused_mlp4(x_serve, weights, biases),
            lambda: fused_mlp._launch("simt", x_serve, weights, biases, "sigmoid"),
            lambda: fused_mlp.mlp4_reference(x_serve, weights, biases)], iters=50)
    b1_bound = mlp_bound(part, x_serve, weights, biases)
    gen_rate, fast_rate, rain_rate = samples_per_s(torch, [
        lambda: model.generate_samples(0, SERVE_ROWS),
        lambda: model.generate_samples_fast(0, SERVE_ROWS),
        lambda: rain.generate_samples(0, SERVE_ROWS)], SERVE_ROWS)
    emit({"phase": "timing", "card": card, "rows": SERVE_ROWS,
          "x": list(x_serve.shape), "fused_mlp4_ms": kernel_ms,
          "fused_mlp4_simt_ms": simt_ms, "mlp4_reference_ms": plain_ms,
          "fused_mlp4_ms_rounds": rounds[0], "fused_mlp4_simt_ms_rounds": rounds[1],
          "mlp4_reference_ms_rounds": rounds[2], "peaks_of": part, "b1_bound": b1_bound,
          "generate_samples_per_s": gen_rate,
          "generate_samples_fast_per_s": fast_rate,
          "rain_gan_generate_samples_per_s": rain_rate})

    attn_timing = {}
    for name, (batch, seq), iters, reps in (("t1", T1, 20, 6), ("t2", T2, 4, 4)):
        bh = batch * HEADS
        q, k, v = (torch.randn(bh, seq, 64, generator=gd, device=device)
                   for _ in range(3))
        q4, k4, v4 = q[None], k[None], v[None]
        with torch.no_grad():
            sdpa_err, _ = close_enough(F.scaled_dot_product_attention(q4, k4, v4)[0],
                                       ba.block_attention_reference(q, k, v),
                                       ATTN_TOL, ATTN_TOL)
            times, rounds = cuda_ms(torch, [
                lambda: ba.block_attention(q, k, v),
                lambda: ba.block_attention_reference(q, k, v),
                lambda: F.scaled_dot_product_attention(q4, k4, v4),
                lambda: ba.block_attention_with_entropy(q, k, v),
                lambda: ba.block_attention_with_entropy_reference(q, k, v)],
                iters=iters, reps=reps, warmup=3)
        keys = ("b2_ms", "b2_plain_ms", "sdpa_ms", "b3_ms", "b3_plain_ms")
        attn_timing[name] = {
            "shape": [bh, seq, 64], **dict(zip(keys, times)),
            "rounds": dict(zip(keys, rounds)),
            "b2_bound": attention_bound(part, bh, seq, 64, entropy=False),
            "b3_bound": attention_bound(part, bh, seq, 64, entropy=True),
            "sdpa_max_abs_err_vs_plain": sdpa_err,
            "sdpa_device_kernels": [e[0] for e in breakdown(
                torch, lambda: F.scaled_dot_product_attention(q4, k4, v4), times[2],
                calls=1, top=3).get("top", [])]}
        emit({"phase": "timing", "card": card, "attention": name,
              "peaks_of": part, **attn_timing[name]})

    # B3 at the long-sequence path's d 32 launch (the 128-wide block's 4
    # heads of d 32 at x [32, 1024, 128]).
    bh32 = 32 * HEADS
    q, k, v = (torch.randn(bh32, 1024, 32, generator=gd, device=device) for _ in range(3))
    with torch.no_grad():
        (b3_32_ms, b3_32_plain_ms), rounds = cuda_ms(torch, [
            lambda: ba.block_attention_with_entropy(q, k, v),
            lambda: ba.block_attention_with_entropy_reference(q, k, v)],
            iters=20, reps=6, warmup=3)
    b3_d32 = {"shape": [bh32, 1024, 32], "ms": b3_32_ms, "plain_ms": b3_32_plain_ms,
              "rounds": {"b3_ms": rounds[0], "b3_plain_ms": rounds[1]},
              "bound": attention_bound(part, bh32, 1024, 32, entropy=True)}
    emit({"phase": "timing", "card": card, "attention": "d32_b3", "peaks_of": part,
          **b3_d32})

    # 6. breakdown -----------------------------------------------------------
    for name, fn, rate in (("generate_samples", model.generate_samples, gen_rate),
                           ("generate_samples_fast", model.generate_samples_fast,
                            fast_rate),
                           ("rain_gan.generate_samples", rain.generate_samples,
                            rain_rate)):
        emit({"phase": "breakdown", "call": name, "rows": SERVE_ROWS, "card": card,
              **breakdown(torch, lambda: fn(0, SERVE_ROWS), SERVE_ROWS / rate * 1e3)})

    def block_forward():
        with torch.no_grad():
            wide(xs["t1"])

    (forward_rate,) = samples_per_s(torch, [block_forward], 1, iters=10, reps=4)
    emit({"phase": "breakdown", "call": "ResidualAttentionBlock(256) forward",
          "x": list(xs["t1"].shape), "card": card,
          **breakdown(torch, block_forward, 1e3 / forward_rate)})

    # 7. training ---------------------------------------------------------
    import contextlib
    import io
    import pickle
    import tempfile

    from cvaegan_tpu_torch.algorithms.cvae_gan import CVAEGAN as TrainerClass
    from cvaegan_tpu_torch.core import config as tconfig
    from cvaegan_tpu_torch.data.tabular import TabularDataset, minmax_scale
    from cvaegan_tpu_torch.pipelines.balance import run_balance_pipeline

    ds = standin_dataset(TabularDataset, minmax_scale)
    counter = ReplayCounter(torch, TrainerClass)

    def fitted(epochs, eager=False, balanced=False):
        m = CVAEGAN(seed=0, device="cuda", settings=train_settings(tconfig, epochs),
                    balanced_mode=balanced)
        m.verbose = False
        m.fit(ds, eager=eager)
        torch.cuda.synchronize()
        return m

    zero_counts(fused_mlp, ba)
    counter.reset()
    captured = fitted(1)
    captured_calls = (counter.replays, counter.epochs)
    counter.reset()
    eager = fitted(1, eager=True)
    eager_calls = (counter.replays, counter.epochs)
    check(captured_calls == (1, 1) and captured._graph is not None,
          f"the captured fit made (replays, epoch calls) {captured_calls}")
    check(eager_calls == (0, 1) and eager._graph is None,
          f"the eager fit made (replays, epoch calls) {eager_calls}")
    err1, ratio1, bitwise1 = compare_fits(torch, captured, eager)
    err3, ratio3, bitwise3 = compare_fits(torch, fitted(3), fitted(3, eager=True))
    emit({"phase": "train_graph_vs_eager", "rtol": TRAIN_RTOL, "atol": TRAIN_ATOL,
          "tensors": len(state_tensors(captured)),
          "captured_replays_epoch_calls": captured_calls,
          "eager_replays_epoch_calls": eager_calls,
          "epoch1": {"max_abs_diff": err1, "worst_err_over_tol": ratio1, "bitwise": bitwise1},
          "epoch3_ungated": {"max_abs_diff": err3, "worst_err_over_tol": ratio3,
                             "bitwise": bitwise3}})
    check(ratio1 <= 1.0, f"captured and eager epochs disagree ({ratio1} of the tolerance)")

    fits, train_report, train_missed = {}, {}, []
    for mode in ("strict", "balanced"):
        counter.reset()
        t0 = time.perf_counter()
        fits[mode] = fitted(GAN_EPOCHS, balanced=mode == "balanced")
        seconds = time.perf_counter() - t0
        check((counter.replays, counter.epochs) == (GAN_EPOCHS, 1),
              f"{mode} fit: {counter.replays} replays, {counter.epochs} epoch calls")
        report, missed = train_checks(torch, fits[mode], ds, mode)
        train_report[mode] = {"fit_seconds_with_capture": seconds, **report}
        train_missed += missed
    emit({"phase": "train", "epochs": GAN_EPOCHS, "rows": len(ds.tr_labels),
          "class_counts": np.bincount(ds.tr_labels).tolist(),
          "replays_per_fit": GAN_EPOCHS, **train_report, "gates_missed": train_missed})
    check(not train_missed, "; ".join(train_missed))

    with tempfile.TemporaryDirectory() as tmp:
        settings = train_settings(tconfig, GAN_EPOCHS)
        settings.paths = tconfig.Paths(root=tmp)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            result = run_balance_pipeline(CVAEGAN, "CVAE_GAN", ds, out_dir=tmp,
                                          settings=settings, plot=False, device="cuda")
        with open(result["pickle_path"], "rb") as f:
            artifact = pickle.load(f)
    check(isinstance(artifact, tuple) and len(artifact) == 4,
          "the pipeline's pickle is not 4 arrays")
    tr_x, tr_y, te_x, te_y = artifact
    check((tr_x.dtype, tr_y.dtype, te_x.dtype, te_y.dtype)
          == (np.float32, np.int32, np.float32, np.int32), "artifact dtypes")
    base = ds.renormalized()
    added = len(tr_y) - len(base.tr_labels)
    check(np.array_equal(tr_y[:len(base.tr_labels)], base.tr_labels)
          and np.array_equal(np.bincount(tr_y, minlength=CLASSES),
                             base.class_counts() + np.bincount(tr_y[len(base.tr_labels):],
                                                               minlength=CLASSES))
          and len(tr_x) == len(tr_y) and np.array_equal(te_y, base.te_labels)
          and np.array_equal(te_x, base.te_samples),
          "augmented counts are not the original plus the generated rows")
    f1 = result["multiclass_metrics"]["F1"]
    clf_seconds = result["classifier"].fit_seconds
    torch.cuda.synchronize()
    training_launches = (fused_mlp.LAUNCHES, ba.LAUNCHES, ba.ENTROPY_LAUNCHES)
    emit({"phase": "pipeline", "gan_epochs": GAN_EPOCHS, "clf_epochs": CLF_EPOCHS,
          "generated_rows": added,
          "augmented_counts": np.bincount(tr_y, minlength=CLASSES).tolist(),
          "multiclass_metrics": result["multiclass_metrics"],
          "binary_metrics": result["binary_metrics"],
          "classifier_fit_seconds": clf_seconds, "pipeline_seconds": result["seconds"],
          "training_launches_fused_b2_b3": training_launches})
    check(f1 >= 0.99, f"pipeline multiclass macro-F1 {f1} < 0.99")
    check(training_launches == (0, 0, 0),
          f"kernels launched on the training path (fused, B2, B3): {training_launches}")

    # training timing: steady replays against eager epochs, in one call
    train_timing = {"card": card}
    replay_ms = {}
    for mode, model_ in fits.items():
        graph = model_._graph[1]

        def replay(model_=model_, graph=graph):
            model_._epoch_t.fill_(GAN_EPOCHS)
            graph.replay()

        (device_ms,), rounds = cuda_ms(torch, [replay], iters=20, reps=4, warmup=2)
        (host_rate,) = samples_per_s(torch, [replay], 1, iters=20, reps=4)
        replay_ms[mode] = (replay, 1e3 / host_rate)
        train_timing[mode] = {
            "replay_device_ms_per_epoch": device_ms, "replay_device_ms_rounds": rounds[0],
            "replay_epochs_per_s": host_rate,
            "replay_steps_per_s": host_rate * STEPS_PER_EPOCH[mode],
            "fit_epochs_per_s_with_capture":
                GAN_EPOCHS / train_report[mode]["fit_seconds_with_capture"],
            "steps_per_epoch": STEPS_PER_EPOCH[mode]}
    counter.restore()
    eager_model = fitted(1, eager=True)

    def eager_epoch(model_=eager_model):
        model_._epoch_t.fill_(1)
        model_._epoch()

    (eager_rate,) = samples_per_s(torch, [eager_epoch], 1, iters=3, reps=2)
    train_timing["strict"].update({"eager_epochs_per_s": eager_rate,
                                   "eager_steps_per_s": eager_rate * STEPS_PER_EPOCH["strict"]})
    train_timing.update({"classifier_fit_seconds": clf_seconds,
                         "pipeline_seconds": result["seconds"]})
    emit({"phase": "timing", "training": "cvae_gan", **train_timing})

    replay_fn, replay_call_ms = replay_ms["strict"]
    emit({"phase": "breakdown", "call": "replayed strict epoch", "card": card,
          **breakdown(torch, replay_fn, replay_call_ms, calls=3, top=8)})
    emit({"phase": "breakdown", "call": "eager strict epoch", "card": card,
          **breakdown(torch, eager_epoch, 1e3 / eager_rate, calls=2, top=8)})

    def attention_entry(name, replaces, launches_, entropy, library):
        t1, t2 = attn_timing["t1"], attn_timing["t2"]
        key = "b3" if entropy else "b2"
        bound1, bound2 = t1[f"{key}_bound"], t2[f"{key}_bound"]
        return {
            "name": name, "route": "cuda",
            "source": "cvaegan_tpu_torch/csrc/block_attention.cu",
            "replaces": replaces, "launches": launches_,
            "training_launches": training_launches[2 if entropy else 1],
            "max_abs_err": attn_err[name],
            "scale10_err_over_limit": attn_stats[name]["scale10"][1],
            "shape": t1["shape"],
            "ms": t1[f"{key}_ms"], "plain_ms": t1[f"{key}_plain_ms"],
            "bound_ms": bound1["bound_ms"], "bound_by": bound1["bound_by"],
            "library_ms": t1["sdpa_ms"] if library else None,
            "t2": {"shape": t2["shape"], "ms": t2[f"{key}_ms"],
                   "plain_ms": t2[f"{key}_plain_ms"], "bound_ms": bound2["bound_ms"],
                   "library_ms": t2["sdpa_ms"] if library else None}}

    b3_entry = attention_entry("block_attention_with_entropy",
                               "cvaegan_tpu/kernels/block_attention.py:56",
                               long_launches[2], entropy=True, library=False)
    b3_entry["d32"] = {"shape": b3_d32["shape"], "ms": b3_d32["ms"],
                       "plain_ms": b3_d32["plain_ms"],
                       "bound_ms": b3_d32["bound"]["bound_ms"], "library_ms": None}
    emit({"kernels": [
        {"name": "fused_mlp4", "route": "cuda",
         "source": "cvaegan_tpu_torch/csrc/fused_mlp4.cu",
         "replaces": "cvaegan_tpu/kernels/fused_mlp.py:44",
         "launches": launches["total"], "launches_by_variant": launches,
         "training_launches": training_launches[0],
         "max_abs_err": mlp_stats["tensor_core"]["max_abs_err"],
         "err_over_tol_f64": mlp_stats["tensor_core"]["err_over_tol"],
         "plain_f32_err_over_tol_f64": mlp_plain_worst,
         "err_over_tol_vs_plain_f32": mlp_stats["tensor_core"]["err_over_tol_vs_plain_f32"],
         "shape": list(x_serve.shape), "ms": kernel_ms, "plain_ms": plain_ms,
         "simt_ms": simt_ms, "bound_ms": b1_bound["bound_ms"],
         "bound_by": b1_bound["bound_by"], "library_ms": None},
        attention_entry("block_attention", "cvaegan_tpu/kernels/block_attention.py:30",
                        long_launches[1], entropy=False, library=True),
        b3_entry,
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
