#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`cvaegan_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's serving and training paths at full width with random
weights made from a seed, on `cuda:0`: the flagship CVAE-GAN (30
features, 5 classes, z 128, generator 133->256->128->64->30), the
RAIN-GAN (the same widths; four pre-LN residual-attention networks over
singleton sequences), the long-sequence attention stack that reaches the
block-attention kernels, the other trainers (SNGAN, CTGAN, QG-SMOTE and
TMG-GAN at widths from `hidden_sizes`) and `SeedBank` of all of them:

  1. environment: torch/CUDA versions, card name and power limit; TF32 off;
  2. build: compiles every kernel source from `cvaegan_tpu_torch/csrc`, one
     `nvcc` each, all at once, and reports ptxas's registers and spills
     per kernel and, for the bf16 attention library, its SASS's counts of
     `HGMMA` (wgmma) and `UTMALDG` (TMA loads) and its highest register;
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
     training path;
  8. family: the CGAN, CVAE, GAN, VAE, VAE-GAN, RAIN-GAN, SNGAN, CTGAN,
     QG-SMOTE and TMG-GAN on the same stand-in in strict mode: for each, a
     one-epoch captured fit against the eager one (rtol 1e-5, atol 1e-6;
     CTGAN's epoch holds its gradient penalty's double backward), a
     50-epoch captured fit gated on exactly 50 replays, its chunk-end
     hook's runs (TMG-GAN's scatter every 10 epochs: 5), finite
     histories and, where there is a companion classifier, a class loss
     near ln 5 before training and at epoch 0 (RAIN-GAN: also its
     attention history, 1 point of 1.0 per network), the replayed epoch's
     device time, steps/s and device ops (`torch.profiler`), then every
     serving entry point for all 5 classes at 8192 rows (B1's launches
     counted around them: the fast path of the CGAN, CVAE and QG-SMOTE,
     held to the generator run in float64; the other conditional
     trainers' fast path raises and launches nothing; QG-SMOTE also from
     the prior and its latent quantiles; TMG-GAN's qualified generation
     exactly each class's need, in [-1, 1]), and for RAIN-GAN, SNGAN,
     CTGAN, QG-SMOTE and TMG-GAN a `run_balance_pipeline` at 50 GAN and
     20 classifier epochs whose downstream classifier is warm-started from
     the companion, where there is one (TMG-GAN has none);
  9. seed_bank: `SeedBank` of strict CVAE-GANs on stand-ins of different
     class mixes (one lacking a class): the captured banked epoch against
     the eager one at K = 4, each replica against its serial fit after
     one epoch from the same drawn Adam moments (rtol 1e-3, atol 1e-4),
     and for K in {1, 4, 16} the replayed banked epoch's aggregate
     steps/s, device time by CUDA events and device ops by
     `torch.profiler` (gated: fewer than twice a serial epoch's at
     K = 16), then one `generate_samples_fast` on a replica (one B1
     launch);
 10. seed_bank_family: `SeedBank` of RAIN-GAN, SNGAN, CTGAN, QG-SMOTE and
     TMG-GAN in strict mode: for each, a bank of K = 2 on the stand-ins of
     the first and last class mixes from drawn Adam moments, its captured
     epoch against the eager one (one replay per epoch) and each replica
     against its serial fit after one epoch (rtol 1e-3, atol 1e-4: in
     float64, and in float32 where the serial fit resolves it); at
     K = 16 the replayed banked epoch's device time by CUDA events,
     aggregate steps/s and device ops by `torch.profiler`, gated below
     twice the trainer's serial replayed epoch's (`family`); and one
     `generate_samples_fast` on a QG-SMOTE replica (one B1 launch, held to
     the generator run in float64). B1, B2 and B3 launch 0 times on every
     training path;
 11. streamed: the out-of-core path on the Car-Hacking stand-in of
     `scripts/prepare_can_dataset.py` (2M frames of 10 features and 5
     classes, split in time order into 1.8M train and 0.2M test rows,
     written as CSV): the native reader (built from
     `cvaegan_tpu_torch/native/`, its rows/s, its first 10k rows equal to
     the plain reader's); `run_streamed_pipeline` for the CVAE-GAN in
     balanced mode at 1M-row windows (two, the second ragged), 10 GAN and
     1 classifier epoch per window (15,625 captured classifier steps per
     window), warm-started, tested streamed: stage seconds, F1s, one
     capture per present-class pattern, replays = windows x epochs (and
     the classifier's blocks and steps), CUDA-event times of a replayed
     epoch and a classifier block, peak device memory; a strict streamed
     fit whose replay on the refilled second window equals an eager epoch
     there, bitwise, with each window's upload time; the blob stand-in
     streamed in 256-row windows, the second lacking class 2, strict and
     balanced: captured = eager bitwise, Adam counts in closed form; the
     classifier's captured 128-step block against its eager loop,
     bitwise, warm-started from a CVAE-GAN, an SNGAN and a CTGAN; an
     auto-checkpointed streamed fit
     restored into a fresh trainer, whose further fit equals the
     original's bitwise (save and restore seconds); `trace()` around a
     replay writes a trace file, `nan_debug()` raises on a NaN made on the
     card, and `fit` inside it replays nothing. No kernel launches there;
 12. bf16: the bf16 compute policy. B2/B3 on bf16 operands (the TMA and
     wgmma kernels of `csrc/block_attention_sm90.cu`) at T1 [128, 1024,
     64] and the d 32 launch [128, 1024, 32], held to the plain version
     run in float32 on the same inputs (widened exactly) at rtol = atol =
     2e-5, and at scale 10 by `float64_rule`; timed beside the plain
     version and `scaled_dot_product_attention` on the same bf16 inputs,
     and beside their bound (one bf16 pass of Q K^T and two of P V, the
     softmax's ex2 on the special-function units, bf16 inputs over HBM;
     the bound of the earlier design, with P V in two TF32 passes, beside
     it); the 256-wide RAIN block's forward at T1 under the
     policy (one bf16 B3 launch, and B2 on bf16 q, k, v once: the counts
     set to 0 just before and read just after), held to its dense path
     under the policy and timed against its float32 forward; a strict
     CVAE-GAN fit of 3 epochs under the policy (captured = eager bitwise,
     every state tensor float32, finite losses, the replayed epoch's device
     time and ops beside the float32 epoch's, a flip to float32 making a
     second capture and keeping the first), the downstream classifier
     warm-started from its companion staying float32, and a bank of 4
     (captured = eager bitwise), and whether cuBLAS takes a
     reduced-precision bf16 reduction at the fit's GEMM shapes (the flag
     `allow_bf16_reduced_precision_reduction` flipped: reported, not
     gated). No kernel launches on those fits;
 13. mesh: the multi-device layer (`cvaegan_tpu_torch/parallel/`) on a
     1-rank NCCL process group (`distributed.initialize` at a loopback
     address, `global_mesh()`: {'data': 1, 'model': 1}): from one state
     with drawn Adam moments, a captured strict CVAE-GAN epoch at full
     width without the mesh and one under `use_mesh`, whose BatchNorm and
     gradient all-reduces are captured inside the graph (the first ones
     run in the warm-up, before capture), held to each other at
     MESH_RTOL, MESH_ATOL, with each replay's device time by CUDA events,
     the collectives one meshed epoch issues, and the NCCL kernels per
     replay by `torch.profiler`; `SeedBank(CVAEGAN, seeds=range(4),
     mesh=mesh)` for 2 epochs against the same bank without a mesh, per
     replica; `ring_attention` on the 1-rank ring at T1 [128, 1024, 64]
     float32, with and without entropy (its KV rotation a NCCL send to its
     own rank), held to the dense plain versions and to B2/B3 at ATTN_TOL
     and timed beside them; then `destroy_process_group()`. A capture of
     the collectives that fails raises: no meshed fit falls back to eager.

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
import pathlib
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
# bf16 on the tensor cores (dense), which bounds the bf16 kernels' products.
BF16_PEAKS = {"H100 SXM": 989e12, "H100 PCIe": 756e12, "H100 NVL": 835e12}
# ex2 on the special-function units: 16 per clock per SM at the clock of
# PEAKS' float32 rates (SXM 132 SMs at 1.98 GHz, PCIe 114 at 1.755, NVL 132
# at 1.775), which bounds the bf16 kernels' softmax.
EX2_PEAKS = {"H100 SXM": 132 * 16 * 1.98e9, "H100 PCIe": 114 * 16 * 1.755e9,
             "H100 NVL": 132 * 16 * 1.775e9}
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
# The other trainers (`family`): a short captured fit of each, in strict
# mode, and its serving entry points; the fast path (B1) serves the MLP
# generators of FAST_PATH only. The trainers of FAMILY_PIPELINES also run
# the balance pipeline, warm-starting the downstream classifier from their
# companions (which differ from the CVAE-GAN's: attention, spectral,
# BatchNorm).
FAMILY = ("CGAN", "CVAE", "GAN", "VAE", "VAEGAN", "RAIN_GAN", "SNGAN", "CTGAN",
          "QG_SMOTE", "TMGGAN")
FAST_PATH = ("CGAN", "CVAE", "QG_SMOTE")
FAMILY_PIPELINES = ("RAIN_GAN", "SNGAN", "CTGAN", "QG_SMOTE", "TMGGAN")
# Trainers whose generators end in tanh (samples in [-1, 1], not [0, 1]).
TANH_OUTPUT = ("ctgan", "tmg_gan")
# Cut from 100 GAN epochs to 50 (fits and pipelines) to keep the script's
# time with `seed_bank_family`; widths are uncut.
FAMILY_EPOCHS, FAMILY_CLF_EPOCHS = 50, 20
# Replays per CUDA-event round of the `family` and `seed_bank` epochs (10
# until `seed_bank_family` joined; each round still times back-to-back
# replays behind one spin kernel).
TIMING_ITERS = 5
# RAIN-GAN's attention history: one point per 50-epoch chunk, each the
# mean of softmax probabilities over a single key.
ATTENTION_TOL = 1e-6
# SeedBank (`seed_bank`): strict CVAE-GANs on stand-ins of different class
# mixes (1000 rows each; the last lacks class 2, so its rounds of class 2
# are masked); each replica is held to its serial fit after one epoch at
# the CPU tests' epoch-0 tolerance, both started from the same drawn Adam
# moments (batched and unbatched matmuls sum in other orders, and from
# Adam's real first step that noise drives the critic's exactly-cancelling
# gradients by ~lr per step: `tests/test_torch_port_seed_bank.py`).
# Timing at K replicas on the first three mixes in turn.
BANK_MIXES = ((500, 200, 150, 100, 50), (300, 300, 200, 100, 100),
              (150, 250, 300, 200, 100), (600, 150, 0, 100, 150))
BANK_RTOL, BANK_ATOL = 1e-3, 1e-4
BANK_KS = (1, 4, 16)
BANK_TIMING_EPOCHS = 10
# SeedBank of the other five trainers (`seed_bank_family`), in strict mode:
# K = 2 on the stand-ins of BANK_MIXES[0] and BANK_MIXES[3] (the second
# lacks class 2) for the checks, K = 16 on the timing stand-ins for the
# rates; 3 replays per timing round (a banked RAIN-GAN epoch takes ~0.3
# s), and the serial fits the replicas are held to run eagerly (the
# `family` phase holds a captured serial epoch to the eager one).
BANK_FAMILY = ("RAIN_GAN", "SNGAN", "CTGAN", "QG_SMOTE", "TMGGAN")
BANK_FAMILY_MIXES = (0, 3)
BANK_FAMILY_K = 16
BANK_FAMILY_TIMING_EPOCHS = 2
# The mesh phase: on one rank the meshed epoch computes what the plain one
# does (its all-reduces sum one term, its weights are 1), but takes its
# BatchNorm moments as all-reduced sums over a count where the plain epoch
# takes means; both start from the same drawn Adam moments (so no
# exactly-zero gradient's rounding is blown up by Adam's eps), and they are
# held at the captured-against-eager tolerance.
MESH_RTOL, MESH_ATOL = TRAIN_RTOL, TRAIN_ATOL
MESH_BANK_K, MESH_BANK_EPOCHS = 4, 2
# The mesh phase's `model` leg places every leaf `shard_net_state` would
# shard on a 'model' axis of this size (on the card's 1-rank axis each
# slice is the whole leaf) and holds the placed epochs to the plain ones
# bitwise: every such collective is then a copy or the identity.
MODEL_LEG_N = 2
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
            entry = short_kernel_name(ln.split("'")[1])
            if "tc_kernel" in entry:
                entry = "tensor_core"
            elif inst := re.search(r"simt_kernelILi(\d+)E", entry):
                entry = f"simt {inst[1]}"
            report[entry] = []
        elif entry is not None and ("registers" in ln or "spill" in ln):
            report[entry].append(ln.split("ptxas info    :")[-1].strip())
    return {name: "; ".join(lines) for name, lines in report.items()}


def short_kernel_name(entry):
    """An attention instantiation by head dim ("bf16 " before it for the
    bf16 kernels, " entropy" after it for B3), as `ptxas_report` names it;
    other names as they are."""
    inst = re.search(r"block_attention_(sm90_|bf16_)?kernelILi(\d+)ELb([01])E", entry)
    if not inst:
        return entry
    return ("bf16 " if inst[1] else "") + f"d{inst[2]}" + (" entropy" if inst[3] == "1" else "")


def sass(lib):
    """Each kernel's SASS instructions (`cuobjdump -sass`) as a list of
    (opcode, line), by `short_kernel_name`."""
    from torch.utils.cpp_extension import CUDA_HOME

    text = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    kernels, name = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            name = short_kernel_name(ln.split("Function :")[1].strip())
            kernels[name] = []
        elif name is not None and (op := re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                                                    ln)):
            kernels[name].append((op[1], ln))
    return kernels


def sass_counts(lib, opcodes):
    """{kernel: {opcode: count, ..., "max_register": n}} of a library's
    SASS: `n` is the highest register it names (what `setmaxnreg` lets a
    warpgroup use, where ptxas reports only the launch bound's share)."""
    return {name: {**{op: sum(o == op for o, _ in insts) for op in opcodes},
                   "max_register": max((int(r) for _, ln in insts
                                        for r in re.findall(r"\bR(\d+)\b", ln)), default=0)}
            for name, insts in sass(lib).items()}


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
    ba.BF16_LAUNCHES = ba.BF16_ENTROPY_LAUNCHES = 0


def all_counts(fused_mlp, ba):
    """(B1, B2, B3, B2 on bf16, B3 on bf16) launches since the last zero."""
    return (fused_mlp.LAUNCHES, ba.LAUNCHES, ba.ENTROPY_LAUNCHES, ba.BF16_LAUNCHES,
            ba.BF16_ENTROPY_LAUNCHES)


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


def standin_dataset(TabularDataset, minmax_scale, counts=STANDIN_COUNTS, seed=0):
    """The blob fixture's shape without sklearn: 5 Gaussian blobs (centres
    uniform in [-10, 10], std 1, as `make_blobs` draws them) in 30
    dimensions, 1000 rows of `counts` per class (500/200/150/100/50 unless
    given), min-max scaled to [0, 1], split 900/100 at random; `seed`
    draws the centres, the rows and the split."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-10.0, 10.0, (CLASSES, FEATURES))
    x = np.concatenate([centres[c] + rng.standard_normal((n, FEATURES))
                        for c, n in enumerate(counts)]).astype(np.float32)
    y = np.repeat(np.arange(CLASSES), counts).astype(np.int32)
    perm = rng.permutation(len(y))
    x, y = minmax_scale(x[perm]), y[perm]
    return TabularDataset(x[:900], y[:900], x[900:], y[900:], name="blob_standin")


def train_settings(config, epochs, dtype="float32"):
    settings = config.Settings()
    settings.gan.epochs = epochs
    settings.gan.compute_dtype = dtype
    settings.classifier.epochs = CLF_EPOCHS
    return settings


def state_tensors(model):
    """Every parameter, buffer and Adam tensor of a trainer, in one order."""
    return [t.detach() for t in model._static_tensors()]


def compare_fits(torch, a, b, rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
    """(max abs difference, worst err / tolerance, bitwise equal) of two
    trainers' loss histories and state tensors."""
    pairs = [(torch.tensor(a.loss_history[k], dtype=torch.float64),
              torch.tensor(b.loss_history[k], dtype=torch.float64)) for k in a.loss_keys]
    pairs += [(x.double(), y.double()) for x, y in zip(state_tensors(a), state_tensors(b))]
    err = ratio = 0.0
    for x, y in pairs:
        e, r = close_enough(x, y, rtol, atol)
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

def class_loss_at_init(torch, model, ds):
    """The companion classifier's cross entropy on the train set before
    any step (near ln 5 for 5 classes), read in eval mode after one power
    iteration of its spectral layers, on a copy. Until a train forward
    iterates them, a spectral layer's u/v are the random unit vectors of
    its init, and sigma = u^T W v is a few hundredths, so SNGAN's four
    spectral layers give logits of ~1e4 at init, in the JAX package too.
    Returns (that loss, the eval loss of the state as built)."""
    from cvaegan_tpu_torch.core import losses

    x = torch.as_tensor(ds.tr_samples, device=model.device)
    y = torch.as_tensor(ds.tr_labels, device=model.device)
    clf = copy.deepcopy(model.state["classifier"])
    with torch.no_grad():
        for layer in clf.modules():
            if hasattr(layer, "u"):  # SpectralDense: one train forward iterates u/v
                layer.train()(torch.zeros(1, layer.weight.shape[1], device=model.device))
    state = {**dict(model.state.items()), "classifier": clf}
    return (float(losses.cross_entropy(model._classifier_logits(state, x), y)),
            float(losses.cross_entropy(model._classifier_logits(model.state, x), y)))


def check_samples(s, rows, what, low=0.0):
    """`low` is -1 for a tanh output (CTGAN's), else 0."""
    check(s.shape == (rows, FEATURES) and s.dtype == np.float32, f"{what} gave {s.shape} {s.dtype}")
    check(np.isfinite(s).all() and s.min() >= low and s.max() <= 1.0,
          f"{what} gave values outside [{low}, 1]")


def check_pipeline(result, ds):
    """The artifact of `run_balance_pipeline` on `ds`: four arrays of the
    JAX package's dtypes, the original train rows first, the generated
    rows appended, the test split unchanged. Returns (generated rows,
    augmented class counts)."""
    import pickle

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
    return added, np.bincount(tr_y, minlength=CLASSES).tolist()


def family_pipeline(torch, tp, tconfig, name, ds):
    """`run_balance_pipeline` of trainer `name` at FAMILY_EPOCHS GAN and
    FAMILY_CLF_EPOCHS classifier epochs, the downstream classifier
    warm-started from the companion where there is one. Returns a
    report."""
    import contextlib
    import io
    import tempfile

    from cvaegan_tpu_torch.pipelines.balance import TRAINERS, run_balance_pipeline

    (model_key,) = [k for k, v in TRAINERS.items() if v[0] == name]
    cls_name, display, mode = TRAINERS[model_key]
    with tempfile.TemporaryDirectory() as tmp:
        settings = train_settings(tconfig, FAMILY_EPOCHS)
        settings.classifier.epochs = FAMILY_CLF_EPOCHS
        settings.paths = tconfig.Paths(root=pathlib.Path(tmp))
        with contextlib.redirect_stdout(io.StringIO()):
            result = run_balance_pipeline(getattr(tp, cls_name), display, ds, out_dir=tmp,
                                          settings=settings, plot=False,
                                          generation_mode=mode, device="cuda")
        added, counts = check_pipeline(result, ds)
    clf, state = result["classifier"].module, result["model"].state
    if "classifier" in state:
        check(type(clf) is type(state["classifier"]),
              f"{name}: the downstream classifier is not the companion's kind")
    return {"model": model_key, "gan_epochs": FAMILY_EPOCHS, "clf_epochs": FAMILY_CLF_EPOCHS,
            "warm_start": type(clf).__name__ if "classifier" in state else None,
            "generated_rows": added,
            "augmented_counts": counts, "multiclass_metrics": result["multiclass_metrics"],
            "binary_metrics": result["binary_metrics"],
            "classifier_fit_seconds": result["classifier"].fit_seconds,
            "pipeline_seconds": result["seconds"]}


def fast_vs_float64(torch, model, label):
    """`generate_samples_fast(label, SERVE_ROWS)` of a trainer whose
    generator is the MLP family's, held to the generator module run in
    float64 on the same z. Returns the error report."""
    from cvaegan_tpu_torch.core.state import apply_eval

    rng_state = model.generator.get_state()
    fast = model.generate_samples_fast(label, SERVE_ROWS)
    check_samples(fast, SERVE_ROWS, f"{model.name}.generate_samples_fast")
    model.generator.set_state(rng_state)
    z = model._prior(SERVE_ROWS)
    gen64 = copy.deepcopy(model.state["generator"]).double()
    exact, _ = apply_eval(gen64, z.double(), model._labels(label, SERVE_ROWS))
    err, ratio = close_enough(torch.as_tensor(fast, device=z.device).double(), exact)
    check(ratio <= 1.0, f"{model.name}: generate_samples_fast disagrees with "
          f"the generator in float64 ({ratio})")
    return {"max_abs_err": err, "err_over_tol": ratio}


def serve_family(torch, model, ds, fused_mlp):
    """Every serving entry point of a fitted trainer of the family, for
    every class at SERVE_ROWS rows; for those of FAST_PATH the fused
    kernel's output of class 0 is held to the generator module run in
    float64 on the same z, the others' fast path must raise. QG-SMOTE also
    serves from the prior and reports its latent quantiles; TMG-GAN's
    qualified generation must give exactly each class's need. Returns a
    report."""
    from cvaegan_tpu_torch.algorithms.base import GenerativeTrainer

    report = {}
    low = -1.0 if model.name in TANH_OUTPUT else 0.0
    fast_path = type(model).__name__ in FAST_PATH
    if model.conditional_sampling:
        for c in range(CLASSES):
            check_samples(model.generate_samples(c, SERVE_ROWS), SERVE_ROWS,
                          f"{model.name}.generate_samples", low)
            if not fast_path:
                continue
            if c == 0:
                report["fast_vs_module_f64"] = fast_vs_float64(torch, model, 0)
            else:
                check_samples(model.generate_samples_fast(c, SERVE_ROWS), SERVE_ROWS,
                              f"{model.name}.generate_samples_fast")
    else:
        check_samples(model.generate_samples(SERVE_ROWS), SERVE_ROWS,
                      f"{model.name}.generate_samples")
    if not fast_path:
        try:
            model.generate_samples_fast(0, SERVE_ROWS)
            raised = False
        except NotImplementedError:
            raised = True
        check(raised, f"{model.name}.generate_samples_fast did not raise")
        report["fast_path_raises"] = raised
    if model.name == "qg_smote":
        for c in range(CLASSES):
            check_samples(model.generate_samples(c, SERVE_ROWS, method="prior"), SERVE_ROWS,
                          "qg_smote.generate_samples(method='prior')")
        stats = model.analyze_quantiles(0)
        check(all(v.shape == (model.gan_cfg.z_size, model.state["encoder"].num_quantiles)
                  and np.isfinite(v).all() for v in stats.values()),
              "qg_smote.analyze_quantiles gave other shapes or non-finite values")
        report["class0_quantile_means"] = stats["mean"].mean(axis=0).tolist()
    if model.name == "tmg_gan":
        counts = np.bincount(ds.tr_labels, minlength=CLASSES)
        rows = {}
        for c in range(CLASSES):
            need = int(counts.max() - counts[c])
            q = model.generate_qualified_samples(c, need)
            check(q.shape == (need, FEATURES) and np.isfinite(q).all()
                  and (np.abs(q) <= 1.0).all(),
                  f"tmg_gan.generate_qualified_samples({c}, {need}) gave {q.shape}")
            rows[str(c)] = [len(q), need]
        report["qualified_rows_of_need"] = rows
    elif "classifier" in model.state:
        qualified = {(c, thr): model.generate_qualified_samples(
            c, QUALIFIED_ROWS, confidence_threshold=thr)
            for c in range(CLASSES) for thr in (None, 0.0)}
        report["qualified_rows"] = check_qualified(torch, model, qualified, model.device)
    else:
        try:
            model.generate_qualified_samples(0, QUALIFIED_ROWS)
            raised = False
        except NotImplementedError:
            raised = True
        check(raised, f"{model.name}.generate_qualified_samples did not raise")
        report["qualified_raises"] = raised
    if type(model).reconstruct_samples is not GenerativeTrainer.reconstruct_samples:
        x, y = ds.tr_samples[:RECON_ROWS], ds.tr_labels[:RECON_ROWS]
        recon = (model.reconstruct_samples(x, y) if model.conditional_sampling
                 else model.reconstruct_samples(x))
        check_samples(recon, RECON_ROWS, f"{model.name}.reconstruct_samples", low)
        report["recon_shape"] = list(recon.shape)
    return report


def family_phase(torch, tp, tconfig, ds, fused_mlp, ba, counter):
    """The `family` phase: for each trainer of FAMILY, a one-epoch
    captured fit against the eager one, a FAMILY_EPOCHS captured fit with
    its gates (its chunk-end hook's runs counted), then its serving entry
    points with the kernels' launch counts read around them, and for those
    of FAMILY_PIPELINES the balance pipeline. Returns (report, gates
    missed, training launches (fused, B2, B3), fast-path launches of
    B1)."""
    import tempfile

    report, missed = {}, []
    train_launches, fast_launches = [0, 0, 0], 0
    outs = tempfile.TemporaryDirectory()
    for name in FAMILY:
        started = time.perf_counter()
        cls = getattr(tp, name)
        hook_runs = []
        hook = cls._on_chunk_end

        def counted_hook(model, epochs_done, hook=hook, runs=hook_runs):
            runs.append(epochs_done)
            return hook(model, epochs_done)

        def fitted(epochs, eager=False):
            settings = train_settings(tconfig, epochs)
            settings.paths = tconfig.Paths(root=pathlib.Path(outs.name))  # TMG-GAN's scatters
            m = cls(seed=0, device="cuda", settings=settings)
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
        check(captured_calls == (1, 1) and eager_calls == (0, 1),
              f"{name}: (replays, epoch calls) captured {captured_calls}, eager {eager_calls}")
        err, ratio, bitwise = compare_fits(torch, captured, eager)
        check(ratio <= 1.0, f"{name}: captured and eager epochs disagree ({ratio})")

        fresh = cls(seed=0, device="cuda")
        fresh._prepare(ds)
        init_class, init_class_eval = (class_loss_at_init(torch, fresh, ds)
                                       if "classifier" in fresh.state else (None, None))
        counter.reset()
        own_hook = "_on_chunk_end" in vars(cls)
        cls._on_chunk_end = counted_hook
        t0 = time.perf_counter()
        try:
            model = fitted(FAMILY_EPOCHS)
        finally:
            if own_hook:
                cls._on_chunk_end = hook
            else:
                del cls._on_chunk_end
        seconds = time.perf_counter() - t0
        chunk = min(model.epoch_chunk, FAMILY_EPOCHS)
        want_runs = list(range(chunk, FAMILY_EPOCHS + 1, chunk))
        check(hook_runs == want_runs, f"{name}: chunk hook ran at {hook_runs}, not {want_runs}")
        check((counter.replays, counter.epochs) == (FAMILY_EPOCHS, 1),
              f"{name}: {counter.replays} replays, {counter.epochs} epoch calls")
        hist = {k: np.asarray(v) for k, v in model.loss_history.items()}
        for k, v in hist.items():
            if not (len(v) == FAMILY_EPOCHS and np.isfinite(v).all()):
                missed.append(f"{name}: {k} has {len(v)} entries or non-finite values")
        class0 = [v for v in (init_class, hist.get("class_loss", [None])[0]) if v is not None]
        for v in class0:
            if abs(v - np.log(CLASSES)) > 0.3:
                missed.append(f"{name}: epoch-0 class loss {v}, not within 0.3 of ln 5")
        attention = getattr(model, "attention_history", None)
        if attention is not None:
            points = FAMILY_EPOCHS // model.epoch_chunk
            for net, values in attention.items():
                if not (len(values) == points
                        and np.allclose(values, 1.0, rtol=0.0, atol=ATTENTION_TOL)):
                    missed.append(f"{name}: {net} attention history {values}, not "
                                  f"{points} points within {ATTENTION_TOL} of 1")
        graph = model._graph[1]

        def replay(model=model, graph=graph):
            model._epoch_t.fill_(FAMILY_EPOCHS)
            graph.replay()

        (device_ms,), rounds = cuda_ms(torch, [replay], iters=TIMING_ITERS, reps=4,
                                       warmup=2)
        (host_rate,) = samples_per_s(torch, [replay], 1, iters=TIMING_ITERS, reps=4)
        prof = breakdown(torch, replay, 1e3 / host_rate, calls=1, top=4)
        torch.cuda.synchronize()
        for i, n in enumerate((fused_mlp.LAUNCHES, ba.LAUNCHES, ba.ENTROPY_LAUNCHES)):
            train_launches[i] += n

        zero_counts(fused_mlp, ba)
        served = serve_family(torch, model, ds, fused_mlp)
        torch.cuda.synchronize()
        launches = fused_counts(fused_mlp)
        want = CLASSES if name in FAST_PATH else 0
        check(launches == {"tensor_core": want, "simt": 0, "total": want}
              and (ba.LAUNCHES, ba.ENTROPY_LAUNCHES) == (0, 0),
              f"{name}: launches on the serving path {launches}, "
              f"B2/B3 {(ba.LAUNCHES, ba.ENTROPY_LAUNCHES)}")
        fast_launches += launches["total"]
        pipeline = None
        if name in FAMILY_PIPELINES:
            zero_counts(fused_mlp, ba)
            pipeline = family_pipeline(torch, tp, tconfig, name, ds)
            torch.cuda.synchronize()
            for i, n in enumerate((fused_mlp.LAUNCHES, ba.LAUNCHES, ba.ENTROPY_LAUNCHES)):
                train_launches[i] += n
        report[name] = {
            "graph_vs_eager_epoch1": {"max_abs_diff": err, "worst_err_over_tol": ratio,
                                      "bitwise": bitwise},
            "fit_epochs": FAMILY_EPOCHS, "fit_seconds_with_capture": seconds,
            "steps_per_epoch": model._steps_per_epoch(),
            "replay_device_ms_per_epoch": device_ms, "replay_device_ms_rounds": rounds[0],
            "replay_epochs_per_s": host_rate,
            "replay_steps_per_s": host_rate * model._steps_per_epoch(),
            "replay_breakdown": prof,
            "class_loss_at_init": init_class, "class_loss_at_init_eval_as_built": init_class_eval,
            "epoch0": {k: float(v[0]) for k, v in hist.items()},
            "last10_mean": {k: float(v[-10:].mean()) for k, v in hist.items()},
            **({"attention_history": attention} if attention is not None else {}),
            "chunk_hook_runs": len(hook_runs), "fused_launches": launches, **served,
            **({"pipeline": pipeline} if pipeline is not None else {}),
            "wall_seconds": time.perf_counter() - started}
    outs.cleanup()
    return report, missed, train_launches, fast_launches


def draw_moments(torch, trainer, seed):
    """Adam moments drawn by numpy (count 3, |m| < 2e-4, v in [1e-8,
    1e-6]), as the CPU tests' bank-against-serial fits start from."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for opt in trainer.optimizers.values():
            for m, v in zip(opt.m, opt.v):
                m.copy_(torch.as_tensor(rng.uniform(-2e-4, 2e-4, m.shape), dtype=torch.float32))
                v.copy_(torch.as_tensor(rng.uniform(1e-8, 1e-6, v.shape), dtype=torch.float32))
            opt.count.fill_(3)


def bank_replay(bank, epoch):
    """A replay of a fitted bank's captured epoch at `epoch`."""
    banked = bank._bank[1]
    graph = banked._graph[1]

    def replay():
        banked._epoch_t.fill_(epoch)
        graph.replay()

    return replay


def fit_bank(torch, tconfig, cls, dss, epochs, eager=False, drawn=False, dtype="float32"):
    """A strict `SeedBank` of `cls` (seeds 0, 1, ...) fitted for `epochs`
    epochs on `dss` under the `dtype` policy, captured unless `eager`, from
    drawn Adam moments if `drawn`."""
    from cvaegan_tpu_torch.algorithms.seed_bank import SeedBank

    bank = SeedBank(cls, list(range(len(dss))),
                    settings=train_settings(tconfig, epochs, dtype), device="cuda")
    for t, ds in zip(bank.trainers, dss):
        t.verbose = False
        if drawn:
            t._prepare(ds)
            draw_moments(torch, t, t.seed)
    bank.fit(list(dss), eager=eager)
    torch.cuda.synchronize()
    return bank


def bank_graph_vs_eager(torch, counter, fit, what):
    """One-epoch banks from `fit(eager)`, captured and eager: one replay
    and one epoch call against none and one, and every replica's history
    and tensors at TRAIN_RTOL, TRAIN_ATOL. Returns (the captured bank, the
    comparison)."""
    counter.reset()
    captured = fit(False)
    captured_calls = (counter.replays, counter.epochs)
    counter.reset()
    eager = fit(True)
    eager_calls = (counter.replays, counter.epochs)
    check(captured_calls == (1, 1) and eager_calls == (0, 1),
          f"{what}: (replays, epoch calls) captured {captured_calls}, eager {eager_calls}")
    worst, err, bitwise = 0.0, 0.0, True
    for a, b in zip(captured.trainers, eager.trainers):
        e, r, bw = compare_fits(torch, a, b)
        err, worst, bitwise = max(err, e), max(worst, r), bitwise and bw
    check(worst <= 1.0, f"{what}: captured and eager banked epochs disagree ({worst})")
    return captured, {"max_abs_diff": err, "worst_err_over_tol": worst, "bitwise": bitwise}


def timed_bank(torch, counter, fit, epochs, what, iters, reps, calls, top):
    """A bank from `fit()` of `epochs` epochs (one replay each, finite
    histories), then its replayed epoch's device time by CUDA events,
    host rate, aggregate steps/s and `torch.profiler` breakdown. Returns
    (the bank, the report)."""
    counter.reset()
    bank = fit()
    check((counter.replays, counter.epochs) == (epochs, 1),
          f"{what}: {counter.replays} replays, {counter.epochs} epoch calls")
    for t in bank.trainers:
        hist = np.asarray([t.loss_history[key] for key in t.loss_keys])
        check(hist.shape == (len(t.loss_keys), epochs) and np.isfinite(hist).all(),
              f"{what}: history {hist.shape}")
    replay = bank_replay(bank, epochs)
    (device_ms,), rounds = cuda_ms(torch, [replay], iters=iters, reps=reps, warmup=2)
    (host_rate,) = samples_per_s(torch, [replay], 1, iters=iters, reps=reps)
    steps = sum(t._steps_per_epoch() for t in bank.trainers)
    return bank, {"replay_device_ms_per_epoch": device_ms,
                  "replay_device_ms_rounds": rounds[0],
                  "replay_epochs_per_s": host_rate,
                  "steps_per_epoch_all_replicas": steps,
                  "aggregate_steps_per_s": host_rate * steps,
                  "fit_seconds_with_capture": bank.fit_seconds,
                  "fit_steps_per_s_with_capture": bank.steps_per_sec,
                  "breakdown": breakdown(torch, replay, 1e3 / host_rate, calls=calls,
                                         top=top)}


def bank_phase(torch, tp, tconfig, make_ds, fused_mlp, ba, counter, serial_ops):
    """The `seed_bank` phase: strict CVAE-GAN banks on stand-ins made by
    `make_ds(counts, seed)`: a captured banked epoch against the eager one
    and each replica against its serial fit (K = len(BANK_MIXES)), then
    the rate, device time and device ops of a replayed banked epoch for
    each K of BANK_KS, and a replica's fast path. Returns (report,
    training launches (fused, B2, B3), fast-path launches of B1)."""
    def bank_fit(dss, epochs, eager=False, drawn=False):
        return fit_bank(torch, tconfig, tp.CVAEGAN, dss, epochs, eager, drawn)

    mixes = [make_ds(counts, seed) for seed, counts in enumerate(BANK_MIXES)]
    timing_sets = [make_ds(BANK_MIXES[i % 3], 100 + i) for i in range(max(BANK_KS))]
    zero_counts(fused_mlp, ba)
    _, graph_vs_eager = bank_graph_vs_eager(
        torch, counter, lambda eager: bank_fit(mixes, 1, eager), "bank")

    vs_serial = []
    drawn = bank_fit(mixes, 1, drawn=True)
    for seed, (t, ds) in enumerate(zip(drawn.trainers, mixes)):
        serial = tp.CVAEGAN(seed=seed, device="cuda", settings=train_settings(tconfig, 1))
        serial.verbose = False
        serial._prepare(ds)
        draw_moments(torch, serial, seed)
        serial.fit(ds)
        got = np.array([t.loss_history[k][0] for k in t.loss_keys])
        want = np.array([serial.loss_history[k][0] for k in t.loss_keys])
        e, r = close_enough(torch.tensor(got), torch.tensor(want), BANK_RTOL, BANK_ATOL)
        state_err = max(float((x - y).abs().max()) for x, y in
                        zip(state_tensors(t)[:-1], state_tensors(serial)[:-1]))
        vs_serial.append({"epoch0_max_abs_diff": e, "epoch0_err_over_tol": r,
                          "state_max_abs_diff_ungated": state_err,
                          "classes": [int(c) for c in t._data["index"].present()]})
        check(r <= 1.0, f"bank replica {seed}: epoch 0 differs from its serial fit ({r})")

    timing = {}
    for k in BANK_KS:
        last, timing[k] = timed_bank(
            torch, counter, lambda k=k: bank_fit(timing_sets[:k], BANK_TIMING_EPOCHS),
            BANK_TIMING_EPOCHS, f"bank K={k}", iters=TIMING_ITERS, reps=4, calls=2, top=6)
    ops16 = timing[BANK_KS[-1]]["breakdown"].get("device_ops_per_call")
    check(ops16 is not None and serial_ops is not None and ops16 < 2 * serial_ops,
          f"bank K={BANK_KS[-1]}: {ops16} device ops per epoch against "
          f"{serial_ops} of a serial epoch")
    torch.cuda.synchronize()
    train_launches = [fused_mlp.LAUNCHES, ba.LAUNCHES, ba.ENTROPY_LAUNCHES]

    zero_counts(fused_mlp, ba)
    fast = last.trainers[3].generate_samples_fast(0, SERVE_ROWS)
    torch.cuda.synchronize()
    launches = fused_counts(fused_mlp)
    check(launches == {"tensor_core": 1, "simt": 0, "total": 1},
          f"bank replica generate_samples_fast: launches {launches}")
    check_samples(fast, SERVE_ROWS, "bank replica generate_samples_fast")
    report = {"replicas": len(mixes), "class_counts": [
                  np.bincount(ds.tr_labels, minlength=CLASSES).tolist() for ds in mixes],
              "graph_vs_eager_epoch1": graph_vs_eager,
              "replica_vs_serial_epoch1": vs_serial,
              "rtol": BANK_RTOL, "atol": BANK_ATOL,
              "serial_epoch_device_ops": serial_ops, "timing_by_k": timing,
              "replica_fast_launches": launches}
    return report, train_launches, launches["total"]


def float64_epoch0(torch, trainer):
    """Epoch 0 of a trainer (serial or banked: a SeedBank's `_load()`)
    run eagerly in float64: its networks, Adam moments, data and draws
    (the same values, widened) in float64 and the losses' float32 cast
    removed for the call. Returns its losses, `[keys]` or `[keys, K]`."""
    from cvaegan_tpu_torch.core import losses

    trainer.state.double()
    for opt in trainer.optimizers.values():
        opt.m, opt.v = [m.double() for m in opt.m], [v.double() for v in opt.v]
    trainer._data = {k: v.double() if isinstance(v, torch.Tensor) and v.is_floating_point()
                     else v for k, v in trainer._data.items()}
    for draw in ("_normal", "_uniform"):
        setattr(trainer, draw, lambda shape, draw=getattr(trainer, draw): draw(shape).double())
    f32, losses._f32 = losses._f32, lambda *xs: xs[0] if len(xs) == 1 else xs
    try:
        trainer._epoch_t.fill_(0)
        trainer._epoch()
    finally:
        losses._f32 = f32
    return trainer._losses_out.double()


def replicas_vs_serial(torch, cls, tconfig, bank, mixes):
    """Each replica of a fitted 1-epoch bank (from drawn moments) against
    its serial fit from the same moments, at BANK_RTOL, BANK_ATOL on epoch
    0's losses, twice: in float64 (the bank's and the serial trainer's
    epoch 0 run eagerly in float64: the same function, gated for every
    replica), and in float32 (the fits). The float32 comparison is gated
    where the serial fit can resolve the tolerance: where its own float32
    epoch 0 lies beyond the tolerance from its float64 one, or moves by the
    tolerance when every parameter is nudged one ulp up (`torch.nextafter`),
    it is reported and not gated."""
    from cvaegan_tpu_torch.algorithms.seed_bank import SeedBank

    def serial(seed, ds, nudge=False):
        t = cls(seed=seed, device="cuda", settings=train_settings(tconfig, 1))
        t.verbose = False
        t._prepare(ds)
        draw_moments(torch, t, seed)
        if nudge:
            with torch.no_grad():
                for p in t.state.parameters():
                    p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
        return t

    def first_epoch(t, ds):
        t.fit(ds, eager=True)
        return np.array([t.loss_history[k][0] for k in t.loss_keys])

    def over(a, b):
        return close_enough(torch.as_tensor(np.asarray(a), dtype=torch.float64),
                            torch.as_tensor(np.asarray(b), dtype=torch.float64),
                            BANK_RTOL, BANK_ATOL)

    fresh = SeedBank(cls, list(range(len(mixes))), settings=train_settings(tconfig, 1),
                     device="cuda")
    for f, ds in zip(fresh.trainers, mixes):
        f._prepare(ds)
        draw_moments(torch, f, f.seed)
    exact = float64_epoch0(torch, fresh._load()).cpu().numpy()
    out = []
    for seed, (t, ds) in enumerate(zip(bank.trainers, mixes)):
        got = np.array([t.loss_history[k][0] for k in t.loss_keys])
        ref = serial(seed, ds)
        want = first_epoch(ref, ds)
        serial64 = float64_epoch0(torch, serial(seed, ds)).cpu().numpy()
        e, r = over(got, want)
        report = {"epoch0_max_abs_diff": e, "epoch0_err_over_tol": r,
                  "float64_err_over_tol": over(exact[:, seed], serial64)[1],
                  "bank_f32_vs_f64_err_over_tol": over(got, serial64)[1],
                  "serial_f32_vs_f64_err_over_tol": over(want, serial64)[1],
                  "state_max_abs_diff_ungated": max(
                      float((x - y).abs().max()) for x, y in
                      zip(state_tensors(t)[:-1], state_tensors(ref)[:-1])),
                  "classes": [int(c) for c in t._data["index"].present()],
                  "float32_gated": True}
        if r > 1.0:
            moved = over(first_epoch(serial(seed, ds, nudge=True), ds), want)[1]
            report["serial_err_over_tol_one_ulp_up"] = moved
            report["float32_gated"] = (report["serial_f32_vs_f64_err_over_tol"] <= 1.0
                                       and moved < 1.0)
        report["passed"] = (report["float64_err_over_tol"] <= 1.0
                            and (r <= 1.0 or not report["float32_gated"]))
        out.append(report)
    return out


def bank_family_phase(torch, tp, tconfig, make_ds, fused_mlp, ba, counter, family):
    """The `seed_bank_family` phase: for each trainer of BANK_FAMILY, a
    strict bank of K = 2 on the stand-ins of the BANK_FAMILY_MIXES, from
    drawn Adam moments: its captured epoch against the eager one (one
    replay per epoch), and each replica against its serial fit after one
    epoch (`replicas_vs_serial`); then at K = BANK_FAMILY_K a replayed
    banked epoch's device time by CUDA events, aggregate steps/s and
    device ops by `torch.profiler`, gated below twice the trainer's serial
    replayed epoch's (profiled by the `family` phase, whose report is
    `family`); and a QG-SMOTE
    replica's fast path (one B1 launch), held to its generator run in
    float64. Returns (report, training launches (fused, B2, B3), fast-path
    launches of B1)."""
    mixes = [make_ds(BANK_MIXES[i], i) for i in BANK_FAMILY_MIXES]
    timing_sets = [make_ds(BANK_MIXES[i % 3], 100 + i) for i in range(BANK_FAMILY_K)]
    report, train_launches, fast_launches = {}, [0, 0, 0], 0
    for name in BANK_FAMILY:
        started = time.perf_counter()
        cls = getattr(tp, name)

        def bank_fit(dss, epochs, eager=False, cls=cls):
            return fit_bank(torch, tconfig, cls, dss, epochs, eager, drawn=True)

        zero_counts(fused_mlp, ba)
        captured, graph_vs_eager = bank_graph_vs_eager(
            torch, counter, lambda eager: bank_fit(mixes, 1, eager), f"{name} bank")

        vs_serial = replicas_vs_serial(torch, cls, tconfig, captured, mixes)
        for seed, v in enumerate(vs_serial):
            check(v["passed"], f"{name} bank replica {seed}: epoch 0 differs from its "
                  f"serial fit: {v}")

        bank, timing = timed_bank(
            torch, counter, lambda: bank_fit(timing_sets, BANK_FAMILY_TIMING_EPOCHS),
            BANK_FAMILY_TIMING_EPOCHS, f"{name} bank K={BANK_FAMILY_K}",
            iters=3, reps=3, calls=1, top=4)
        serial_ops = family[name]["replay_breakdown"].get("device_ops_per_call")
        ops = timing["breakdown"].get("device_ops_per_call")
        check(ops is not None and serial_ops is not None and ops < 2 * serial_ops,
              f"{name} bank K={BANK_FAMILY_K}: {ops} device ops per epoch against "
              f"{serial_ops} of a serial epoch")
        torch.cuda.synchronize()
        for i, n in enumerate((fused_mlp.LAUNCHES, ba.LAUNCHES, ba.ENTROPY_LAUNCHES)):
            train_launches[i] += n
        fast = None
        if name == "QG_SMOTE":
            zero_counts(fused_mlp, ba)
            fast = fast_vs_float64(torch, bank.trainers[3], 0)
            torch.cuda.synchronize()
            fast["launches"] = fused_counts(fused_mlp)
            check(fast["launches"] == {"tensor_core": 1, "simt": 0, "total": 1}
                  and (ba.LAUNCHES, ba.ENTROPY_LAUNCHES) == (0, 0),
                  f"{name} bank replica generate_samples_fast: launches {fast['launches']}")
            fast_launches += fast["launches"]["total"]
        report[name] = {
            "graph_vs_eager_epoch1": graph_vs_eager,
            "replica_vs_serial_epoch1": vs_serial,
            "k": BANK_FAMILY_K, "timing_epochs": BANK_FAMILY_TIMING_EPOCHS, **timing,
            "device_ops_per_epoch": ops, "serial_epoch_device_ops": serial_ops,
            "ops_over_serial": ops / serial_ops,
            **({"replica_fast_vs_module_f64": fast} if fast is not None else {}),
            "wall_seconds": time.perf_counter() - started}
    return {"replicas_checked": len(mixes), "class_counts": [
                np.bincount(ds.tr_labels, minlength=CLASSES).tolist() for ds in mixes],
            "rtol": BANK_RTOL, "atol": BANK_ATOL, "trainers": report}, \
        train_launches, fast_launches


# Out of core (`streamed`): the Car-Hacking stand-in of
# `scripts/prepare_can_dataset.py::synthetic_car_hacking` (10 features:
# CAN id, DLC, 8 data bytes; 5 classes, time-ordered frames, attack bursts
# at the published proportions), split in time order, streamed through
# 1M-row windows as the CLI's default (two windows, the second ragged).
STREAM_FRAMES, STREAM_TRAIN = 2_000_000, 1_800_000
STREAM_WINDOW = 1_000_000
STREAM_GAN_EPOCHS, STREAM_CLF_EPOCHS = 10, 1
# The strict streamed fit whose replay on the refilled second window is
# held to an eager epoch there, bitwise.
STREAM_STRICT_EPOCHS = 2
# The blob stand-in streamed in windows of 256 rows, the second lacking
# class 2; epochs per window; `epoch_chunk` of the checkpointed fit.
SMALL_WINDOW, SMALL_EPOCHS, SMALL_CHUNK = 256, 4, 2
# The classifier's captured block against its eager loop: one epoch of
# 8192 rows at batch 64 = 128 steps, one block.
CLF_CHECK_ROWS = 8192
CLF_COMPANIONS = ("CVAEGAN", "SNGAN", "CTGAN")


def load_prepare_can():
    """`scripts/prepare_can_dataset.py`, loaded by path (its top imports
    numpy only)."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parent / "scripts" / "prepare_can_dataset.py"
    spec = importlib.util.spec_from_file_location("prepare_can_dataset", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_int_csv(path, a) -> None:
    """A headerless CSV of a non-negative integer-valued array, formatted
    by column through a lookup table (np.savetxt takes ~5x longer)."""
    a = np.asarray(a).astype(np.int64)
    check(a.min() >= 0 and a.max() < 4096, f"write_int_csv: values in [{a.min()}, {a.max()}]")
    cells = np.array([str(i).encode() for i in range(4096)])[a]
    line = cells[:, 0]
    for j in range(1, a.shape[1]):
        line = np.char.add(np.char.add(line, b","), cells[:, j])
    pathlib.Path(path).write_bytes(b"\n".join(line.tolist()) + b"\n")


def write_float_csv(path, x, y, classes) -> None:
    np.savetxt(f"{path}/x.csv", x, delimiter=",", fmt="%.9g")
    np.savetxt(f"{path}/y.csv", np.eye(classes, dtype=np.int64)[y], delimiter=",", fmt="%d")


def saved_tensors(model):
    """Every tensor a checkpoint holds: the networks' and the optimizers'."""
    return [*model.state.state_dict().values(),
            *[t for opt in model.optimizers.values() for t in opt.tensors()]]


def window_patterns(y, window, classes):
    """Each window's present classes, as `ClassIndex.pattern` gives them."""
    return [tuple(bool(c) for c in np.bincount(y[i:i + window], minlength=classes) > 0)
            for i in range(0, len(y), window)]


def replay_vs_eager(torch, model):
    """One replay of the trainer's kept capture for its current data against
    one eager epoch from the same state and generator: (bitwise equal, max
    abs difference, whether the replay needed a new capture)."""
    epochs_before = len(model._graphs)
    replay = model._captured_epoch()
    new_capture = len(model._graphs) != epochs_before
    static = model._static_tensors()
    with torch.no_grad():
        saved = [t.detach().clone() for t in static]
    rng_state = model.generator.get_state()
    model._epoch_t.fill_(0)
    replay()
    replayed = [t.detach().clone() for t in static]
    with torch.no_grad():
        for t, s in zip(static, saved):
            t.copy_(s)
    model.generator.set_state(rng_state)
    model._epoch_t.fill_(0)
    model._epoch()
    torch.cuda.synchronize()
    static = [t.detach() for t in static]
    diff = max(float((a.double() - b.double()).abs().max()) for a, b in zip(replayed, static))
    return all(torch.equal(a, b) for a, b in zip(replayed, static)), diff, new_capture


def streamed_phase(torch, tp, tconfig, fused_mlp, ba, counter):
    """The `streamed` phase: the out-of-core path on the card. Returns (the
    report, the kernels' launches over it)."""
    import contextlib
    import io
    import tempfile

    from cvaegan_tpu_torch.data import streaming
    from cvaegan_tpu_torch.data.tabular import TabularDataset, minmax_scale
    from cvaegan_tpu_torch.pipelines.balance import run_streamed_pipeline
    from cvaegan_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
    from cvaegan_tpu_torch.utils.profiling import nan_debug, trace

    report = {}
    tmp = tempfile.TemporaryDirectory()
    root = pathlib.Path(tmp.name)
    zero_counts(fused_mlp, ba)

    # the corpus, split in time order -------------------------------------
    t0 = time.perf_counter()
    x, y, meta = load_prepare_can().synthetic_car_hacking(STREAM_FRAMES, seed=0)
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                           "cvaegan_tpu")]
    check(not loaded, f"loading the Car-Hacking stand-in imported {loaded}")
    classes = len(meta["classes"])
    splits = {"train": slice(0, STREAM_TRAIN), "test": slice(STREAM_TRAIN, None)}
    for split, rows in splits.items():
        write_int_csv(root / f"x_{split}.csv", x[rows])
        write_int_csv(root / f"y_{split}.csv", np.eye(classes, dtype=np.int64)[y[rows]])
    y_train = y[splits["train"]]
    report["corpus"] = {
        "frames": len(y), "features": int(x.shape[1]), "classes": classes,
        "train_counts": np.bincount(y_train, minlength=classes).tolist(),
        "test_counts": np.bincount(y[splits["test"]], minlength=classes).tolist(),
        "csv_mb": sum(p.stat().st_size for p in root.glob("*.csv")) / 1e6,
        "make_and_write_seconds": time.perf_counter() - t0}

    # 1. the native reader ----------------------------------------------------
    reader = streaming.StreamingCSV(root / "x_train.csv")
    check(reader.backend == "native", f"StreamingCSV took the {reader.backend} reader")
    t0 = time.perf_counter()
    rows = sum(len(chunk) for chunk in reader)
    read_s = time.perf_counter() - t0
    check(rows == STREAM_TRAIN, f"the native reader gave {rows} rows")
    head = root / "head.csv"
    with open(root / "x_train.csv", "rb") as f:
        head.write_bytes(b"".join(f.readline() for _ in range(10_000)))
    native = next(iter(streaming.StreamingCSV(head, 10_000)))
    plain = np.concatenate(list(streaming.StreamingCSV(head, 10_000)._iter_plain()))
    check(np.array_equal(native, plain) and np.array_equal(native, x[:10_000]),
          "the native reader's first 10k rows differ from the plain reader's or the corpus")
    report["reader"] = {"backend": reader.backend, "rows": rows, "seconds": read_s,
                        "rows_per_s": rows / read_s, "head_10k_native_equals_plain": True}

    # 2. the streamed pipeline ----------------------------------------------
    settings = tconfig.Settings()
    settings.paths = tconfig.Paths(root=root / "out")
    patterns = window_patterns(y_train, STREAM_WINDOW, classes)
    windows = len(patterns)
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()  # earlier phases' tensors still alive
    counter.reset()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        result = run_streamed_pipeline(
            tp.CVAEGAN, "CVAE_GAN", root, window_rows=STREAM_WINDOW,
            gan_epochs_per_window=STREAM_GAN_EPOCHS, clf_epochs_per_window=STREAM_CLF_EPOCHS,
            settings=settings, seed=0, balanced_mode=True, warm_start=True, device="cuda")
    torch.cuda.synchronize()
    pipeline_s = time.perf_counter() - t0
    model, clf = result["model"], result["classifier"]
    nb = -(-STREAM_WINDOW // settings.classifier.batch_size)
    clf_replays = windows * STREAM_CLF_EPOCHS * (nb // clf.BLOCK_STEPS + nb % clf.BLOCK_STEPS)
    gan_replays = windows * STREAM_GAN_EPOCHS
    captures = counter.epochs
    check(result["gan_windows"] == windows and result["clf_windows"] == windows,
          f"windows {result['gan_windows']}, {result['clf_windows']} (expected {windows})")
    check(captures == len(set(patterns)),
          f"{captures} captured epochs for {len(set(patterns))} present-class patterns")
    check(counter.replays == gan_replays + clf_replays,
          f"{counter.replays} replays, expected {gan_replays} epochs + {clf_replays} "
          "classifier blocks and steps")
    check(clf._graphs is not None and clf._graphs[1]["block"] is not None,
          "the classifier's epoch was not captured")
    history = np.asarray([model.loss_history[k] for k in model.loss_keys])
    check(history.shape == (len(model.loss_keys), gan_replays) and np.isfinite(history).all(),
          f"streamed loss history {history.shape}, finite {np.isfinite(history).all()}")
    f1s = (result["multiclass_metrics"]["F1"], result["binary_metrics"]["F1"])
    check(all(np.isfinite(f1s)), f"streamed F1 {f1s}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    peak_above_gb = peak_gb - held_before / 1e9

    replay = model._graph[1].replay
    (epoch_ms,), epoch_rounds = cuda_ms(torch, [replay], iters=5, reps=3, warmup=1)
    window = clf._window
    block = clf._graphs[1]["block"]

    def block_replay():
        window["batch"].zero_()
        block.replay()

    (block_ms,), block_rounds = cuda_ms(torch, [block_replay], iters=5, reps=3, warmup=1)
    block_break = breakdown(torch, block_replay, block_ms, calls=1, top=6)
    opt = clf._new_optimizer()

    def eager_step():
        window["batch"].zero_()
        clf._indexed_step(opt)

    (eager_steps_per_s,) = samples_per_s(torch, [eager_step], 1, iters=20, reps=2)
    report["pipeline"] = {
        "trainer": "cvae_gan", "mode": "balanced", "window_rows": STREAM_WINDOW,
        "windows": windows, "gan_epochs_per_window": STREAM_GAN_EPOCHS,
        "clf_epochs_per_window": STREAM_CLF_EPOCHS, "clf_steps_per_window_epoch": nb,
        "window_patterns": [list(p) for p in patterns], "captured_epochs": captures,
        "replays": {"gan_epochs": gan_replays, "clf_blocks_and_steps": clf_replays},
        "stage_seconds": {k: result[k] for k in ("minmax_seconds", "gan_fit_seconds",
                                                 "clf_fit_seconds", "test_seconds",
                                                 "total_seconds")},
        "pipeline_seconds": pipeline_s,
        "macro_f1": f1s[0], "binary_f1": f1s[1],
        "multiclass_metrics": result["multiclass_metrics"],
        "binary_metrics": result["binary_metrics"],
        "replayed_gan_epoch_device_ms": epoch_ms, "gan_epoch_rounds": epoch_rounds[0],
        "clf_block_device_ms": block_ms, "clf_block_rounds": block_rounds[0],
        "clf_block_breakdown": block_break,
        "clf_captured_step_device_ms": block_ms / clf.BLOCK_STEPS,
        "clf_eager_step_host_ms": 1e3 / eager_steps_per_s,
        "max_memory_allocated_gb": peak_gb, "peak_above_phase_start_gb": peak_above_gb}

    # 3a. strict: a replay on the refilled second window against eager -------
    strict = tp.CVAEGAN(seed=0, device="cuda", settings=train_settings(tconfig, 1))
    strict.verbose = False
    uploads = []
    set_data = strict._set_data

    def timed_set_data(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        set_data(*args)
        torch.cuda.synchronize()
        uploads.append((time.perf_counter() - t) * 1e3)

    strict._set_data = timed_set_data
    counter.reset()
    strict.fit_streamed(root / "x_train.csv", root / "y_train.csv", window_rows=STREAM_WINDOW,
                        epochs_per_window=STREAM_STRICT_EPOCHS)
    strict_captures = counter.epochs
    bitwise, diff, new_capture = replay_vs_eager(torch, strict)
    check(strict_captures == len(set(patterns)) and not new_capture,
          f"strict streamed fit: {strict_captures} captures, a new one for the last window: "
          f"{new_capture}")
    check(bitwise, f"strict: the replay on the refilled window differs from an eager epoch "
          f"there (max abs {diff})")
    report["refilled_window"] = {
        "mode": "strict", "epochs_per_window": STREAM_STRICT_EPOCHS,
        "captured_epochs": strict_captures,
        "replay_reuses_first_window_capture": len(set(patterns)) == 1,
        "replay_equals_eager_bitwise": bitwise, "max_abs_diff": diff,
        "window_upload_ms": uploads}

    # 3b. the blob stand-in, its second window lacking class 2 ---------------
    ds = standin_dataset(TabularDataset, minmax_scale)
    two = np.nonzero(ds.tr_labels == 2)[0]
    rest = np.nonzero(ds.tr_labels != 2)[0]
    order = np.concatenate([two[:100], rest[:156], rest[156:412], two[100:], rest[412:]])
    sx, sy = ds.tr_samples[order], ds.tr_labels[order]
    small = root / "small"
    small.mkdir()
    write_float_csv(small, sx, sy, CLASSES)
    small_patterns = window_patterns(sy, SMALL_WINDOW, CLASSES)
    check(not small_patterns[1][2], "the small corpus's second window holds class 2")

    def small_fit(eager, balanced=False, **attrs):
        m = tp.CVAEGAN(seed=0, device="cuda", settings=train_settings(tconfig, 1),
                       balanced_mode=balanced)
        m.verbose = False
        for k, v in attrs.items():
            setattr(m, k, v)
        m.fit_streamed(small / "x.csv", small / "y.csv", window_rows=SMALL_WINDOW,
                       epochs_per_window=SMALL_EPOCHS, eager=eager)
        torch.cuda.synchronize()
        return m

    # strict: absent rounds left out; balanced: labels over the present
    # classes (their order computed on the device inside the capture)
    report["absent_class"] = {"window_rows": SMALL_WINDOW, "windows": len(small_patterns),
                              "window_patterns": [list(p) for p in small_patterns]}
    for mode in ("strict", "balanced"):
        balanced = mode == "balanced"
        counter.reset()
        captured = small_fit(False, balanced)
        small_captures = counter.epochs
        eager = small_fit(True, balanced)
        err, ratio, bitwise = compare_fits(torch, captured, eager)
        cfg = captured.gan_cfg
        rounds = (len(small_patterns) if balanced
                  else sum(sum(p) for p in small_patterns)) * SMALL_EPOCHS
        want = {"encoder": rounds * cfg.g_loop_num, "generator": rounds * cfg.g_loop_num,
                "discriminator": rounds * cfg.d_loop_num, "classifier": rounds * cfg.c_loop_num}
        counts = {k: int(opt.count) for k, opt in captured.optimizers.items()}
        check(small_captures == len(set(small_patterns)),
              f"small corpus, {mode}: {small_captures} captures for "
              f"{len(set(small_patterns))} patterns")
        check(bitwise, f"small corpus, {mode}: captured and eager streamed fits differ ({err})")
        check(counts == want, f"small corpus, {mode}: Adam counts {counts}, closed form {want}")
        report["absent_class"][mode] = {
            "captured_epochs": small_captures, "captured_equals_eager_bitwise": bitwise,
            "adam_counts": counts, "closed_form": want}

    # 3c. the classifier's captured block against its eager loop ------------
    rng = np.random.default_rng(3)
    cx = rng.random((CLF_CHECK_ROWS, FEATURES), dtype=np.float32)
    cy = (np.arange(CLF_CHECK_ROWS) % CLASSES).astype(np.int32)
    clf_report = {}
    for name in CLF_COMPANIONS:
        companion = getattr(tp, name)(seed=0, device="cuda",
                                      settings=train_settings(tconfig, 1))
        companion._prepare((cx, cy))
        fits = {}
        for eager in (False, True):
            s = train_settings(tconfig, 1)
            s.classifier.epochs = 1
            c = tp.Classifier(name, seed=0, settings=s, device="cuda")
            c.warm_start_from(companion)
            counter.reset()
            c.fit((cx, cy), eager=eager)
            torch.cuda.synchronize()
            fits[eager] = (c, counter.replays)
        a, b = fits[False][0], fits[True][0]
        tensors = [(u, v) for u, v in zip(a.module.state_dict().values(),
                                          b.module.state_dict().values())]
        same = all(torch.equal(u, v) for u, v in tensors)
        moved = not all(torch.equal(u, v) for u, v in zip(
            a.module.state_dict().values(), companion.state["classifier"].state_dict().values()))
        check(fits[False][1] == 1 and fits[True][1] == 0,
              f"{name} companion: replays captured {fits[False][1]}, eager {fits[True][1]}")
        check(same and moved, f"{name} companion: captured block equals eager {same}, "
              f"moved from the companion {moved}")
        clf_report[name] = {"steps": CLF_CHECK_ROWS // 64, "block_replays": fits[False][1],
                            "captured_equals_eager_bitwise": same,
                            "tensors": len(tensors)}
    report["classifier_block_vs_eager"] = clf_report

    # 4. checkpoints ----------------------------------------------------------
    auto = root / "auto_ckpt"
    original = small_fit(False, epoch_chunk=SMALL_CHUNK, checkpoint_dir=auto)
    check((auto / "meta.json").exists() and (auto / "state.pt").exists(),
          "no checkpoint was written during the streamed fit")
    t0 = time.perf_counter()
    save_checkpoint(original, root / "saved_ckpt")
    save_s = time.perf_counter() - t0
    resumed = tp.CVAEGAN(seed=7, device="cuda", settings=train_settings(tconfig, 1))
    resumed.verbose = False
    t0 = time.perf_counter()
    restore_checkpoint(resumed, auto, (sx, sy))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same_state = all(torch.equal(a, b) for a, b in zip(saved_tensors(original),
                                                       saved_tensors(resumed)))
    check(same_state, "the restored trainer's tensors differ from the saved trainer's")
    counter.reset()
    for m in (original, resumed):
        m.checkpoint_dir = None
        m.fit_streamed(small / "x.csv", small / "y.csv", window_rows=SMALL_WINDOW,
                       epochs_per_window=SMALL_EPOCHS)
    torch.cuda.synchronize()
    further = len(small_patterns) * SMALL_EPOCHS
    err, _, bitwise = compare_fits(torch, original, resumed)
    check(counter.replays == 2 * further, f"resumed fits: {counter.replays} replays, "
          f"expected {2 * further}")
    check(bitwise, f"the resumed fit differs from the unbroken one ({err})")
    report["checkpoint"] = {"epoch_chunk": SMALL_CHUNK, "auto_checkpoint_written": True,
                            "save_seconds": save_s, "restore_seconds": restore_s,
                            "further_replayed_epochs": further,
                            "resumed_equals_unbroken_bitwise": bitwise}

    # 5. profiling -------------------------------------------------------------
    from torch.autograd import DeviceType

    with trace(root / "trace") as prof:
        replay()
    traces = list((root / "trace").glob("*.pt.trace.json"))
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
    check(traces, "trace() wrote no trace file")
    raised = ""
    with nan_debug():
        try:
            torch.log(torch.full((4,), -1.0, device="cuda"))
        except FloatingPointError as e:
            raised = str(e)
    check("log" in raised, f"nan_debug did not raise on a NaN from log(-1): {raised!r}")
    counter.reset()
    debugged = tp.CVAEGAN(seed=0, device="cuda", settings=train_settings(tconfig, 1),
                          balanced_mode=True)
    debugged.verbose = False
    with nan_debug():
        debugged.fit(ds)
    check(counter.replays == 0 and debugged._graph is None,
          f"fit inside nan_debug replayed {counter.replays} graphs")
    report["profiling"] = {"trace_files": len(traces),
                           "trace_bytes": sum(p.stat().st_size for p in traces),
                           "traced_replay_device_ms": device_us / 1e3,
                           "nan_debug_raised": raised, "nan_debug_fit_replays": 0}
    torch.cuda.synchronize()
    launches = (fused_mlp.LAUNCHES, ba.LAUNCHES, ba.ENTROPY_LAUNCHES)
    check(launches == (0, 0, 0), f"kernels launched on the streamed path: {launches}")
    tmp.cleanup()
    return report, launches


# The bf16 compute policy (`bf16`): B2/B3 on bf16 operands at the
# long-sequence path's shapes, held to the plain version run in float32 on
# the same (exactly widened) inputs, by the float32 kernels' rules; the
# 256-wide RAIN block's forward under the policy; a strict CVAE-GAN fit
# of BF16_EPOCHS epochs (captured against eager, bitwise), a bank of
# BF16_BANK_K, and the downstream classifier warm-started from the bf16
# companion. Block outputs against the dense path under the policy: bf16
# keeps 8 significant bits, so the two paths' bf16 roundings differ by a
# few 2^-9 of a value (2^-5 on the output, 2^-6 on the entropies).
BF16_EPOCHS = 3
BF16_BANK_K = 4
BF16_BLOCK_RTOL = BF16_BLOCK_ATOL = 2.0 ** -5
BF16_ENT_TOL = 2.0 ** -6


def attention_bound_bf16(part, bh, seq, d, entropy):
    """Least time of one call of a bf16 kernel as `block_attention_sm90.cu`
    computes it: Q K^T (2 bh seq^2 d FLOP) in one bf16 pass and P V (2 bh
    seq^2 d) in two, all on the tensor cores; the softmax's bh seq^2 ex2 on
    the special-function units; the entropy's 2 bh seq^2 FLOP at the
    float32 rate (the pipes overlap, so the largest term counts), against
    the bytes (bf16 q, k, v read once, float32 out and entropy written
    once) over HBM. `bound_ms_tf32_pv` is the bound of the earlier design,
    P V in two TF32 passes (and no ex2 term)."""
    flop_rate, byte_rate = PEAKS[part]
    half = 2 * bh * seq * seq * d
    extra = 2 * bh * seq * seq if entropy else 0
    nbytes = 2 * 3 * bh * seq * d + 4 * (bh * seq * d + (bh * seq if entropy else 0))
    tensor_ms = 3 * half / BF16_PEAKS[part] * 1e3
    ex2_ms = bh * seq * seq / EX2_PEAKS[part] * 1e3
    ops_ms = max(tensor_ms, ex2_ms, extra / flop_rate * 1e3)
    bytes_ms = nbytes / byte_rate * 1e3
    tf32_pv_ms = max(half / BF16_PEAKS[part] + 2 * half / TF32_PEAKS[part],
                     extra / flop_rate) * 1e3
    return {"flops": 2 * half + extra, "bf16_pass_flops": 3 * half, "ex2": bh * seq * seq,
            "bytes": nbytes, "tensor_ms": tensor_ms, "ex2_ms": ex2_ms, "ops_bound_ms": ops_ms,
            "bytes_bound_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_ms_tf32_pv": max(tf32_pv_ms, bytes_ms)}


def bf16_attention_vs_plain(torch, ba, device):
    """Both bf16 kernels against the plain version, which widens the same
    bf16 inputs to float32 (exact): at T1 [128, 1024, 64] and the d 32
    launch [128, 1024, 32] at rtol = atol = ATTN_TOL, and at inputs of
    scale 10 by `float64_rule`. Returns {kernel: {case: [max abs err,
    worst err / limit]}}."""
    g = torch.Generator(device=device).manual_seed(2)
    cases = (("t1", T1[0] * HEADS, T1[1], 64, 1.0), ("d32", 32 * HEADS, 1024, 32, 1.0),
             ("scale10", 8, 1024, 64, 10.0))
    stats = {"block_attention": {}, "block_attention_with_entropy": {}}
    for group, bh, seq, d, scale in cases:
        q, k, v = ((scale * torch.randn(bh, seq, d, generator=g, device=device)).bfloat16()
                   for _ in range(3))
        out = ba.block_attention(q, k, v)
        out_e, ent = ba.block_attention_with_entropy(q, k, v)
        torch.cuda.synchronize()
        check(out.dtype == out_e.dtype == ent.dtype == torch.float32
              and out.shape == (bh, seq, d) and ent.shape == (bh, seq),
              f"bf16 block attention gave {out.dtype} {tuple(out.shape)}, {tuple(ent.shape)}")
        ref_out, ref_ent = ba.block_attention_with_entropy_reference(q, k, v)
        check(ref_out.dtype == torch.float32, "the plain version did not widen bf16")
        pairs = (("block_attention", out, ref_out), ("block_attention_with_entropy", out_e,
                                                       ref_out),
                 ("block_attention_with_entropy", ent, ref_ent))
        if scale == 1.0:
            results = [(kernel, close_enough(got, ref, ATTN_TOL, ATTN_TOL))
                       for kernel, got, ref in pairs]
        else:
            exact = ba.block_attention_with_entropy_reference(q.double(), k.double(),
                                                              v.double())
            exacts = (exact[0], exact[0], exact[1])
            results = [(kernel, ba.float64_rule(got, ref, ex, ATTN_TOL))
                       for (kernel, got, ref), ex in zip(pairs, exacts)]
        for kernel, (err, ratio) in results:
            old = stats[kernel].get(group, [0.0, 0.0])
            stats[kernel][group] = [max(old[0], err), max(old[1], ratio)]
    return stats


def reduced_precision_probe(torch, F, model):
    """Whether cuBLAS takes a reduced-precision (bf16) reduction on the
    bf16 GEMMs of the strict CVAE-GAN's steps: each dense layer's forward
    (and its weight gradient's shape) at the step's batches, run with
    `allow_bf16_reduced_precision_reduction` on (torch's default) and off
    (float32 reduction, as XLA sums); equal outputs everywhere mean no
    split-K with a bf16 reduction was taken. The flag is restored."""
    from cvaegan_tpu_torch.models.layers import Dense, SpectralDense

    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    g = torch.Generator(device="cuda").manual_seed(4)
    shapes = set()
    for net in model.state.values():
        for m in net.modules():
            if isinstance(m, (Dense, SpectralDense)):
                out_f, in_f = m.weight.shape
                for rows in (model.gan_cfg.batch_size, 2 * model.gan_cfg.batch_size):
                    shapes.add((rows, in_f, out_f))
                    shapes.add((out_f, rows, in_f))  # the weight gradient: dy^T x
    equal = {}
    for rows, k, n in sorted(shapes):
        x = torch.randn(rows, k, generator=g, device="cuda").bfloat16()
        w = torch.randn(n, k, generator=g, device="cuda").bfloat16()
        outs = []
        for allow in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = allow
            outs.append(F.linear(x, w))
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
        equal[f"{rows}x{k}x{n}"] = bool(torch.equal(*outs))
    return {"default_allow_bf16_reduced_precision_reduction": flag,
            "gemms": len(equal), "all_equal": all(equal.values()),
            "unequal": [k for k, v in equal.items() if not v]}


def bf16_phase(torch, F, tp, tconfig, ds, make_ds, ba, fused_mlp, counter, part, card,
               wide, x_t1, qkv_t1, f32_replay):
    """The `bf16` phase (see the comment above BF16_EPOCHS). Returns (the
    report, the kernels' stats and timing for the `kernels` line, the
    path's launches (B2 bf16, B3 bf16))."""
    from cvaegan_tpu_torch.eval.classifier import Classifier
    from cvaegan_tpu_torch.models import layers as tl

    device = torch.device("cuda:0")
    stats = bf16_attention_vs_plain(torch, ba, device)
    err = {kernel: max(e for group, (e, _) in groups.items() if group != "scale10")
           for kernel, groups in stats.items()}
    for kernel, groups in stats.items():
        worst = max(r for _, r in groups.values())
        check(worst <= 1.0, f"{kernel} on bf16 disagrees with its plain version ({worst})")

    # the path: the 256-wide block's forward under the policy (bf16 B3) and
    # B2 on the bf16 q, k, v of T1, counts zeroed just before
    q16, k16, v16 = (t.bfloat16() for t in qkv_t1)
    zero_counts(fused_mlp, ba)
    with torch.no_grad(), tl.dtype_override(torch.bfloat16):
        out, row_ent = wide(x_t1)
        b2_out = ba.block_attention(q16, k16, v16)
    torch.cuda.synchronize()
    path_launches = all_counts(fused_mlp, ba)
    check(path_launches == (0, 0, 0, 1, 1),
          f"bf16 path launches (B1, B2, B3, B2 bf16, B3 bf16): {path_launches}")
    check(out.dtype == torch.float32 and row_ent.value.dtype == torch.float32,
          f"bf16 block gave {out.dtype}, entropy {row_ent.value.dtype}")
    wide.attention.use_kernel = False
    with torch.no_grad(), tl.dtype_override(torch.bfloat16):
        dense_out, probs = wide(x_t1)
        dense_ent = -(probs.float() * torch.log(probs.float() + 1e-12)).sum(-1)
    del probs
    wide.attention.use_kernel = None
    block = {"out": close_enough(out.float(), dense_out.float(), BF16_BLOCK_RTOL,
                                 BF16_BLOCK_ATOL),
             "entropy": close_enough(row_ent.value, dense_ent, BF16_ENT_TOL, BF16_ENT_TOL),
             "b2_t1": close_enough(b2_out, ba.block_attention_reference(q16, k16, v16),
                                   ATTN_TOL, ATTN_TOL)}
    check(max(r for _, r in block.values()) <= 1.0, f"bf16 block paths disagree: {block}")

    def forward(dtype):
        def run():
            with torch.no_grad(), tl.dtype_override(dtype):
                wide(x_t1)
        return run

    (f32_block_ms, bf16_block_ms), block_rounds = cuda_ms(
        torch, [forward(torch.float32), forward(torch.bfloat16)], iters=10, reps=4, warmup=2)

    # kernel timing on bf16 inputs: T1 (B2, B3, plain, SDPA) and d 32 (B3)
    timing = {}
    gd = torch.Generator(device=device).manual_seed(3)
    for name, bh, d in (("t1", T1[0] * HEADS, 64), ("d32", 32 * HEADS, 32)):
        q, k, v = (torch.randn(bh, 1024, d, generator=gd, device=device).bfloat16()
                   for _ in range(3))
        q4, k4, v4 = q[None], k[None], v[None]
        fns = [lambda: ba.block_attention(q, k, v),
               lambda: ba.block_attention_with_entropy(q, k, v),
               lambda: ba.block_attention_reference(q, k, v),
               lambda: ba.block_attention_with_entropy_reference(q, k, v),
               lambda: F.scaled_dot_product_attention(q4, k4, v4)]
        with torch.no_grad():
            times, rounds = cuda_ms(torch, fns, iters=20, reps=6, warmup=3)
            sdpa_dtype = str(F.scaled_dot_product_attention(q4, k4, v4).dtype)
        keys = ("b2_ms", "b3_ms", "b2_plain_ms", "b3_plain_ms", "sdpa_ms")
        timing[name] = {"shape": [bh, 1024, d], **dict(zip(keys, times)),
                        "rounds": dict(zip(keys, rounds)), "sdpa_output_dtype": sdpa_dtype,
                        "b2_bound": attention_bound_bf16(part, bh, 1024, d, False),
                        "b3_bound": attention_bound_bf16(part, bh, 1024, d, True)}

    # training under the policy: no kernel launches; captured = eager bitwise
    def fitted(epochs, eager=False):
        m = tp.CVAEGAN(seed=0, device="cuda",
                       settings=train_settings(tconfig, epochs, "bfloat16"))
        m.verbose = False
        m.fit(ds, eager=eager)
        torch.cuda.synchronize()
        return m

    zero_counts(fused_mlp, ba)
    counter.reset()
    captured = fitted(BF16_EPOCHS)
    calls = (counter.replays, counter.epochs)
    eager = fitted(BF16_EPOCHS, eager=True)
    fit_err, fit_ratio, bitwise = compare_fits(torch, captured, eager)
    check(calls == (BF16_EPOCHS, 1), f"bf16 fit: (replays, epoch calls) {calls}")
    check(bitwise, f"bf16 captured and eager fits differ ({fit_err})")
    dtypes = sorted({str(t.dtype) for t in state_tensors(captured)})
    check(set(dtypes) <= {"torch.float32", "torch.int32"}, f"bf16 fit state dtypes {dtypes}")
    check(all(np.isfinite(v).all() for v in captured.loss_history.values()),
          "bf16 fit: non-finite losses")
    key, graph = captured._graph
    check(key[0] == "bfloat16", f"bf16 fit captured under {key[0]}")

    def bf16_replay():
        captured._epoch_t.fill_(BF16_EPOCHS)
        graph.replay()

    (f32_ms, bf16_ms), replay_rounds = cuda_ms(torch, [f32_replay, bf16_replay], iters=10,
                                               reps=4, warmup=2)
    (bf16_rate,) = samples_per_s(torch, [bf16_replay], 1, iters=10, reps=2)
    replay_break = breakdown(torch, bf16_replay, 1e3 / bf16_rate, calls=2, top=6)

    split_k = reduced_precision_probe(torch, F, captured)

    captured.gan_cfg.compute_dtype = "float32"  # the flip: a second capture
    captured.fit(ds)
    torch.cuda.synchronize()
    check(captured._graph[0][0] == "float32" and len(captured._graphs) == 2
          and captured._graphs[key] is graph, "flipping the policy did not recapture")
    captured.gan_cfg.compute_dtype = "bfloat16"

    clf = Classifier("bf16_companion", seed=0,
                     settings=train_settings(tconfig, 1, "bfloat16"), device="cuda")
    clf.cfg.epochs = 2
    clf.warm_start_from(eager)
    clf.fit(ds)
    probs = clf.predict(ds.te_samples, use_prob=True)
    clf_dtypes = {str(p.dtype) for p in clf.module.parameters()}
    check(clf_dtypes == {"torch.float32"} and probs.dtype == np.float32,
          f"the downstream classifier left float32: {clf_dtypes}, {probs.dtype}")

    banks = [fit_bank(torch, tconfig, tp.CVAEGAN,
                      [make_ds(mix, s) for s, mix in enumerate(BANK_MIXES[:BF16_BANK_K])],
                      2, eager=eager_bank, dtype="bfloat16")
             for eager_bank in (False, True)]
    bank_bitwise = all(compare_fits(torch, a, b)[2]
                       for a, b in zip(banks[0].trainers, banks[1].trainers))
    check(bank_bitwise, "bf16 bank: captured and eager epochs differ")
    torch.cuda.synchronize()
    training_launches = all_counts(fused_mlp, ba)
    check(training_launches == (0, 0, 0, 0, 0),
          f"kernels launched on the bf16 training paths: {training_launches}")
    report = {
        "kernels_vs_plain": stats, "rtol": ATTN_TOL, "atol": ATTN_TOL,
        "path_launches_b1_b2_b3_b2bf16_b3bf16": path_launches,
        "block_t1": {"x": list(x_t1.shape), "vs_dense_bf16": block,
                     "f32_forward_ms": f32_block_ms, "bf16_forward_ms": bf16_block_ms,
                     "rounds": block_rounds},
        "timing": timing,
        "fit": {"epochs": BF16_EPOCHS, "captured_eq_eager_bitwise": bitwise,
                "state_dtypes": dtypes,
                "epoch0": {k: float(v[0]) for k, v in captured.loss_history.items()},
                "replay_device_ms": {"float32": f32_ms, "bfloat16": bf16_ms},
                "replay_rounds": {"float32": replay_rounds[0], "bfloat16": replay_rounds[1]},
                "bf16_replay_breakdown": replay_break,
                "policy_flip_recaptured": True},
        "bf16_reduced_precision_reduction_probe": split_k,
        "classifier_dtypes": sorted(clf_dtypes),
        "bank": {"k": BF16_BANK_K, "epochs": 2, "captured_eq_eager_bitwise": bank_bitwise},
        "training_launches": training_launches}
    return report, err, stats, timing, path_launches


def nccl_kernels(torch, fn, calls: int = 3):
    """(NCCL kernels per call, device ops per call) of `fn` in a
    `torch.profiler` trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    on_device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    nccl = sum(e.count for e in on_device if "nccl" in e.key.lower())
    return nccl / calls, sum(e.count for e in on_device) / calls


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_phase(torch, tp, tconfig, ds, ba, fused_mlp, part, card):
    """The `mesh` phase (13). Returns its report and B1's launches on the
    placed fast path (the `model` leg)."""
    import torch.distributed as dist

    from cvaegan_tpu_torch.kernels import ring_attention as ra
    from cvaegan_tpu_torch.parallel import distributed
    from cvaegan_tpu_torch.parallel import mesh as mesh_lib

    t0 = time.perf_counter()
    distributed.initialize(coordinator_address=f"127.0.0.1:{free_port()}",
                           num_processes=1, process_id=0)
    init_seconds = time.perf_counter() - t0
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"the process group is {dist.get_backend()} of {dist.get_world_size()}")
    mesh = distributed.global_mesh()
    check(mesh.shape == {"data": 1, "model": 1}, f"global mesh {mesh.shape}")
    report = {"backend": dist.get_backend(), "mesh": mesh.shape,
              "init_seconds": init_seconds, "nccl": ".".join(
                  str(v) for v in torch.cuda.nccl.version())}
    try:
        # one captured strict epoch from one state, without and with the mesh
        def fitted(use):
            m = tp.CVAEGAN(seed=0, device="cuda", settings=train_settings(tconfig, 1))
            m.verbose = False
            with mesh_lib.use_mesh(mesh if use else None):
                m._prepare(ds)
                draw_moments(torch, m, 0)
                mesh_lib.COLLECTIVES = 0
                m._fit_prepared(1)
            torch.cuda.synchronize()
            return m, mesh_lib.COLLECTIVES

        plain, plain_collectives = fitted(False)
        meshed, fit_collectives = fitted(True)
        check(plain_collectives == 0, f"a fit without a mesh issued {plain_collectives}")
        check(meshed._graph is not None and meshed._graph[0][1] is mesh,
              "the meshed fit did not replay a capture keyed by its mesh")
        err, ratio, bitwise = compare_fits(torch, plain, meshed, MESH_RTOL, MESH_ATOL)
        check(ratio <= 1.0, f"meshed and plain epochs disagree ({ratio} of the tolerance)")
        replays = []
        for m in (plain, meshed):
            graph = m._graph[1]

            def replay(m=m, graph=graph):
                m._epoch_t.fill_(1)
                graph.replay()
            replays.append(replay)
        (plain_ms, mesh_ms), rounds = cuda_ms(torch, replays, iters=5, reps=4, warmup=1)
        nccl_per_replay, ops_per_replay = nccl_kernels(torch, replays[1], calls=1)
        _, plain_ops = nccl_kernels(torch, replays[0], calls=1)
        with mesh_lib.use_mesh(mesh), mesh_lib.data_parallel(meshed.gan_cfg.batch_size):
            mesh_lib.COLLECTIVES = 0
            meshed._epoch()  # eager: the collectives one epoch issues
            per_epoch = mesh_lib.COLLECTIVES
        torch.cuda.synchronize()
        report["epoch"] = {
            "rtol": MESH_RTOL, "atol": MESH_ATOL, "max_abs_diff": err,
            "worst_err_over_tol": ratio, "bitwise": bitwise,
            "epoch0": {k: v[0] for k, v in meshed.loss_history.items()},
            "replay_device_ms": {"plain": plain_ms, "mesh": mesh_ms},
            "replay_rounds": {"plain": rounds[0], "mesh": rounds[1]},
            "collectives_per_epoch": per_epoch,
            "collectives_in_fit_with_warm_up_and_capture": fit_collectives,
            "steps_per_epoch": meshed._steps_per_epoch(),
            "nccl_kernels_per_replay": nccl_per_replay,
            "device_ops_per_replay": {"plain": plain_ops, "mesh": ops_per_replay}}

        report["model"], fast_launches = model_leg(torch, tp, tconfig, ds, fused_mlp, mesh,
                                                   plain, meshed, plain_ops)

        # SeedBank(mesh=): one data rank trains all K and gathers them
        def bank(use):
            b = tp.SeedBank(tp.CVAEGAN, list(range(MESH_BANK_K)),
                            settings=train_settings(tconfig, MESH_BANK_EPOCHS),
                            device="cuda", mesh=mesh if use else None)
            for t in b.trainers:
                t.verbose = False
            b.fit(ds)
            torch.cuda.synchronize()
            return b

        plain_bank, mesh_bank = bank(False), bank(True)
        worst, bank_bitwise = 0.0, True
        for a, b in zip(plain_bank.trainers, mesh_bank.trainers):
            _, r, bw = compare_fits(torch, a, b)
            worst, bank_bitwise = max(worst, r), bank_bitwise and bw
        check(worst <= 1.0, f"the meshed bank's replicas disagree with the plain bank's "
              f"({worst})")
        report["seed_bank"] = {"k": MESH_BANK_K, "epochs": MESH_BANK_EPOCHS,
                               "rtol": TRAIN_RTOL, "atol": TRAIN_ATOL,
                               "worst_err_over_tol": worst, "bitwise": bank_bitwise,
                               "steps_per_sec": {"plain": plain_bank.steps_per_sec,
                                                 "mesh": mesh_bank.steps_per_sec}}

        # ring attention on the 1-rank ring at T1
        gd = torch.Generator(device="cuda").manual_seed(13)
        bh, seq = T1[0] * HEADS, T1[1]
        q, k, v = (torch.randn(bh, seq, 64, generator=gd, device="cuda") for _ in range(3))
        with torch.no_grad():
            out, ent = ra.ring_attention(q, k, v, mesh, with_entropy=True)
            out_only = ra.ring_attention(q, k, v, mesh)
            refs = {"plain": (ba.reference_attention(q, k, v),
                              ba.reference_attention_entropy(q, k)),
                    "b2_b3": ba.block_attention_with_entropy(q, k, v)}
            b2 = ba.block_attention(q, k, v)
            ring_err = {}
            for name, (ref_out, ref_ent) in refs.items():
                ring_err[name] = {
                    "out": close_enough(out, ref_out, ATTN_TOL, ATTN_TOL),
                    "entropy": close_enough(ent, ref_ent, ATTN_TOL, ATTN_TOL),
                    "out_without_entropy": close_enough(
                        out_only, b2 if name == "b2_b3" else ref_out, ATTN_TOL, ATTN_TOL)}
            worst = max(r for errs in ring_err.values() for _, r in errs.values())
            check(worst <= 1.0, f"ring attention disagrees ({ring_err})")
            times, rounds = cuda_ms(torch, [
                lambda: ra.ring_attention(q, k, v, mesh),
                lambda: ba.block_attention(q, k, v),
                lambda: ra.ring_attention(q, k, v, mesh, with_entropy=True),
                lambda: ba.block_attention_with_entropy(q, k, v)],
                iters=5, reps=4, warmup=2)
        keys = ("ring_ms", "b2_ms", "ring_entropy_ms", "b3_ms")
        report["ring_attention"] = {
            "shape": [bh, seq, 64], "tol": ATTN_TOL, "err": ring_err,
            **dict(zip(keys, times)), "rounds": dict(zip(keys, rounds)),
            "b2_bound": attention_bound(part, bh, seq, 64, entropy=False)["bound_ms"],
            "b3_bound": attention_bound(part, bh, seq, 64, entropy=True)["bound_ms"]}
    finally:
        dist.destroy_process_group()
    report["destroyed"] = not dist.is_initialized()
    check(report["destroyed"], "the process group outlived the phase")
    return report, fast_launches


def model_leg(torch, tp, tconfig, ds, fused_mlp, mesh, plain, meshed, plain_ops):
    """The `model` leg of the mesh phase: on the 1-rank group, every leaf
    `shard_net_state` shards at n_model = MODEL_LEG_N is placed onto its
    'model' spec (each slice the whole leaf), so every tensor-parallel
    path runs: the gathers, the backward all-reduces, the spectral partial
    products and the fast path's gather before B1. The captured strict
    CVAE-GAN and RAIN-GAN epochs on the placed states, their collectives
    in the graph, are held to fresh plain epochs bitwise, and so is the
    placed fast path's output. The placed CVAE-GAN's replay is timed in
    the same rounds as `plain` and `meshed`, the phase's plain and
    data-only meshed trainers (`plain_ops`: the plain replay's device
    ops), and profiled once; RAIN-GAN's is timed beside its plain one.
    A capture records one epoch's collectives, which are counted there.
    Returns (report, B1 launches of the placed fast path)."""
    from cvaegan_tpu_torch.parallel import mesh as mesh_lib

    def fitted(cls, placed):
        m = cls(seed=0, device="cuda", settings=train_settings(tconfig, 1))
        m.verbose = False
        counts = {}
        warm_up = m._warm_up

        def counted_warm_up():
            warm_up()
            counts["warm_up"] = mesh_lib.COLLECTIVES
        m._warm_up = counted_warm_up
        with mesh_lib.use_mesh(mesh if placed else None):
            m._prepare(ds)
            draw_moments(torch, m, 0)
            if placed:
                mesh_lib.place(m.state, mesh_lib.shard_net_state(
                    m.state, mesh, n_model=MODEL_LEG_N), m.optimizers)
            mesh_lib.COLLECTIVES = 0
            m._fit_prepared(1)
        torch.cuda.synchronize()
        del m._warm_up
        return m, mesh_lib.COLLECTIVES, mesh_lib.COLLECTIVES - counts["warm_up"]

    def replay_of(m):
        graph = m._graph[1]

        def replay():
            m._epoch_t.fill_(1)
            graph.replay()
        return replay

    report, fast_launches = {"n_model_specs": MODEL_LEG_N}, 0
    for name, cls in (("cvae_gan", tp.CVAEGAN), ("rain_gan", tp.RAIN_GAN)):
        t0 = time.perf_counter()
        base = fitted(cls, False)[0]
        m, fit_collectives, per_epoch = fitted(cls, True)
        sliced = sum(mesh_lib.shard_of(t) is not None for t in m._static_tensors())
        check(sliced > 0, f"{name}: no leaf was placed over 'model'")
        check(m._graph is not None and m._graph[0][3] == m._placement_key(),
              f"{name}: the placed fit did not replay a capture keyed by its placement")
        _, ratio, bitwise = compare_fits(torch, base, m, MESH_RTOL, MESH_ATOL)
        check(bitwise, f"{name}: the placed epoch is not the plain one bitwise "
              f"({ratio} of the tolerance)")
        entry = {"sliced_tensors": sliced, "bitwise": bitwise,
                 "collectives_per_epoch": per_epoch,
                 "collectives_in_fit_with_warm_up_and_capture": fit_collectives,
                 "steps_per_epoch": m._steps_per_epoch()}
        if name == "cvae_gan":
            # the fast path, from the two equal states and generators: the
            # placed generator's leaves gathered, then B1
            with torch.no_grad():
                want = base.generate_samples_fast(0, SERVE_ROWS)
                before = fused_mlp.LAUNCHES
                got = m.generate_samples_fast(0, SERVE_ROWS)
                torch.cuda.synchronize()
                fast_launches = fused_mlp.LAUNCHES - before
            check(fast_launches == 1,
                  f"the placed fast path launched B1 {fast_launches} times")
            check(np.array_equal(got, want), "the placed fast path is not the plain one "
                  "bitwise")
            check("fast_fold" in m._gen_cache, "the placed fast path kept no fold")
            report["fast_path"] = {"rows": SERVE_ROWS, "b1_launches": fast_launches,
                                   "bitwise": True}
            entry["nccl_kernels_per_replay"], entry["device_ops_per_replay"] = nccl_kernels(
                torch, replay_of(m), calls=1)
            entry["device_ops_per_replay_plain"] = plain_ops
            runs = {"plain": replay_of(plain), "data_mesh": replay_of(meshed),
                    "model_placed": replay_of(m)}
            times, rounds = cuda_ms(torch, list(runs.values()), iters=5, reps=4, warmup=1)
        else:
            runs = {"plain": replay_of(base), "model_placed": replay_of(m)}
            times, rounds = cuda_ms(torch, list(runs.values()), iters=3, reps=4, warmup=2)
        entry["replay_device_ms"] = dict(zip(runs, times))
        entry["replay_rounds"] = dict(zip(runs, rounds))
        entry["seconds"] = time.perf_counter() - t0
        report[name] = entry
    return report, fast_launches


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
    sources = {"fused_mlp4": fused_mlp.SOURCE,
               "block_attention": ba.SOURCES[torch.float32],
               "block_attention_bf16": ba.SOURCES[torch.bfloat16]}

    def timed_build(source):
        t = time.perf_counter()
        _build.build(source)
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        seconds = dict(zip(sources.values(), pool.map(timed_build, sources.values())))
    fused_mlp.build()
    for dtype in ba.SOURCES:
        ba.build(dtype)
    emit({"phase": "build", "wall_seconds": time.perf_counter() - t0})
    for kernel, source in sources.items():
        lib = _build.library_path(source)
        report = {"phase": "build", "kernel": kernel, "seconds": seconds[source],
                  "ptxas": ptxas_report(lib.with_suffix(".log").read_text())}
        if source == ba.SOURCES[torch.bfloat16]:
            report["sass"] = sass_counts(lib, ("HGMMA", "UTMALDG", "HMMA"))
            check(all(c.get("HGMMA") and c.get("UTMALDG") for c in report["sass"].values()),
                  f"a bf16 attention kernel without wgmma or TMA: {report['sass']}")
        emit(report)

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
    import tempfile

    import cvaegan_tpu_torch as tp
    from cvaegan_tpu_torch.algorithms.base import GenerativeTrainer
    from cvaegan_tpu_torch.core import config as tconfig
    from cvaegan_tpu_torch.data.tabular import TabularDataset, minmax_scale
    from cvaegan_tpu_torch.pipelines.balance import run_balance_pipeline

    ds = standin_dataset(TabularDataset, minmax_scale)
    counter = ReplayCounter(torch, GenerativeTrainer)

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
        settings.paths = tconfig.Paths(root=pathlib.Path(tmp))
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            result = run_balance_pipeline(CVAEGAN, "CVAE_GAN", ds, out_dir=tmp,
                                          settings=settings, plot=False, device="cuda")
        added, augmented_counts = check_pipeline(result, ds)
    f1 = result["multiclass_metrics"]["F1"]
    clf_seconds = result["classifier"].fit_seconds
    torch.cuda.synchronize()
    training_launches = (fused_mlp.LAUNCHES, ba.LAUNCHES, ba.ENTROPY_LAUNCHES)
    emit({"phase": "pipeline", "gan_epochs": GAN_EPOCHS, "clf_epochs": CLF_EPOCHS,
          "generated_rows": added, "augmented_counts": augmented_counts,
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
    serial_break = breakdown(torch, replay_fn, replay_call_ms, calls=3, top=8)
    emit({"phase": "breakdown", "call": "replayed strict epoch", "card": card,
          **serial_break})
    emit({"phase": "breakdown", "call": "eager strict epoch", "card": card,
          **breakdown(torch, eager_epoch, 1e3 / eager_rate, calls=2, top=8)})

    # 8. the other trainers -------------------------------------------------
    family, family_missed, family_train, family_fast = family_phase(
        torch, tp, tconfig, ds, fused_mlp, ba, counter)
    emit({"phase": "family", "card": card, "rows": len(ds.tr_labels),
          "rtol": TRAIN_RTOL, "atol": TRAIN_ATOL, "trainers": family,
          "training_launches_fused_b2_b3": family_train,
          "fast_path_launches": family_fast, "gates_missed": family_missed})
    check(not family_missed, "; ".join(family_missed))

    # 9. SeedBank -----------------------------------------------------------
    bank, bank_train, bank_fast = bank_phase(
        torch, tp, tconfig,
        lambda counts, seed: standin_dataset(TabularDataset, minmax_scale, counts, seed),
        fused_mlp, ba, counter, serial_break.get("device_ops_per_call"))
    emit({"phase": "seed_bank", "card": card, "trainer": "cvae_gan", "mode": "strict",
          **bank, "training_launches_fused_b2_b3": bank_train})

    # 10. SeedBank of the other five trainers -------------------------------
    t0 = time.perf_counter()
    bank_family, bank_family_train, bank_family_fast = bank_family_phase(
        torch, tp, tconfig,
        lambda counts, seed: standin_dataset(TabularDataset, minmax_scale, counts, seed),
        fused_mlp, ba, counter, family)
    emit({"phase": "seed_bank_family", "card": card, "mode": "strict", **bank_family,
          "training_launches_fused_b2_b3": bank_family_train,
          "replica_fast_launches": bank_family_fast,
          "wall_seconds": time.perf_counter() - t0})
    check(family_train == [0, 0, 0] and bank_train == [0, 0, 0]
          and bank_family_train == [0, 0, 0],
          f"kernels launched on the family or bank training paths (fused, B2, B3): "
          f"{family_train}, {bank_train}, {bank_family_train}")

    # 11. out of core --------------------------------------------------------
    t0 = time.perf_counter()
    streamed, streamed_launches = streamed_phase(torch, tp, tconfig, fused_mlp, ba, counter)
    emit({"phase": "streamed", "card": card, **streamed,
          "launches_fused_b2_b3": streamed_launches,
          "wall_seconds": time.perf_counter() - t0})

    # 12. the bf16 policy ----------------------------------------------------
    t0 = time.perf_counter()
    bf16, bf16_err, bf16_stats, bf16_timing, bf16_launches = bf16_phase(
        torch, F, tp, tconfig, ds,
        lambda counts, seed: standin_dataset(TabularDataset, minmax_scale, counts, seed),
        ba, fused_mlp, counter, part, card, wide, xs["t1"], qkv_t1, replay_ms["strict"][0])
    counter.restore()
    emit({"phase": "bf16", "card": card, "peaks_of": part, **bf16,
          "wall_seconds": time.perf_counter() - t0})

    # 13. the device mesh --------------------------------------------------
    # (its B2/B3 launches compare ring attention with them: none is counted)
    t0 = time.perf_counter()
    mesh, mesh_fast = mesh_phase(torch, tp, tconfig, ds, ba, fused_mlp, part, card)
    emit({"phase": "mesh", "card": card, **mesh, "wall_seconds": time.perf_counter() - t0})
    training_launches = tuple(sum(n) for n in zip(training_launches, family_train,
                                                  bank_train, bank_family_train,
                                                  streamed_launches))

    def attention_entry(name, replaces, launches_, entropy, library):
        t1, t2 = attn_timing["t1"], attn_timing["t2"]
        key = "b3" if entropy else "b2"
        bound1, bound2 = t1[f"{key}_bound"], t2[f"{key}_bound"]
        return {
            "name": name, "route": "cuda",
            "source": "cvaegan_tpu_torch/csrc/block_attention.cu",
            "replaces": replaces, "launches": launches_,
            "training_launches": training_launches[2 if entropy else 1],
            "streamed_launches": streamed_launches[2 if entropy else 1],
            "max_abs_err": attn_err[name],
            "scale10_err_over_limit": attn_stats[name]["scale10"][1],
            "shape": t1["shape"],
            "ms": t1[f"{key}_ms"], "plain_ms": t1[f"{key}_plain_ms"],
            "bound_ms": bound1["bound_ms"], "bound_by": bound1["bound_by"],
            "library_ms": t1["sdpa_ms"] if library else None,
            "t2": {"shape": t2["shape"], "ms": t2[f"{key}_ms"],
                   "plain_ms": t2[f"{key}_plain_ms"], "bound_ms": bound2["bound_ms"],
                   "library_ms": t2["sdpa_ms"] if library else None}}

    def bf16_entry(name, replaces, launches_, entropy, library):
        key = "b3" if entropy else "b2"
        t1, d32 = bf16_timing["t1"], bf16_timing["d32"]
        bound = t1[f"{key}_bound"]
        return {
            "name": f"{name}_bf16", "route": "cuda",
            "source": "cvaegan_tpu_torch/csrc/block_attention_sm90.cu",
            "replaces": replaces, "launches": launches_,
            "training_launches": bf16["training_launches"][4 if entropy else 3],
            "max_abs_err": bf16_err[name],
            "scale10_err_over_limit": bf16_stats[name]["scale10"][1],
            "inputs": "bfloat16", "shape": t1["shape"],
            "ms": t1[f"{key}_ms"], "plain_ms": t1[f"{key}_plain_ms"],
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "bound_ms_tf32_pv": bound["bound_ms_tf32_pv"],
            "library_ms": t1["sdpa_ms"] if library else None,
            "d32": {"shape": d32["shape"], "ms": d32[f"{key}_ms"],
                    "plain_ms": d32[f"{key}_plain_ms"],
                    "bound_ms": d32[f"{key}_bound"]["bound_ms"],
                    "bound_by": d32[f"{key}_bound"]["bound_by"],
                    "bound_ms_tf32_pv": d32[f"{key}_bound"]["bound_ms_tf32_pv"],
                    "library_ms": d32["sdpa_ms"] if library else None}}

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
         "launches": (launches["total"] + family_fast + bank_fast + bank_family_fast
                      + mesh_fast),
         "launches_by_path": {"cvae_gan": launches["total"],
                              "mesh_model_placed_fast_path": mesh_fast,
                              "family_fast_paths": family_fast,
                              "seed_bank_replica": bank_fast,
                              "seed_bank_family_qg_smote_replica": bank_family_fast,
                              "streamed": streamed_launches[0]},
         "launches_by_variant": launches,
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
        bf16_entry("block_attention", "cvaegan_tpu/kernels/block_attention.py:30",
                   bf16_launches[3], entropy=False, library=True),
        bf16_entry("block_attention_with_entropy", "cvaegan_tpu/kernels/block_attention.py:56",
                   bf16_launches[4], entropy=True, library=False),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
