#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`cvaegan_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's serving path for the flagship CVAE-GAN at full width
(30 features, 5 classes, z 128, generator 133->256->128->64->30) with
random weights made from a seed, on `cuda:0`:

  1. environment: torch/CUDA versions, card name and power limit; TF32 off;
  2. build: compiles every kernel of the path from `cvaegan_tpu_torch/csrc`;
  3. kernel against plain: each kernel's wrapper against its plain PyTorch
     version on the card, at the path's shapes;
  4. slice: `generate_samples`, `generate_samples_fast`,
     `generate_qualified_samples` and `reconstruct_samples` for every
     class, with the kernels' launch counts set to 0 just before and read
     just after;
  5. timing: CUDA events, after warm-up;
  6. breakdown: `torch.profiler` over serving calls on each path, for the
     device time per call, its idle share and the kernels that take it.

Each phase prints one JSON line; then the `kernels` line, the card's name
and power limit as `nvidia-smi` gives them, and as the last line
`{"ok": true, "device": {...}}`. Any failure raises and exits non-zero,
as does a run without CUDA or without the repository beside the script.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# Kernel vs its plain version: both accumulate in float32 (TF32 off), in
# different orders, so they agree to float32 rounding.
RTOL, ATOL = 1e-5, 1e-6
WIDTHS = (133, 256, 128, 64, 30)
KERNEL_NS = (1, 7, 100, 511, 513, 4096, 8192, 65536)
FINALS = ("sigmoid", "tanh", "none")
FEATURES, CLASSES = 30, 5
SERVE_ROWS = 8192
QUALIFIED_ROWS = 300
RECON_ROWS = 256
# Datasheet peaks: float32 outside the tensor cores, and HBM bandwidth.
PEAKS = {"H100 SXM": (67e12, 3.35e12), "H100 PCIe": (51e12, 2.0e12),
         "H100 NVL": (60e12, 3.9e12)}


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


def close_enough(got, ref):
    """(max abs error, worst err / (atol + rtol |ref|)); passes at <= 1."""
    err = (got - ref).abs()
    ratio = err / (ATOL + RTOL * ref.abs())
    return float(err.max()), float(ratio.max())


def cuda_ms(torch, fns, iters: int = 100, reps: int = 6):
    """Each function's mean time over `iters` calls, in ms, timed with CUDA
    events in `reps` rounds in which the functions take turns (a, b, b, a,
    ...). Returns (the median of each, every round's times of each)."""
    for fn in fns:
        for _ in range(10):
            fn()
    times = [[] for _ in fns]
    for r in range(reps):
        for i in (range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
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
            "top": [[e.key[:60], e.self_device_time_total / 1e3 / calls, e.count // calls]
                    for e in on_device[:top]]}


def random_mlp(torch, rng, device):
    ws = [torch.tensor(rng.standard_normal((WIDTHS[i], WIDTHS[i + 1]),
                                           dtype=np.float32) * 0.1, device=device)
          for i in range(4)]
    bs = [torch.tensor(rng.standard_normal(WIDTHS[i + 1], dtype=np.float32) * 0.1,
                       device=device) for i in range(4)]
    return ws, bs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cvaegan_tpu_torch import CVAEGAN
    from cvaegan_tpu_torch.core.state import apply_eval, apply_train
    from cvaegan_tpu_torch.kernels import _build, fused_mlp
    from cvaegan_tpu_torch.models.layers import one_hot

    device = torch.device("cuda:0")
    torch.cuda.set_device(device)

    # 1. environment ---------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi("name,power.limit")
    emit({"phase": "environment", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "card": card, "device_count": torch.cuda.device_count()})

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    fused_mlp.build()
    build_s = time.perf_counter() - t0
    log = _build.library_path(fused_mlp.SOURCE).with_suffix(".log").read_text()
    emit({"phase": "build", "kernel": "fused_mlp4", "seconds": build_s,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    # 3. kernel against plain ------------------------------------------------
    rng = np.random.default_rng(0)
    ws, bs = random_mlp(torch, rng, device)
    max_err, worst = 0.0, 0.0
    for n in KERNEL_NS:
        x = torch.tensor(rng.standard_normal((n, WIDTHS[0]), dtype=np.float32),
                         device=device)
        for final in FINALS:
            got = fused_mlp.fused_mlp4(x, ws, bs, final=final)
            ref = fused_mlp.mlp4_reference(x, ws, bs, final=final)
            torch.cuda.synchronize()
            check(got.shape == (n, WIDTHS[-1]), f"fused_mlp4 gave shape {tuple(got.shape)}")
            err, ratio = close_enough(got, ref)
            max_err, worst = max(max_err, err), max(worst, ratio)
    emit({"phase": "kernel_vs_plain", "kernel": "fused_mlp4", "ns": KERNEL_NS,
          "finals": FINALS, "rtol": RTOL, "atol": ATOL, "max_abs_err": max_err,
          "worst_err_over_tol": worst})
    check(worst <= 1.0, f"fused_mlp4 disagrees with mlp4_reference ({worst})")

    # 4. slice ---------------------------------------------------------------
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

    fused_mlp.LAUNCHES = 0
    qualified = {}
    for c in range(CLASSES):
        for fn in (model.generate_samples, model.generate_samples_fast):
            s = fn(c, SERVE_ROWS)
            check(s.shape == (SERVE_ROWS, FEATURES) and s.dtype == np.float32,
                  f"{fn.__name__} gave {s.shape} {s.dtype}")
            check(np.isfinite(s).all() and s.min() >= 0.0 and s.max() <= 1.0,
                  f"{fn.__name__} gave values outside [0, 1]")
        for thr in (None, 0.0):
            q = model.generate_qualified_samples(c, QUALIFIED_ROWS,
                                                 confidence_threshold=thr)
            qualified[(c, thr)] = q
    recon = model.reconstruct_samples(x_np[:RECON_ROWS], y_np[:RECON_ROWS])
    torch.cuda.synchronize()
    launches = fused_mlp.LAUNCHES

    check(launches == CLASSES, f"fused_mlp4 launched {launches} times on the path")
    check(recon.shape == (RECON_ROWS, FEATURES) and np.isfinite(recon).all(),
          "reconstruct_samples gave a wrong shape or non-finite values")
    default_thr = model.hparams["confidence_threshold"]
    check(sum(len(qualified[(c, 0.0)]) for c in range(CLASSES)) > 0,
          "no class yields a row at threshold 0: the filter went unchecked")
    yields = {}
    fstate = model._filter_state(model.state)
    for (c, thr), q in qualified.items():
        check(q.shape[1] == FEATURES and len(q) <= QUALIFIED_ROWS,
              f"generate_qualified_samples gave {q.shape}")
        yields[f"{c}@{default_thr if thr is None else thr}"] = len(q)
        if len(q):
            probs = torch.softmax(model._classifier_logits(
                fstate, torch.as_tensor(q, device=device)), dim=-1)
            ok = ((probs.amax(-1) > (default_thr if thr is None else thr))
                  & (probs.argmax(-1) == c))
            check(bool(ok.all()), f"class {c}: a returned row fails the filter")

    z = torch.randn((SERVE_ROWS, model.gan_cfg.z_size), generator=model.generator,
                    device=device)
    labels = torch.arange(SERVE_ROWS, device=device) % CLASSES
    onehot = one_hot(labels, CLASSES)
    with torch.no_grad():
        fast = fused_mlp.fast_generator_forward(gen, z, onehot)
    module_out, _ = apply_eval(gen, z, labels)
    slice_err, slice_ratio = close_enough(fast, module_out)
    emit({"phase": "slice", "model": "cvae_gan", "features": FEATURES,
          "classes": CLASSES, "rows_per_call": SERVE_ROWS,
          "fused_launches": launches, "qualified_rows": yields,
          "recon_shape": list(recon.shape),
          "fused_vs_module_max_abs_err": slice_err,
          "fused_vs_module_err_over_tol": slice_ratio})
    check(slice_ratio <= 1.0, "fused generator path disagrees with the module")

    # 5. timing --------------------------------------------------------------
    with torch.no_grad():
        weights, biases = fused_mlp.generator_fast_params(gen)
        x_serve = torch.cat([z, onehot], dim=-1)
        (kernel_ms, plain_ms), rounds = cuda_ms(torch, [
            lambda: fused_mlp.fused_mlp4(x_serve, weights, biases),
            lambda: fused_mlp.mlp4_reference(x_serve, weights, biases)])
    rows = x_serve.shape[0]
    flops = 2 * rows * sum(w.numel() for w in weights)
    nbytes = 4 * (x_serve.numel() + sum(w.numel() for w in weights)
                  + sum(b.numel() for b in biases) + rows * weights[-1].shape[1])
    part, (flop_rate, byte_rate) = peaks_for(card)
    ops_ms, bytes_ms = flops / flop_rate * 1e3, nbytes / byte_rate * 1e3
    gen_rate, fast_rate = samples_per_s(torch, [
        lambda: model.generate_samples(0, SERVE_ROWS),
        lambda: model.generate_samples_fast(0, SERVE_ROWS)], SERVE_ROWS)
    emit({"phase": "timing", "card": card, "rows": SERVE_ROWS,
          "fused_mlp4_ms": kernel_ms, "mlp4_reference_ms": plain_ms,
          "fused_mlp4_ms_rounds": rounds[0], "mlp4_reference_ms_rounds": rounds[1],
          "flops": flops, "bytes": nbytes, "peaks_of": part,
          "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms,
          "generate_samples_per_s": gen_rate,
          "generate_samples_fast_per_s": fast_rate})

    # 6. breakdown -----------------------------------------------------------
    for name, fn, rate in (("generate_samples", model.generate_samples, gen_rate),
                           ("generate_samples_fast", model.generate_samples_fast,
                            fast_rate)):
        emit({"phase": "breakdown", "call": name, "rows": SERVE_ROWS, "card": card,
              **breakdown(torch, lambda: fn(0, SERVE_ROWS), SERVE_ROWS / rate * 1e3)})

    emit({"kernels": [{
        "name": "fused_mlp4", "route": "cuda",
        "source": "cvaegan_tpu_torch/csrc/fused_mlp4.cu",
        "replaces": "cvaegan_tpu/kernels/fused_mlp.py:44",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
