"""The bf16 policy against float32 on every trainer's replayed epoch, on the card.

For each of the port's eleven trainers, a one-epoch strict fit on the
numpy blob stand-in of `chip_smoke.py` is captured under each policy
(`settings.gan.compute_dtype` "float32" and "bfloat16"), and the two
replays are timed in alternating rounds with CUDA events behind a spin
kernel (`chip_smoke.cuda_ms`), the SM clock read after each round
(`nvidia-smi --query-gpu=clocks.sm`); the device ops of one replay of each
come from a `torch.profiler` trace. One JSON line per trainer, with the
card's name and power limit, appended to `--out` (by default
`experiments/results/torch_port_bf16_zoo.jsonl`) and printed:

    python experiments/torch_port_bf16_zoo.py

Imports no JAX. Needs a card: exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:  # run as `python experiments/<this>.py`
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

TRAINERS = ("CVAEGAN", "CGAN", "CVAE", "GAN", "VAE", "VAEGAN", "RAIN_GAN", "SNGAN",
            "CTGAN", "QG_SMOTE", "TMGGAN")
POLICIES = ("float32", "bfloat16")


def sm_clock() -> int:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return int(out.stdout.strip().splitlines()[0])


def captured(torch, tp, tconfig, cls, ds, dtype, out_dir):
    """A one-epoch strict fit under `dtype` (its epoch captured and
    replayed once) and a function replaying that capture."""
    settings = chip_smoke.train_settings(tconfig, 1, dtype)
    settings.paths = tconfig.Paths(root=out_dir)  # TMG-GAN's chunk-end scatters
    model = cls(seed=0, device="cuda", settings=settings)
    model.verbose = False
    model.fit(ds)
    torch.cuda.synchronize()
    key, graph = model._graph
    if key[0] != dtype:
        raise SystemExit(f"torch_port_bf16_zoo: {cls.__name__} captured under {key[0]}")
    dtypes = {t.dtype for t in model._static_tensors()}
    if not dtypes <= {torch.float32, torch.int32}:
        raise SystemExit(f"torch_port_bf16_zoo: {cls.__name__} state left float32: {dtypes}")

    def replay():
        model._epoch_t.fill_(1)
        graph.replay()
    return model, replay


def device_ops(torch, fn) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return float(sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA))


def measure(torch, tp, tconfig, name, ds, card, rounds, iters, out_dir) -> dict:
    t0 = time.perf_counter()
    cls = getattr(tp, name)
    runs = {dtype: captured(torch, tp, tconfig, cls, ds, dtype, out_dir) for dtype in POLICIES}
    replays = [runs[dtype][1] for dtype in POLICIES]
    for fn in replays:  # warm-up
        fn()
    times = {dtype: [] for dtype in POLICIES}
    clocks = {dtype: [] for dtype in POLICIES}
    for r in range(rounds):
        order = POLICIES if r % 2 == 0 else POLICIES[::-1]
        for dtype in order:
            (ms,), _ = chip_smoke.cuda_ms(torch, [runs[dtype][1]], iters=iters, reps=1,
                                          warmup=0)
            times[dtype].append(ms)
            clocks[dtype].append(sm_clock())
    model = runs["float32"][0]
    line = {"trainer": name, "card": card, "steps_per_epoch": model._steps_per_epoch(),
            "rounds": rounds, "replays_per_round": iters}
    for dtype in POLICIES:
        line[dtype] = {"replay_ms_median": float(np.median(times[dtype])),
                       "replay_ms_rounds": times[dtype],
                       "sm_clock_mhz_rounds": clocks[dtype],
                       "device_ops_per_replay": device_ops(torch, runs[dtype][1])}
    line["bf16_over_f32_time"] = (line["bfloat16"]["replay_ms_median"]
                                  / line["float32"]["replay_ms_median"])
    line["bf16_over_f32_ops"] = (line["bfloat16"]["device_ops_per_replay"]
                                 / line["float32"]["device_ops_per_replay"])
    line["seconds"] = time.perf_counter() - t0
    return line


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=str(REPO / "experiments" / "results"
                                        / "torch_port_bf16_zoo.jsonl"))
    p.add_argument("--trainers", nargs="+", default=list(TRAINERS), choices=TRAINERS)
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--iters", type=int, default=5, help="replays per timed round")
    args = p.parse_args()

    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("torch_port_bf16_zoo: CUDA is not available", file=sys.stderr)
        return 1
    import cvaegan_tpu_torch as tp
    from cvaegan_tpu_torch.core import config as tconfig
    from cvaegan_tpu_torch.data.tabular import TabularDataset, minmax_scale

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.nvidia_smi("name,power.limit")
    ds = chip_smoke.standin_dataset(TabularDataset, minmax_scale)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as out_dir:
        for name in args.trainers:
            line = measure(torch, tp, tconfig, name, ds, card, args.rounds, args.iters,
                           pathlib.Path(out_dir))
            with open(out, "a") as f:
                f.write(json.dumps(line) + "\n")
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
