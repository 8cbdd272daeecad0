#!/usr/bin/env python
"""The JAX package's strict-mode CVAE-GAN loss curves on the blob stand-in
that `chip_smoke.py` trains the PyTorch port on, as the reference for the
port's `train` phase.

    JAX_PLATFORMS=cpu python experiments/torch_port_strict_reference.py --seeds 5

Fits `cvaegan_tpu.CVAEGAN` for 500 epochs per seed (strict and balanced
mode) on `chip_smoke.standin_dataset` and prints one JSON line per fit:
the epoch-0 losses, the mean of each loss over the last 50 epochs, and
its mean over each 100 epochs. Runs on the CPU (a few minutes per strict
fit).
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from cvaegan_tpu import CVAEGAN  # noqa: E402
from cvaegan_tpu.core import config  # noqa: E402
from cvaegan_tpu.data.tabular import TabularDataset, minmax_scale  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--modes", nargs="+", default=["strict", "balanced"])
    args = p.parse_args()
    ds = chip_smoke.standin_dataset(TabularDataset, minmax_scale)
    for mode in args.modes:
        for seed in range(args.seeds):
            settings = config.Settings()
            settings.gan.epochs = chip_smoke.GAN_EPOCHS
            model = CVAEGAN(seed=seed, settings=settings, balanced_mode=mode == "balanced")
            model.verbose = False
            t0 = time.perf_counter()
            model.fit(ds)
            hist = {k: np.asarray(v) for k, v in model.loss_history.items()}
            print(json.dumps({
                "mode": mode, "seed": seed, "epochs": chip_smoke.GAN_EPOCHS,
                "cpu_seconds": time.perf_counter() - t0,
                "epoch0": {k: float(v[0]) for k, v in hist.items()},
                "last50_mean": {k: float(v[-50:].mean()) for k, v in hist.items()},
                "mean_by_100_epochs": {k: [float(v[i:i + 100].mean())
                                           for i in range(0, len(v), 100)]
                                       for k, v in hist.items()}}), flush=True)


if __name__ == "__main__":
    main()
