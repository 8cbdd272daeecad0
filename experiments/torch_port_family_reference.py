#!/usr/bin/env python
"""The JAX package's RAIN-GAN, SNGAN, CTGAN, QG-SMOTE and TMG-GAN loss
curves on the blob stand-in that `chip_smoke.py` trains the PyTorch port's
on, as the reference scale for the port's `family` phase.

    JAX_PLATFORMS=cpu python experiments/torch_port_family_reference.py --seeds 3

Fits each trainer for `chip_smoke.FAMILY_EPOCHS` epochs in strict mode per
seed on `chip_smoke.standin_dataset` and prints one JSON line per fit: the
companion classifier's eval-mode cross entropy on the train set as built
(before any step; null for TMG-GAN, which has no companion), the epoch-0
losses and the mean of each loss over the last 10 epochs, the figures
`chip_smoke.py`'s `family` lines report. TMG-GAN's chunk-end scatters go
to a temporary directory. Runs on the CPU (one to two minutes per fit).
"""

import argparse
import json
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
import cvaegan_tpu  # noqa: E402
from cvaegan_tpu.core import config, losses  # noqa: E402
from cvaegan_tpu.data.tabular import TabularDataset, minmax_scale  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--trainers", nargs="+", default=list(chip_smoke.FAMILY_PIPELINES))
    args = p.parse_args()
    ds = chip_smoke.standin_dataset(TabularDataset, minmax_scale)
    outs = tempfile.TemporaryDirectory()
    for name in args.trainers:
        for seed in range(args.seeds):
            settings = config.Settings()
            settings.gan.epochs = chip_smoke.FAMILY_EPOCHS
            settings.paths = config.Paths(root=pathlib.Path(outs.name))
            model = getattr(cvaegan_tpu, name)(seed=seed, settings=settings)
            model.verbose = False
            model._prepare(ds)
            init_ce = None
            if "classifier" in model.state:
                logits = model._classifier_logits(model.state, ds.tr_samples)
                init_ce = float(losses.cross_entropy(logits, ds.tr_labels))
            t0 = time.perf_counter()
            model.fit(ds)
            hist = {k: np.asarray(v) for k, v in model.loss_history.items()}
            print(json.dumps({
                "trainer": name, "seed": seed, "epochs": chip_smoke.FAMILY_EPOCHS,
                "cpu_seconds": time.perf_counter() - t0,
                "class_loss_at_init_eval_as_built": init_ce,
                "epoch0": {k: float(v[0]) for k, v in hist.items()},
                "last10_mean": {k: float(v[-10:].mean()) for k, v in hist.items()}}),
                flush=True)
    outs.cleanup()


if __name__ == "__main__":
    main()
