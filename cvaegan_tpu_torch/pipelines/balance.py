"""The class-rebalancing pipeline, the counterpart of
`cvaegan_tpu/pipelines/balance.py` (reference `scripts/train_cvae_gan.py`,
one template across the reference's train scripts):
  1) seed; 2) concat train+test, minmax-scale, re-split; 3) construct the
  model, fit; 4) plot losses; 5) per class generate `max_count - count`
  qualified samples, largest need first, and append them to the train
  split; 6) pickle the augmented arrays to `data_<model>.pkl`; 7) reuse
  the model's companion classifier as the downstream model and re-fit it
  on the augmented data; 8) multiclass `test` + `binary_test` + ROC jpgs;
  9) wall-clock report; 10) per-class generated-sample mean/std stats.

Run the CVAE-GAN pipeline with

    python -m cvaegan_tpu_torch.pipelines.balance --dataset blobs --epochs 500

(`--device cpu` on a machine without a card). The flags are the JAX
CLI's (`scripts/train_cvae_gan.py`) plus `--device`; `--streamed` (the
out-of-core pipeline) is ROADMAP item A18 and raises. Plots need
matplotlib and sklearn, the `blobs` and `imbalanced` fixtures sklearn.
"""

from __future__ import annotations

import pickle
import time
from pathlib import Path
from typing import Optional

import numpy as np

from cvaegan_tpu_torch.core import config as config_lib
from cvaegan_tpu_torch.data.tabular import TabularDataset
from cvaegan_tpu_torch.eval.classifier import Classifier


def load_dataset(name: str, seed: int = 0) -> TabularDataset:
    """Resolve a dataset spec: 'blobs', 'imbalanced', a named dataset
    directory under data/datasets, or an explicit path."""
    if name == "blobs":
        return TabularDataset.synthetic_blobs(seed=seed)
    if name == "imbalanced":
        return TabularDataset.imbalanced_classification(seed=seed)
    p = Path(name)
    if not p.exists():
        p = config_lib.settings.paths.datasets / name
    if not (p / "x_train.csv").exists():
        raise FileNotFoundError(
            f"dataset {name!r}: {p}/x_train.csv not found. Prepare it with "
            "`python scripts/prepare_can_dataset.py --classes "
            "normal=<raw.csv> ...` (or use --dataset blobs / imbalanced)"
        )
    return TabularDataset.from_csv_dir(p)


def run_balance_pipeline(
    algorithm_cls,
    display_name: str,
    dataset: TabularDataset,
    out_dir: Optional[Path] = None,
    generation_mode: str = "qualified",
    settings: Optional[config_lib.Settings] = None,
    seed: Optional[int] = None,
    plot: bool = True,
    confidence_threshold: Optional[float] = None,
    balanced_mode: bool = False,
    warm_start: bool = True,
    model=None,
    ema_filter: bool = False,
    device="cuda",
):
    """Run the full pipeline on `device`; returns a result dict with the
    trained model, classifier, metrics, the pickle's path, the generation
    stats and the wall seconds (keys as in the JAX package).

    `model`: a trainer already fitted on `dataset.renormalized()`; the
    pipeline then skips construction and `fit`."""
    settings = settings or config_lib.settings
    seed = settings.seed if seed is None else seed
    out_dir = Path(out_dir) if out_dir else Path.cwd()
    out_dir.mkdir(parents=True, exist_ok=True)
    t_start = time.time()

    ds = dataset.renormalized()
    label_num = ds.label_num
    print(f"train set: {ds.tr_samples.shape}, classes: {label_num}, "
          f"counts: {ds.class_counts().tolist()}")

    if model is None:
        model = algorithm_cls(seed=seed, settings=settings, device=device,
                              balanced_mode=balanced_mode, ema_filter=ema_filter)
        print(f"training {display_name} ...")
        model.fit(ds)
    if plot:
        model.plot_loss_history()

    # ---- class-rebalancing generation -------------------------------
    counts = ds.class_counts()
    aug = ds
    if generation_mode == "unconditional":
        num = len(ds.tr_samples)
        generated = model.generate_samples(num)
        rng = np.random.default_rng(seed)
        labels = rng.integers(0, label_num, size=len(generated))
        aug = aug.append(generated, labels)
        print(f"generated {len(generated)} unconditional samples (random labels)")
    else:
        max_count = int(counts.max())
        needs = {c: max_count - int(counts[c]) for c in range(label_num)}
        for c in sorted(needs, key=needs.get, reverse=True):
            need = needs[c]
            if need <= 0:
                continue
            if generation_mode == "tmg":
                generated = model.generate_qualified_samples(c, need)
            else:
                generated = model.generate_qualified_samples(
                    c, need, confidence_threshold=confidence_threshold)
            if len(generated):
                aug = aug.append(generated, np.full(len(generated), c, np.int32))
            print(f"class {c}: needed {need}, generated {len(generated)}")

    print(f"augmented train set: {aug.tr_samples.shape}, "
          f"counts: {aug.class_counts().tolist()}")

    # ---- artifact: pickled augmented arrays -------------------------
    pkl_path = out_dir / f"data_{display_name.lower()}.pkl"
    with open(pkl_path, "wb") as f:
        pickle.dump((aug.tr_samples, aug.tr_labels, aug.te_samples, aug.te_labels), f)
    print(f"augmented dataset pickled to {pkl_path}")

    # ---- downstream classifier --------------------------------------
    clf = Classifier(display_name, seed=seed, settings=settings, device=device)
    if warm_start and model.state is not None and "classifier" in model.state:
        clf.warm_start_from(model)
    clf.fit(aug)

    clf.test(aug)
    print(clf.confusion_matrix)
    clf.print_metrics(4)
    multiclass_metrics = dict(clf.metrics)
    if plot:
        clf.plot_roc_curve(aug, is_binary=False)

    print("binary test ...")
    clf.binary_test(aug)
    print(clf.confusion_matrix)
    clf.print_metrics(4)
    binary_metrics = dict(clf.metrics)
    if plot:
        clf.plot_roc_curve(aug, is_binary=True)

    total = time.time() - t_start
    hours, rem = divmod(total, 3600)
    minutes, seconds = divmod(rem, 60)
    print(f"\ntotal time: {int(hours)}h {int(minutes)}m {seconds:.2f}s")

    # ---- per-class generated-sample statistics ----------------------
    gen_stats = {}
    if generation_mode != "unconditional":
        for c in range(label_num):
            if getattr(model, "conditional_sampling", True):
                g = model.generate_samples(c, 5)
            else:
                g = model.generate_samples(5)
            if len(g):
                gen_stats[c] = (float(np.mean(g)), float(np.std(g)))
                print(f"class {c} generated stats - mean: {gen_stats[c][0]:.6f}, "
                      f"std: {gen_stats[c][1]:.6f}")

    return {
        "model": model,
        "classifier": clf,
        "augmented": aug,
        "multiclass_metrics": multiclass_metrics,
        "binary_metrics": binary_metrics,
        "pickle_path": pkl_path,
        "gen_stats": gen_stats,
        "seconds": total,
    }


def make_cli(description: str):
    """The JAX train scripts' argparse CLI, plus `--device`."""
    import argparse

    p = argparse.ArgumentParser(description=description)
    p.add_argument("--dataset", default="blobs",
                   help="blobs | imbalanced | CAN_HCRL_OTIDS | path to a "
                        "csv dir with x/y_{train,test}.csv")
    p.add_argument("--epochs", type=int, default=None,
                   help="override GAN epochs (default 500)")
    p.add_argument("--clf-epochs", type=int, default=None,
                   help="override classifier epochs (default 100)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--test-mode", action="store_true",
                   help="1-epoch smoke mode (reference turn_on_test_mode)")
    p.add_argument("--confidence-threshold", type=float, default=None,
                   help="qualified-sample filter threshold (default: the "
                        "model config's value, 0.5)")
    p.add_argument("--balanced-mode", action="store_true",
                   help="class-balanced mixed training rounds")
    p.add_argument("--no-warm-start", action="store_true",
                   help="train a fresh downstream classifier instead of "
                        "warm-starting from the GAN's companion")
    p.add_argument("--ema-filter", action="store_true",
                   help="filter qualified samples with an EMA of the "
                        "companion classifier")
    p.add_argument("--streamed", action="store_true",
                   help="out-of-core pipeline: not ported yet (ROADMAP A18)")
    p.add_argument("--window-rows", type=int, default=1_000_000,
                   help="rows per streamed device window")
    p.add_argument("--epochs-per-window", type=int, default=125,
                   help="trainer epochs per streamed window")
    p.add_argument("--clf-epochs-per-window", type=int, default=25,
                   help="downstream classifier epochs per streamed window")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu on a "
                        "machine without a card)")
    return p


def apply_cli_settings(args) -> None:
    """Apply CLI overrides to the global settings (no dataset load)."""
    settings = config_lib.settings
    settings.seed = args.seed
    if args.test_mode:
        config_lib.turn_on_test_mode()
    if args.epochs is not None:
        settings.gan.epochs = args.epochs
    if args.clf_epochs is not None:
        settings.classifier.epochs = args.clf_epochs


def apply_cli(args) -> TabularDataset:
    """Apply CLI overrides to the global settings and load the dataset."""
    apply_cli_settings(args)
    return load_dataset(args.dataset, seed=args.seed)


def run_from_cli(algorithm_cls, display_name: str, args,
                 generation_mode: str = "qualified"):
    """Run the balance pipeline for a parsed CLI."""
    if args.streamed:
        raise NotImplementedError(
            "--streamed: the out-of-core pipeline is not ported yet (ROADMAP A18)")
    dataset = apply_cli(args)
    return run_balance_pipeline(
        algorithm_cls, display_name, dataset,
        out_dir=args.out_dir,
        confidence_threshold=args.confidence_threshold,
        balanced_mode=args.balanced_mode,
        warm_start=not args.no_warm_start,
        generation_mode=generation_mode,
        ema_filter=args.ema_filter,
        device=args.device,
    )


def main(argv=None):
    """The CVAE-GAN pipeline, as `scripts/train_cvae_gan.py` runs it."""
    from cvaegan_tpu_torch import CVAEGAN

    args = make_cli("Train CVAE_GAN and rebalance minority classes "
                    "(PyTorch port)").parse_args(argv)
    return run_from_cli(CVAEGAN, "CVAE_GAN", args, generation_mode="qualified")


if __name__ == "__main__":
    main()
