"""Multi-seed study of the PyTorch port, held against the JAX package's rows.

Runs the port's balance pipeline (`cvaegan_tpu_torch.pipelines.balance.
run_balance_pipeline`, `plot=False`) on the committed per-seed fixtures
`experiments/fixtures/imb_s{seed}.npz`, as `experiments/ours_multiseed.py`
ran the JAX package on them: seeds below `--serial-below` (10) are fitted
one by one, the others by one `SeedBank` per (model, mode), one fixture per
replica, and each banked replica then goes through the same pipeline
(generation, downstream classifier, tests). One JSON line per run is
appended to `--out`, with the JAX rows' keys plus `framework`
("cvaegan_tpu_torch"), `compute_dtype` and the card's name and power
limit. A bf16 arm (`--dtype bfloat16`) is tagged `<mode>+bf16`, and an arm
with a fresh downstream classifier (`--no-warm-start`) `<mode>+fresh_clf`,
as the JAX rows are (`experiments/ours_multiseed.py`). `needed` comes from each fixture's train labels. Rows already in
`--out` without an error are skipped, so an arm can be resumed.

On the card (imports no JAX; the pipeline's fits replay CUDA graphs):

    python experiments/torch_port_multiseed.py --modes strict balanced
    python experiments/torch_port_multiseed.py --modes balanced --dtype bfloat16
    python experiments/torch_port_multiseed.py --models sngan --modes strict --no-warm-start

`--compare` reads this file and the JAX rows
(`experiments/results/ours_multiseed.jsonl`) and prints, per (model, mode)
arm, the medians of both and a two-sample Mann-Whitney U p-value
(`scipy.stats.mannwhitneyu`, two-sided) on the yield and on macro-F1; an
arm the JAX rows lack (a `+bf16` mode the JAX study did not run) is held
to the JAX rows of its mode without the tag (`jax_mode`). It needs no
card:

    python experiments/torch_port_multiseed.py --compare
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
HERE = REPO / "experiments"
if str(REPO) not in sys.path:  # run as `python experiments/<this>.py`
    sys.path.insert(0, str(REPO))

# model name -> (class name, takes balanced_mode, generation mode), as in
# `experiments/ours_multiseed.py:37-49`
MODELS = {
    "cvae_gan": ("CVAEGAN", True, "qualified"),
    "cgan": ("CGAN", True, "qualified"),
    "gan": ("GAN", False, "qualified"),
    "cvae": ("CVAE", True, "qualified"),
    "sngan": ("SNGAN", True, "qualified"),
    "ctgan": ("CTGAN", True, "qualified"),
    "qg_smote": ("QG_SMOTE", True, "qualified"),
    "rain_gan": ("RAIN_GAN", True, "qualified"),
    "tmg_gan": ("TMGGAN", False, "tmg"),
    "vae_gan": ("VAEGAN", False, "unconditional"),
    "vae": ("VAE", False, "qualified"),
}
DTYPE_TAGS = {"float32": "", "bfloat16": "+bf16"}
FRAMEWORK = "cvaegan_tpu_torch"


def tagged_mode(mode: str, fresh_clf: bool = False, dtype: str = "float32") -> str:
    """The arm's mode as the JAX study tags it: `strict+fresh_clf+bf16` etc."""
    return mode + ("+fresh_clf" if fresh_clf else "") + DTYPE_TAGS[dtype]


def card_name() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def load_fixture(path):
    from cvaegan_tpu_torch.data.tabular import TabularDataset

    d = np.load(path)
    return TabularDataset(d["tr_x"], d["tr_y"].astype(np.int32),
                          d["te_x"], d["te_y"].astype(np.int32),
                          name=pathlib.Path(path).stem)


def needed_rows(labels: np.ndarray, gen_mode: str) -> int:
    """Rows the pipeline asks for: every class topped up to the largest
    class (the unconditional scheme adds the train set once)."""
    counts = np.bincount(labels)
    if gen_mode == "unconditional":
        return int(counts.sum())
    return int(counts.max() * len(counts) - counts.sum())


def per_class(labels: np.ndarray, augmented_labels: np.ndarray, gen_mode: str) -> dict:
    """Rows needed and rows generated for each class, as lists indexed by
    class id (the unconditional scheme asks for no class in particular, so
    its needed rows are the train set's class counts)."""
    counts = np.bincount(labels)
    after = np.bincount(augmented_labels, minlength=len(counts))
    needed = counts if gen_mode == "unconditional" else counts.max() - counts
    return {"needed_per_class": [int(n) for n in needed],
            "generated_per_class": [int(n) for n in after[:len(counts)] - counts]}


def run_one(model_name: str, seed: int, fixture, balanced: bool, mode_tag: str,
            card: str, device: str, out_dir: str, model=None,
            warm_start: bool = True) -> dict:
    import cvaegan_tpu_torch
    from cvaegan_tpu_torch.core import config as config_lib
    from cvaegan_tpu_torch.pipelines.balance import run_balance_pipeline

    cls_name, _, gen_mode = MODELS[model_name]
    ds = load_fixture(fixture)
    t0 = time.time()
    r = run_balance_pipeline(getattr(cvaegan_tpu_torch, cls_name), cls_name, ds,
                             out_dir=out_dir,
                             plot=False, seed=seed, generation_mode=gen_mode,
                             balanced_mode=balanced, warm_start=warm_start,
                             model=model, device=device)
    n_train = len(ds.tr_labels)
    return {
        "framework": FRAMEWORK,
        "model": model_name,
        "seed": seed,
        "mode": mode_tag,
        "macro_f1": r["multiclass_metrics"]["F1"],
        "multiclass": {k: float(v) for k, v in r["multiclass_metrics"].items()},
        "binary_f1": r["binary_metrics"]["F1"],
        "generated": int(len(r["augmented"].tr_samples) - n_train),
        "needed": needed_rows(ds.tr_labels, gen_mode),
        **per_class(ds.tr_labels, r["augmented"].tr_labels, gen_mode),
        "total_seconds": round(time.time() - t0, 1),
        "compute_dtype": config_lib.settings.gan.compute_dtype,
        "gan_epochs": config_lib.settings.gan.epochs,
        "clf_epochs": config_lib.settings.classifier.epochs,
        "card": card,
    }


def append(out: pathlib.Path, rec: dict) -> None:
    with open(out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec), flush=True)


def failed(model_name, seed, mode_tag, card, e) -> dict:
    traceback.print_exc()
    return {"framework": FRAMEWORK, "model": model_name, "seed": seed,
            "mode": mode_tag, "card": card, "error": f"{type(e).__name__}: {e}"}


def run_arm(model_name: str, balanced: bool, mode_tag: str, seeds, serial_below: int,
            fixtures: pathlib.Path, out: pathlib.Path, done: set, card: str,
            device: str, out_dir: str, warm_start: bool = True) -> None:
    import cvaegan_tpu_torch
    from cvaegan_tpu_torch.algorithms.seed_bank import SeedBank

    todo = [s for s in seeds if (model_name, s, mode_tag) not in done]
    for s in [s for s in todo if s < serial_below]:
        print(f"=== {model_name} seed {s} {mode_tag} (serial) ===", flush=True)
        try:
            rec = run_one(model_name, s, fixtures / f"imb_s{s}.npz", balanced,
                          mode_tag, card, device, out_dir, warm_start=warm_start)
            rec["fit_mode"] = "serial"
        except Exception as e:  # recorded, and retried by a later run
            rec = failed(model_name, s, mode_tag, card, e)
        append(out, rec)
    banked = [s for s in todo if s >= serial_below]
    if not banked:
        return
    paths = [fixtures / f"imb_s{s}.npz" for s in banked]
    # the pipeline trains on dataset.renormalized(): the bank fits exactly that
    bank = SeedBank(getattr(cvaegan_tpu_torch, MODELS[model_name][0]), seeds=banked,
                    balanced_mode=balanced, device=device)
    for t in bank.trainers:
        t.verbose = False
    print(f"=== bank fit {model_name} {mode_tag} x{len(banked)} seeds ===", flush=True)
    trainers = bank.fit([load_fixture(p).renormalized() for p in paths])
    print(f"bank fit: {bank.fit_seconds:.1f} s, {bank.steps_per_sec:.0f} aggregate "
          "steps/s", flush=True)
    for s, path, trainer in zip(banked, paths, trainers):
        try:
            rec = run_one(model_name, s, path, balanced, mode_tag, card, device,
                          out_dir, model=trainer, warm_start=warm_start)
            rec.update(fit_mode="bank", bank_fit_seconds=round(bank.fit_seconds, 2),
                       bank_steps_per_sec=round(bank.steps_per_sec))
        except Exception as e:
            rec = failed(model_name, s, mode_tag, card, e)
        append(out, rec)


def read_rows(path: pathlib.Path, framework: str):
    rows = []
    for line in path.read_text().splitlines():
        r = json.loads(line)
        if r.get("framework") == framework and "error" not in r:
            rows.append(r)
    return rows


def paired_arms(port: list, ref: list):
    """(model, mode, jax_mode, port rows, JAX rows) per (model, mode) arm of
    the port's rows: the JAX rows of the same mode, or of the mode without
    its `+bf16` tag where the JAX rows lack the tagged one."""
    for model, mode in sorted({(r["model"], r["mode"]) for r in port}):
        a = [r for r in port if (r["model"], r["mode"]) == (model, mode)]
        jax_mode = mode
        if not any((r["model"], r["mode"]) == (model, mode) for r in ref):
            jax_mode = mode.removesuffix(DTYPE_TAGS["bfloat16"])
        yield model, mode, jax_mode, a, [r for r in ref
                                         if (r["model"], r["mode"]) == (model, jax_mode)]


def compare(port_path: pathlib.Path, jax_path: pathlib.Path) -> list:
    """Per (model, mode) arm present in both files: the seeds, medians of
    yield (generated / needed) and of macro-F1 on both sides, and two-sided
    Mann-Whitney U p-values. Prints one JSON line per arm."""
    from scipy.stats import mannwhitneyu

    report = []
    for model, mode, jax_mode, a, b in paired_arms(read_rows(port_path, FRAMEWORK),
                                                   read_rows(jax_path, "cvaegan_tpu")):
        line = {"model": model, "mode": mode, "jax_mode": jax_mode, "port_seeds": len(a),
                "jax_seeds": len(b)}
        for key, get in (("yield", lambda r: r["generated"] / r["needed"]),
                         ("generated", lambda r: r["generated"]),
                         ("macro_f1", lambda r: r["macro_f1"]),
                         ("binary_f1", lambda r: r["binary_f1"])):
            xa, xb = [get(r) for r in a], [get(r) for r in b]
            line[key] = {"port_median": float(np.median(xa)),
                         "jax_median": float(np.median(xb)) if xb else None}
            if key in ("yield", "macro_f1") and xb:
                line[key]["mannwhitney_p"] = float(
                    mannwhitneyu(xa, xb, alternative="two-sided").pvalue)
        report.append(line)
        print(json.dumps(line), flush=True)
    return report


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--models", nargs="+", default=["cvae_gan"], choices=list(MODELS))
    p.add_argument("--modes", nargs="+", default=["strict", "balanced"],
                   choices=["strict", "balanced"])
    p.add_argument("--seeds", type=int, nargs="+", default=list(range(30)))
    p.add_argument("--serial-below", type=int, default=10,
                   help="seeds below this are fitted one by one, the rest banked")
    p.add_argument("--dtype", default="float32", choices=list(DTYPE_TAGS),
                   help="compute policy of the GAN fits; the downstream "
                        "classifier stays float32")
    p.add_argument("--no-warm-start", action="store_true",
                   help="train a fresh downstream classifier instead of warm-starting "
                        "it from the GAN's companion; tags the mode +fresh_clf")
    p.add_argument("--fixtures", default=str(HERE / "fixtures"))
    p.add_argument("--out", default=str(HERE / "results" / "torch_port_multiseed.jsonl"))
    p.add_argument("--jax", default=str(HERE / "results" / "ours_multiseed.jsonl"),
                   help="the JAX package's rows, for --compare")
    p.add_argument("--device", default="cuda")
    p.add_argument("--epochs", type=int, default=None,
                   help="GAN epochs (default: the settings', 500); cut only to rehearse")
    p.add_argument("--clf-epochs", type=int, default=None,
                   help="classifier epochs (default: the settings', 100)")
    p.add_argument("--compare", action="store_true",
                   help="compare the rows of --out with those of --jax and exit")
    args = p.parse_args()
    out = pathlib.Path(args.out)
    if args.compare:
        compare(out, pathlib.Path(args.jax))
        return 0

    import torch

    from cvaegan_tpu_torch.core import config as config_lib

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("torch_port_multiseed: CUDA is not available", file=sys.stderr)
        return 1
    card = card_name() if args.device.startswith("cuda") else "cpu"
    config_lib.settings.gan.compute_dtype = args.dtype
    if args.epochs is not None:
        config_lib.settings.gan.epochs = args.epochs
    if args.clf_epochs is not None:
        config_lib.settings.classifier.epochs = args.clf_epochs
    out.parent.mkdir(parents=True, exist_ok=True)
    done = set()
    if out.exists():  # resume; errored runs are retried
        for r in read_rows(out, FRAMEWORK):
            done.add((r["model"], r["seed"], r["mode"]))
    with tempfile.TemporaryDirectory() as out_dir:  # the pipeline's pickles
        for model_name in args.models:
            for mode in args.modes:
                balanced = mode == "balanced"
                if balanced and not MODELS[model_name][1]:
                    continue
                run_arm(model_name, balanced,
                        tagged_mode(mode, args.no_warm_start, args.dtype), args.seeds,
                        args.serial_below, pathlib.Path(args.fixtures), out, done, card,
                        args.device, out_dir, warm_start=not args.no_warm_start)
    return 0


if __name__ == "__main__":
    sys.exit(main())
