"""One arm of the 30-seed study fitted by the JAX package on a CPU.

The JAX package's committed study rows (`experiments/results/
ours_multiseed.jsonl`) are TPU fits, and on a TPU a float32 matmul at
JAX's default precision runs in bf16 passes (ROADMAP C4). Where an arm of
the port's study differs from those rows (`experiments/
torch_port_multiseed.py --compare`), this script fits the same arm with
the JAX package on the CPU, as the JAX study ran it (seeds below
`--serial-below` one by one, the others in one `SeedBank`, then the
balance pipeline per seed), so that the difference can be put on the port
or on the platform. One JSON line per seed is appended to `--out`, with
the JAX rows' keys and `platform` "cpu"; rows already there are skipped.

    JAX_PLATFORMS=cpu python experiments/torch_port_jax_cpu_arm.py --model vae --mode strict

`--summarize` prints, per arm of `--out`, the medians of yield (generated
/ needed) and of macro-F1 of the JAX package's CPU fits, the port's card
fits (`experiments/results/torch_port_multiseed.jsonl`) and the JAX
package's TPU rows, with two-sided Mann-Whitney U p-values of each pair,
and, where rows carry them (`needed_per_class`, `generated_per_class`),
each class's median yield and the share of seeds in which it fills.
`--port-serial <file>` adds the port's rows of an arm refitted one seed at
a time, held to the port's banked rows of the same seeds (paired), and
`--jax-serial <file>` the JAX package's CPU rows of such a refit
(`--serial-below 30 --out <file>`), held to its banked CPU rows:

    python experiments/torch_port_jax_cpu_arm.py --summarize \
        --port-serial experiments/results/torch_port_serial_multiseed.jsonl \
        --jax-serial experiments/results/torch_port_jax_cpu_serial_multiseed.jsonl
"""

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = pathlib.Path(__file__).resolve().parent.parent
HERE = REPO / "experiments"
RESULTS = HERE / "results"
for path in (REPO, HERE):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

import numpy as np  # noqa: E402

import torch_port_multiseed as study  # noqa: E402


def load_fixture(path):
    from cvaegan_tpu.data.tabular import TabularDataset

    d = np.load(path)
    return TabularDataset(d["tr_x"], d["tr_y"].astype(np.int32), d["te_x"],
                          d["te_y"].astype(np.int32), name=pathlib.Path(path).stem)


def run_one(model_name, seed, fixture, balanced, fresh_clf, mode, out_dir, model=None):
    import cvaegan_tpu
    from cvaegan_tpu.core import config as config_lib
    from cvaegan_tpu.pipelines.balance import run_balance_pipeline

    cls_name, _, gen_mode = study.MODELS[model_name]
    ds = load_fixture(fixture)
    t0 = time.time()
    r = run_balance_pipeline(getattr(cvaegan_tpu, cls_name), cls_name, ds, out_dir=out_dir,
                             plot=False, seed=seed, generation_mode=gen_mode,
                             balanced_mode=balanced, warm_start=not fresh_clf, model=model)
    return {"framework": "cvaegan_tpu", "platform": "cpu", "model": model_name,
            "seed": seed, "mode": mode, "macro_f1": r["multiclass_metrics"]["F1"],
            "multiclass": {k: float(v) for k, v in r["multiclass_metrics"].items()},
            "binary_f1": r["binary_metrics"]["F1"],
            "generated": int(len(r["augmented"].tr_samples) - len(ds.tr_labels)),
            "needed": study.needed_rows(ds.tr_labels, gen_mode),
            **study.per_class(ds.tr_labels, r["augmented"].tr_labels, gen_mode),
            "total_seconds": round(time.time() - t0, 1),
            "gan_epochs": config_lib.settings.gan.epochs,
            "clf_epochs": config_lib.settings.classifier.epochs}


def run_arm(model_name, mode, seeds, serial_below, out: pathlib.Path, out_dir) -> None:
    import cvaegan_tpu

    base = mode.split("+")[0]
    balanced, fresh_clf = base == "balanced", "+fresh_clf" in mode
    done = {(r["model"], r["seed"], r["mode"]) for r in read(out)}
    todo = [s for s in seeds if (model_name, s, mode) not in done]
    fixture = [HERE / "fixtures" / f"imb_s{s}.npz" for s in todo]

    def append(rec):
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)

    for s, path in zip(todo, fixture):
        if s < serial_below:
            append(run_one(model_name, s, path, balanced, fresh_clf, mode, out_dir)
                   | {"fit_mode": "serial"})
    banked = [(s, p) for s, p in zip(todo, fixture) if s >= serial_below]
    if not banked:
        return
    bank = cvaegan_tpu.SeedBank(getattr(cvaegan_tpu, study.MODELS[model_name][0]),
                                seeds=[s for s, _ in banked], balanced_mode=balanced)
    for t in bank.trainers:
        t.verbose = False
    trainers = bank.fit([load_fixture(p).renormalized() for _, p in banked])
    for (s, path), trainer in zip(banked, trainers):
        append(run_one(model_name, s, path, balanced, fresh_clf, mode, out_dir,
                       model=trainer) | {"fit_mode": "bank"})


def read(path: pathlib.Path, framework=None):
    if not path.exists():
        return []
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return [r for r in rows if "error" not in r and r.get("threshold") is None
            and (framework is None or r.get("framework") == framework)]


def per_class(rows) -> dict:
    """Over the rows that carry per-class counts: each class's median yield
    (generated / needed, of the classes that need rows) and the share of
    seeds in which it fills (generated >= 90% of needed)."""
    rows = [r for r in rows if "needed_per_class" in r]
    if not rows:
        return {}
    need = np.array([r["needed_per_class"] for r in rows], float)
    got = np.array([r["generated_per_class"] for r in rows], float)
    cls = np.nonzero(need.min(0) > 0)[0]
    y = got[:, cls] / need[:, cls]
    return {"seeds": len(rows), "classes": cls.tolist(),
            "median_yield": np.median(y, 0).round(4).tolist(),
            "fills": (y >= 0.9).mean(0).round(4).tolist(),
            "classes_filled_per_seed": np.bincount((y >= 0.9).sum(1),
                                                   minlength=len(cls) + 1).tolist()}


def summarize(out: pathlib.Path, port_serial=None, jax_serial=None) -> list:
    """Per arm of `out`: medians and p-values of the three sides (see the
    module docstring) and each side's per-class counts where its rows
    carry them. With `port_serial` (`jax_serial`), the port's (the JAX
    package's CPU) rows of an arm fitted serially (`--serial-below 30`) are
    held to the same package's banked rows of the same seeds (Wilcoxon
    signed-rank, paired by seed) and to the other sides (Mann-Whitney)."""
    from scipy.stats import mannwhitneyu, wilcoxon

    sides = {"jax_cpu": read(out),
             "port": read(RESULTS / "torch_port_multiseed.jsonl", study.FRAMEWORK),
             "jax_tpu": read(RESULTS / "ours_multiseed.jsonl", "cvaegan_tpu")}
    #: serial refits: (side, rows, the side whose banked rows they pair with)
    refits = [(side, read(pathlib.Path(path), framework), banked)
              for side, path, framework, banked in (
                  ("port_serial", port_serial, study.FRAMEWORK, "port"),
                  ("jax_cpu_serial", jax_serial, "cvaegan_tpu", "jax_cpu")) if path]
    report = []
    for model, mode in sorted({(r["model"], r["mode"]) for r in sides["jax_cpu"]}):
        line = {"model": model, "mode": mode}
        arm = {k: [r for r in rows if (r["model"], r["mode"]) == (model, mode)]
               for k, rows in sides.items()}
        paired = {}
        for side, rows, banked in refits:
            own = [r for r in rows if (r["model"], r["mode"]) == (model, mode)]
            if own:
                arm[side], paired[side] = own, banked
        line["seeds"] = {k: len(v) for k, v in arm.items()}
        for key, get in (("yield", lambda r: r["generated"] / r["needed"]),
                         ("macro_f1", lambda r: r["macro_f1"])):
            vals = {k: [get(r) for r in v] for k, v in arm.items()}
            line[key] = {f"{k}_median": float(np.median(v)) for k, v in vals.items()}
            pairs = [("jax_cpu", "port"), ("jax_cpu", "jax_tpu"), ("port", "jax_tpu")]
            pairs += [(side, other) for side in paired
                      for other in ("jax_cpu", "jax_tpu", "port_serial") if other != side]
            for a, b in pairs:
                if a in vals and b in vals:
                    line[key][f"p_{a}_{b}"] = float(mannwhitneyu(
                        vals[a], vals[b], alternative="two-sided").pvalue)
            for side, banked_side in paired.items():
                banked = {r["seed"]: get(r) for r in arm[banked_side]
                          if r.get("fit_mode") == "bank"}
                own = [r for r in arm[side] if r["seed"] in banked]
                a = np.array([get(r) for r in own])
                b = np.array([banked[r["seed"]] for r in own])
                line[key][f"{banked_side}_banked_same_seeds_median"] = float(np.median(b))
                line[key][f"{side}_same_seeds_median"] = float(np.median(a))
                line[key][f"p_{side}_{banked_side}_banked_paired"] = (
                    float(wilcoxon(a, b).pvalue) if (a != b).any() else 1.0)
        line["per_class"] = {k: c for k, v in arm.items() if (c := per_class(v))}
        report.append(line)
        print(json.dumps(line), flush=True)
    return report


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=list(study.MODELS))
    p.add_argument("--mode", default="strict",
                   help="strict, balanced, or either with +fresh_clf")
    p.add_argument("--seeds", type=int, nargs="+", default=list(range(30)))
    p.add_argument("--serial-below", type=int, default=10)
    p.add_argument("--out", default=str(RESULTS / "torch_port_jax_cpu_multiseed.jsonl"))
    p.add_argument("--epochs", type=int, default=None,
                   help="GAN epochs (default: the settings', 500); cut only to rehearse")
    p.add_argument("--clf-epochs", type=int, default=None)
    p.add_argument("--summarize", action="store_true")
    p.add_argument("--port-serial", default=None,
                   help="with --summarize: the port's rows of an arm fitted serially, held "
                        "to its banked rows of the same seeds")
    p.add_argument("--jax-serial", default=None,
                   help="with --summarize: the JAX package's CPU rows of an arm fitted "
                        "serially, held to its banked CPU rows of the same seeds")
    args = p.parse_args()
    out = pathlib.Path(args.out)
    if args.summarize:
        summarize(out, args.port_serial, args.jax_serial)
        return 0
    import jax

    jax.config.update("jax_platforms", "cpu")
    from cvaegan_tpu.core import config as config_lib

    if args.epochs is not None:
        config_lib.settings.gan.epochs = args.epochs
    if args.clf_epochs is not None:
        config_lib.settings.classifier.epochs = args.clf_epochs
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as out_dir:  # the pipeline's pickles
        run_arm(args.model, args.mode, args.seeds, args.serial_below, out, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
