"""Strict-mode qualified yield, split into training and generation (ROADMAP C4).

The port's strict CVAE-GAN pipeline yields fewer qualified rows than the
JAX package's committed rows over the 30 fixtures
(`experiments/torch_port_multiseed.py --compare`). The split separates
the two halves: `experiments/torch_port_strict_yield_jax.py` fits the JAX
package's strict CVAE-GAN for each fixture seed on the CPU, generates each
class's need from it and dumps the trained state; this script carries
each dumped state into the port (`load_jax_state`) and asks the port for
the same needs, in the same order. If the two yields agree on one trained
state, a difference lies in training, not in the generation. It imports
the port alone (the two scripts share files, not imports).

    JAX_PLATFORMS=cpu python experiments/torch_port_strict_yield_jax.py \\
        --seeds 0 1 2 --state-dir <dir>
    python experiments/torch_port_strict_yield_split.py --state-dir <dir>
    python experiments/torch_port_strict_yield_split.py --summarize

Appends one JSON line per seed to `--out`
(`experiments/results/torch_port_strict_yield_split.jsonl`): each class's
need and each package's qualified rows. `--summarize` reads those rows
and prints the median yields (rows / need) of JAX's generation, of the
port's on the JAX states, of the port's study rows of the same seeds
(`experiments/results/torch_port_multiseed.jsonl`, mode `strict`) and of
the JAX package's committed rows (`ours_multiseed.jsonl`, fitted on a
TPU), with two-sided Mann-Whitney U p-values of the JAX CPU fits against
the other two, and of the port's study rows against the committed ones.
Which rows are which fits: `jax_rows` here are the JAX package's fits on
a CPU, the port's study rows fits on an H100, the committed JAX rows
fits on a TPU.
"""

import argparse
import json
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
RESULTS = REPO / "experiments" / "results"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def unflatten(flat) -> dict:
    """{"net/.../leaf": array} as nested dicts."""
    tree = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(value)
    return tree


def port_rows(jax_row: dict, state_dir: pathlib.Path) -> dict:
    from cvaegan_tpu_torch import CVAEGAN
    from cvaegan_tpu_torch.data.tabular import TabularDataset

    seed = jax_row["seed"]
    d = np.load(REPO / "experiments" / "fixtures" / f"imb_s{seed}.npz")
    ds = TabularDataset(d["tr_x"], d["tr_y"].astype(np.int32), d["te_x"],
                        d["te_y"].astype(np.int32)).renormalized()
    port = CVAEGAN(seed=seed, device="cpu")
    port.verbose = False
    port._prepare((ds.tr_samples, ds.tr_labels))
    with np.load(state_dir / f"imb_s{seed}.npz") as flat:
        port.load_jax_state(unflatten(dict(flat)))
    needs = {int(c): n for c, n in jax_row["need"].items()}
    rows = {c: len(port.generate_qualified_samples(c, needs[c])) for c in jax_row["order"]}
    return {**jax_row, "port_rows": rows, "port_total": sum(rows.values())}


def summarize(path: pathlib.Path) -> dict:
    from scipy.stats import mannwhitneyu

    rows = [json.loads(line) for line in path.read_text().splitlines()]

    def study(name, framework):
        out = {}
        for line in (RESULTS / name).read_text().splitlines():
            r = json.loads(line)
            if (r.get("framework"), r.get("model"), r.get("mode")) == (
                    framework, "cvae_gan", "strict") and "error" not in r:
                out[r["seed"]] = r["generated"]
        return out

    here = [r["jax_total"] / r["needed"] for r in rows]
    port_study = study("torch_port_multiseed.jsonl", "cvaegan_tpu_torch")
    jax_study = study("ours_multiseed.jsonl", "cvaegan_tpu")
    # the need from the fixture: the JAX rows of seeds 0-9 carry a stale one
    port = [port_study[r["seed"]] / r["needed"] for r in rows]
    committed = [jax_study[r["seed"]] / r["needed"] for r in rows]
    return {"seeds": [r["seed"] for r in rows], "n": len(rows),
            "jax_fit_here_median": float(np.median(here)),
            "port_on_jax_state_median": float(np.median(
                [r["port_total"] / r["needed"] for r in rows])),
            "largest_row_gap_on_one_state": max(abs(r["jax_total"] - r["port_total"])
                                                for r in rows),
            "port_study_median": float(np.median(port)),
            "jax_committed_median": float(np.median(committed)),
            "p_here_vs_port_study": float(mannwhitneyu(here, port).pvalue),
            "p_here_vs_jax_committed": float(mannwhitneyu(here, committed).pvalue),
            "p_port_study_vs_jax_committed": float(mannwhitneyu(port, committed).pvalue)}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--state-dir", help="the JAX half's --state-dir")
    p.add_argument("--out", default=str(RESULTS / "torch_port_strict_yield_split.jsonl"))
    p.add_argument("--summarize", action="store_true",
                   help="summarise the rows of --out and exit")
    args = p.parse_args()
    out = pathlib.Path(args.out)
    if args.summarize:
        print(json.dumps(summarize(out)))
        return 0
    if args.state_dir is None:
        p.error("--state-dir is needed unless --summarize")
    state_dir = pathlib.Path(args.state_dir)
    for line in (state_dir / "jax_rows.jsonl").read_text().splitlines():
        row = json.dumps(port_rows(json.loads(line), state_dir))
        with open(out, "a") as f:
            f.write(row + "\n")
        print(row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
