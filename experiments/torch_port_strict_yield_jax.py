"""The JAX half of the strict-yield split (ROADMAP C4): fit, generate, dump.

For each fixture seed this fits the JAX package's strict CVAE-GAN on the
CPU (500 epochs, the pipeline's renormalised data), asks it for each
class's need with `generate_qualified_samples` as the pipeline does
(largest need first), and writes the trained state (networks and Adam
state, as the nested trees `load_jax_state` takes) to
`<state-dir>/imb_s<seed>.npz` and one JSON line per seed to `--out`. The
port's half, `experiments/torch_port_strict_yield_split.py`, generates
from the same states; the two scripts share files, not imports.

    JAX_PLATFORMS=cpu python experiments/torch_port_strict_yield_jax.py --seeds 0 1 2 \\
        --state-dir <dir>

Several minutes per seed on a CPU.
"""

import argparse
import json
import os
import pathlib
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def flat_state(state) -> dict:
    """A JAX trainer state as {"net/.../leaf": array}, Adam state included
    under "net/opt_state/{count,mu,nu}/..."."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for key, value in node.items():
                walk(f"{prefix}/{key}", value)
        else:
            out[prefix] = np.asarray(node)

    for name, ns in state.items():
        adam = ns.opt_state[0]
        walk(name, jax.device_get({"params": ns.params, **ns.mutables,
                                   "opt_state": {"count": adam.count, "mu": adam.mu,
                                                 "nu": adam.nu}}))
    return out


def fit_and_dump(seed: int, state_dir: pathlib.Path) -> dict:
    import cvaegan_tpu
    from cvaegan_tpu.data.tabular import TabularDataset

    d = np.load(REPO / "experiments" / "fixtures" / f"imb_s{seed}.npz")
    ds = TabularDataset(d["tr_x"], d["tr_y"].astype(np.int32), d["te_x"],
                        d["te_y"].astype(np.int32)).renormalized()
    t0 = time.time()
    jt = cvaegan_tpu.CVAEGAN(seed=seed)
    jt.verbose = False
    jt.fit(ds)
    fit_seconds = time.time() - t0
    counts = np.bincount(ds.tr_labels)
    needs = {c: int(counts.max() - counts[c]) for c in range(len(counts))}
    order = [c for c in sorted(needs, key=needs.get, reverse=True) if needs[c] > 0]
    rows = {c: len(jt.generate_qualified_samples(c, needs[c])) for c in order}
    np.savez(state_dir / f"imb_s{seed}.npz", **flat_state(jt.state))
    return {"seed": seed, "jax_fit_seconds": round(fit_seconds, 1), "need": needs,
            "order": order, "jax_rows": rows, "jax_total": sum(rows.values()),
            "needed": sum(needs.values())}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--state-dir", required=True)
    p.add_argument("--out", default=None,
                   help="JSON lines (default: <state-dir>/jax_rows.jsonl)")
    args = p.parse_args()
    state_dir = pathlib.Path(args.state_dir)
    state_dir.mkdir(parents=True, exist_ok=True)
    out = pathlib.Path(args.out) if args.out else state_dir / "jax_rows.jsonl"
    for seed in args.seeds:
        row = json.dumps(fit_and_dump(seed, state_dir))
        with open(out, "a") as f:
            f.write(row + "\n")
        print(row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
