"""How often the bf16 step gate misses, in the port and in the JAX package.

`tests/test_torch_port_bf16_zoo.py` holds each trainer's steps under the
bf16 policy to the JAX package's: at one key, each loss and tensor's
largest error from the port's float64 step is within BF16_TOL of its
scale or no more than twice JAX's; the ANCHORED steps over six keys, the
port missing that rule no more often than JAX misses the mirrored one
(JAX held to twice the port's error). This script measures what that
gate rests on, on the CPU, through the test module's own helpers:

    python experiments/torch_port_bf16_gate_study.py counts --keys 6
    python experiments/torch_port_bf16_gate_study.py counts --cases RAIN_GAN:d --keys 24
    python experiments/torch_port_bf16_gate_study.py counts --cases RAIN_GAN:d --keys 24 \\
        --no-excess-precision
    python experiments/torch_port_bf16_gate_study.py critic

`counts`: per case and key, the misses of each side and which losses or
tensors miss; per tensor, the mean log of the port's error over JAX's
(positive: the port's is larger). `--no-excess-precision` runs XLA with
`--xla_allow_excess_precision=false`, so that JAX rounds every bf16
intermediate it is asked to. `critic`: RAIN-GAN's critic on its D step's
own inputs (the float64 generator's rows rounded to bf16, as the test
gives both packages): per parameter, the largest and the mean error of
each package's gradient from float64 and the share of elements equal to
the exact gradient rounded to bf16; and the sign flips of the last
block's output against float64 in each package. One JSON line per
result, also appended to `--out`.
"""

import argparse
import json
import os
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
RESULTS = REPO / "experiments" / "results"


def setup(no_excess_precision):
    if no_excess_precision:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_allow_excess_precision=false").strip()
    for path in (REPO, REPO / "tests"):
        sys.path.insert(0, str(path))
    import conftest  # noqa: F401  (the CPU platform and its 8 virtual devices)
    import torch

    from cvaegan_tpu.core import config as jconfig
    from cvaegan_tpu_torch.core import config as tconfig

    torch.set_num_threads(1)
    jconfig.settings.gan.compute_dtype = "bfloat16"
    tconfig.settings.gan.compute_dtype = "bfloat16"


def counts(cases, keys, emit):
    import numpy as np
    import pytest
    import test_torch_port_bf16_zoo as zoo

    from cvaegan_tpu.data.tabular import TabularDataset

    ds = TabularDataset.synthetic_blobs(seed=0)
    for name, kind in cases:
        first = 70 + zoo.CASES.index((name, kind))
        with pytest.MonkeyPatch.context() as mp:
            runs = zoo._step_runs(name, kind, ds, mp, [first + 100 * i for i in range(keys)])
        per_key = [zoo.step_errors(r) for r in runs]
        rows, ratios = [], {}
        for k, items in enumerate(per_key):
            ours = [str(i) for i, e in items.items() if zoo.gate_misses(*e)[0]]
            theirs = [str(i) for i, e in items.items() if zoo.gate_misses(*e)[1]]
            rows.append({"key": first + 100 * k, "port_misses": ours, "jax_misses": theirs})
            for i, (err, their, _) in items.items():
                if err > 0 and their > 0:
                    ratios.setdefault(str(i), []).append(np.log(err / their))
        log_ratio = {i: float(np.mean(v)) for i, v in ratios.items() if len(v) == keys}
        emit({"study": "counts", "case": [name, kind], "keys": keys,
              "port_misses": sum(len(r["port_misses"]) for r in rows),
              "jax_misses": sum(len(r["jax_misses"]) for r in rows),
              "per_key": rows, "mean_log_ratio_all": float(np.mean(list(log_ratio.values()))),
              "largest_log_ratio": sorted(log_ratio.items(), key=lambda kv: -kv[1])[:10],
              "smallest_log_ratio": sorted(log_ratio.items(), key=lambda kv: kv[1])[:10]})


def critic(draws, emit):
    import copy

    import jax
    import jax.numpy as jnp
    import numpy as np
    import test_torch_port_family as family
    import test_torch_port_sngan_ctgan as snct
    import torch

    from cvaegan_tpu.data.tabular import TabularDataset
    from cvaegan_tpu_torch.models import layers as tl

    ds = TabularDataset.synthetic_blobs(seed=0)
    jt, state, tree = snct.jax_twin("RAIN_GAN", ds)
    module, d = jt.modules["discriminator"], state["discriminator"]
    twin = lambda: snct.port_twin("RAIN_GAN", ds)  # noqa: E731
    grads, flips = {}, []
    for i in range(draws):
        k_x, k_z = jax.random.split(jax.random.PRNGKey(93 + 100 * i))
        x_real, y = jt._sample_batch(k_x, jt._data, 2)
        gen = twin()
        gen.state.double()
        with torch.no_grad(), tl.dtype_override(torch.float32):
            rows = gen.state["generator"].train()(
                torch.from_numpy(np.array(family._normal(jt, k_z), np.float64)),
                torch.from_numpy(np.array(y)).long())[0]
        x = np.concatenate([np.asarray(x_real, np.float32),
                            rows.to(torch.bfloat16).float().numpy()])
        yy = np.concatenate([np.asarray(y)] * 2).astype(np.int32)
        c = np.repeat([-1.0, 1.0], len(x) // 2).astype(np.float32)[:, None] / (len(x) // 2)

        def jax_loss(p):
            (scores, _), _ = module.apply({"params": p, **d.mutables}, jnp.asarray(x),
                                          jnp.asarray(yy), train=True, mutable=["spectral"])
            return jnp.sum(scores.astype(jnp.float32) * c)

        carried = copy.deepcopy(tree)
        carried["discriminator"]["params"] = jax.device_get(jax.jit(jax.grad(jax_loss))(d.params))
        from_jax = twin()
        from_jax.load_jax_state(carried)
        g_jax = {n: p.detach().double()
                 for n, p in from_jax.state["discriminator"].named_parameters()}
        outs = {}

        def port_grad(f64):
            port = twin()
            if f64:
                port.state.double()
            dis = port.state["discriminator"].train()
            hook = dis.blocks[-1].register_forward_hook(
                lambda m, a, o: outs.__setitem__(f64, o[0].detach().double()))
            xt, yt = torch.from_numpy(x), torch.from_numpy(yy).long()
            if f64:
                with tl.dtype_override(torch.float32):
                    scores, _ = dis(xt.double(), yt)
            else:
                scores, _ = dis(xt, yt)
            (scores.double() * torch.from_numpy(c).double()).sum().backward()
            hook.remove()
            return {n: p.grad.detach().double() for n, p in dis.named_parameters()}

        g_port, g_exact = port_grad(False), port_grad(True)
        _, inter = module.apply({"params": d.params, **d.mutables}, jnp.asarray(x),
                                jnp.asarray(yy), train=True,
                                mutable=["spectral", "intermediates"],
                                capture_intermediates=True)
        jax_last = np.asarray(
            inter["intermediates"]["ResidualAttentionBlock_1"]["__call__"][0][0], np.float64)
        exact_last = outs[True].numpy()
        flips.append({"port": int(((outs[False].numpy() < 0) != (exact_last < 0)).sum()),
                      "jax": int(((jax_last < 0) != (exact_last < 0)).sum()),
                      "units": int(exact_last.size)})
        for n, e in g_exact.items():
            rounded = e.float().bfloat16().double()
            grads.setdefault(n, []).append([
                float((g_port[n] - e).abs().max()), float((g_jax[n] - e).abs().max()),
                float((g_port[n] - e).abs().mean()), float((g_jax[n] - e).abs().mean()),
                float((g_port[n] == rounded).double().mean()),
                float((g_jax[n] == rounded).double().mean())])
    emit({"study": "critic", "draws": draws, "last_block_sign_flips": flips,
          "gradients": {n: dict(zip(("max_port", "max_jax", "mean_port", "mean_jax",
                                     "rounded_share_port", "rounded_share_jax"),
                                    np.mean(v, 0).tolist())) for n, v in grads.items()}})


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("study", choices=("counts", "critic"))
    p.add_argument("--cases", nargs="+", default=None,
                   help="NAME:KIND (default: every ANCHORED case)")
    p.add_argument("--keys", type=int, default=6)
    p.add_argument("--draws", type=int, default=4)
    p.add_argument("--no-excess-precision", action="store_true")
    p.add_argument("--out", default=str(RESULTS / "torch_port_bf16_gate_study.jsonl"))
    args = p.parse_args()
    setup(args.no_excess_precision)
    out = pathlib.Path(args.out)

    def emit(rec):
        rec = {**rec, "xla_allow_excess_precision": not args.no_excess_precision}
        print(json.dumps(rec), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")

    if args.study == "counts":
        import test_torch_port_bf16_zoo as zoo

        cases = ([tuple(c.split(":")) for c in args.cases] if args.cases
                 else sorted(zoo.ANCHORED))
        counts(cases, args.keys, emit)
    else:
        critic(args.draws, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
