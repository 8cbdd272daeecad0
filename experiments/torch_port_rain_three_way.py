#!/usr/bin/env python3
"""RAIN-GAN's first class round three ways, on the CPU, from the same
weights and the same inputs: the port (`cvaegan_tpu_torch`), the JAX
package (`cvaegan_tpu`) and the benchmark's plain reference
(`bench_port/reference/rain_train.py`), each in float32, and the port and
the reference again in float64.

    JAX_PLATFORMS=cpu python experiments/torch_port_rain_three_way.py [--seeds 0 1 2]

The JAX trainer draws the weights from its seed (Adam fresh, as a fit
starts) and every step's inputs from its own keys, as its jitted steps
do; the port and the reference are handed the same weights and inputs.
One round of class 4 at the benchmark cell's widths and batch (5 D, 5 C,
3 E+G steps) runs on the Car-Hacking stand-in's frames of classes 0 and
4. After each step it prints, for each pair of runs, the gap of every
parameter's change since the start, as `bench_port/harness/compare.py`
reads it (the norm of the difference over the larger of that leaf's
change in the float32 reference and the median leaf's), over the leaves
the round has moved so far, by the median leaf and by the worst, and a 1-ulp nudge of the float32 reference's
weights beside them: where the three float32 runs stand as far from
each other as the nudged reference stands from the reference, while the
two float64 runs agree, the float32 gap is rounding that the steps
amplify, not a fault of one of them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CLASS_ID = 4
SCHEDULE = ["d"] * 5 + ["c"] * 5 + ["g"] * 3


def _inputs(jax, jt, data, kind, key):
    """The step's inputs as the JAX step draws them from `key`."""
    cfg = jt.gan_cfg
    shape = (cfg.batch_size, cfg.z_size)
    if kind == "g":
        k_x, k_eps, k_z = jax.random.split(key, 3)
        x, y = jt._sample_batch(k_x, data, CLASS_ID)
        return [np.array(a) for a in (x, y, jax.random.normal(k_z, shape),
                                      jax.random.normal(k_eps, shape))]
    k_x, k_z = jax.random.split(key)
    x, y = jt._sample_batch(k_x, data, CLASS_ID)
    return [np.array(a) for a in (x, y, jax.random.normal(k_z, shape))]


def _port_step(torch, port, kind, inputs, dtype):
    x, y, z, *eps = [torch.from_numpy(a) for a in inputs]
    x, z, y = x.to(dtype), z.to(dtype), y.long()
    if kind == "d":
        port._d_step(x, y, z)
    elif kind == "c":
        port._c_step(x, y, z)
    else:
        port._g_step(x, y, z, eps[0].to(dtype), port._lambda_class(torch.tensor(0.0)))


def _ref_step(torch, tr, kind, inputs, dtype):
    x, y, z, *eps = [torch.from_numpy(a)[None] for a in inputs]
    x, z, y = x.to(dtype), z.to(dtype), y.long()
    if kind == "d":
        tr.d_step(x, y, z)
    elif kind == "c":
        tr.c_step(x, y, z)
    else:
        tr.g_step(x, y, z, eps[0].to(dtype), 0.0)


def run(seed: int) -> None:
    import jax
    import torch

    import cvaegan_tpu
    import cvaegan_tpu_torch
    from bench_port.data import car_hacking
    from bench_port.harness import program, spec
    from bench_port.reference import nets, rain_train
    from cvaegan_tpu.core import config as jax_config
    from cvaegan_tpu_torch.core import config as port_config
    from cvaegan_tpu_torch.core import losses
    from test_torch_port_family import _tree  # tests/, which main puts on sys.path

    torch.set_num_threads(4)
    cfg = spec.load_json(spec.BENCH / "configs" / "raingan-carhacking.json")
    x, y = car_hacking.frames(100_000, 2_300_000_000 + seed)
    keep = (y == 0) | (y == CLASS_ID)
    x, y = x[keep], y[keep].astype(np.int32)

    jax_config.settings.gan.compute_dtype = "float32"
    jax_config.settings.gan.batch_size = cfg["batch_size"]
    jt = cvaegan_tpu.RAIN_GAN(seed=seed)
    jt.verbose = False
    jt._prepare((x, y))
    steps = {"d": jax.jit(jt._d_step, static_argnums=2),
             "c": jax.jit(jt._c_step, static_argnums=2),
             "g": jax.jit(lambda s, d, c, k: jt._g_step(s, d, c, 0.0, k), static_argnums=2)}

    def port_from(tree, dtype=torch.float32):
        s = port_config.Settings()
        s.gan.batch_size = cfg["batch_size"]
        p = cvaegan_tpu_torch.RAIN_GAN(seed=seed, settings=s, device="cpu")
        p.verbose = False
        p._prepare((x, y))
        p.load_jax_state(tree)
        if dtype == torch.float64:
            p.state.double()
            for opt in p.optimizers.values():
                opt.m, opt.v = [m.double() for m in opt.m], [v.double() for v in opt.v]
        return p

    state = jt.state
    port = port_from(_tree(state))
    port64 = port_from(_tree(state), torch.float64)
    leaves0 = program.state_leaves([port])
    data = rain_train.Data([torch.from_numpy(x)], [torch.from_numpy(y)], cfg["label_num"])

    def ref_from(leaves):
        return rain_train.Trainer(cfg, leaves, data, rain_train.Draws([seed], "cpu"))

    ref = ref_from(leaves0)
    ref64 = ref_from({n: {k: v.double() for k, v in ls.items()} for n, ls in leaves0.items()})
    g = torch.Generator().manual_seed(seed)
    nudged = ref_from({n: {k: v if nets.is_buffer(k) else
                           v * (1 + 2.0 ** -23 * torch.randn(v.shape, generator=g))
                           for k, v in ls.items()} for n, ls in leaves0.items()})

    def changes(kind_of, obj):
        if kind_of == "port":
            sd = {net: dict(m.state_dict()) for net, m in obj.state.items()}
            return {net: {k: sd[net][k].double() - leaves0[net][k][0].double()
                          for k in sd[net] if not nets.is_buffer(k)} for net in sd}
        return {net: {k: obj.p[net][k][0].detach().double() - leaves0[net][k][0].double()
                      for k in obj.p[net] if not nets.is_buffer(k)} for net in obj.p}

    def gaps(a, b, scale):
        rows = [(f"{n}.{k}", float((a[n][k] - b[n][k]).norm()), float(scale[n][k].norm()))
                for n in scale for k in scale[n]]
        moved = [(name, d, s) for name, d, s in rows if s > 0]
        med = float(np.median([s for _, _, s in moved]))
        values = [(d / max(s, med), name) for name, d, s in moved]
        worst = max(values)
        return {"median": float(np.median([v for v, _ in values])), "worst": worst[0],
                "at": worst[1]}

    old_f32 = losses._f32
    for i, kind in enumerate(SCHEDULE):
        key = jax.random.PRNGKey(1000 * seed + i)
        inputs = _inputs(jax, jt, jt._data, kind, key)
        state, _ = steps[kind](state, jt._data, CLASS_ID, key)
        _port_step(torch, port, kind, inputs, torch.float32)
        _ref_step(torch, ref, kind, inputs, torch.float32)
        _ref_step(torch, nudged, kind, inputs, torch.float32)
        losses._f32 = lambda *xs: xs[0] if len(xs) == 1 else xs
        try:
            _port_step(torch, port64, kind, inputs, torch.float64)
            _ref_step(torch, ref64, kind, inputs, torch.float64)
        finally:
            losses._f32 = old_f32
        runs = {"port": changes("port", port), "jax": changes("port", port_from(_tree(state))),
                "ref": changes("ref", ref), "nudged_ref": changes("ref", nudged),
                "port64": changes("port", port64), "ref64": changes("ref", ref64)}
        scale = runs["ref"]
        pairs = [("port", "ref"), ("jax", "ref"), ("port", "jax"), ("nudged_ref", "ref"),
                 ("port64", "ref64"), ("ref64", "ref")]
        print(json.dumps({"seed": seed, "step": i, "kind": kind,
                          **{f"{a}-{b}": gaps(runs[a], runs[b], scale) for a, b in pairs}}),
              flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    for seed in args.seeds:
        run(seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
