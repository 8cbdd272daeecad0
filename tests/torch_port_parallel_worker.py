"""One rank of a gloo world for the port's multi-device tests
(`tests/test_torch_port_parallel.py`, `tests/test_torch_port_ring_attention.py`).

    python tests/torch_port_parallel_worker.py <spec.pkl> <rank>

The spec (a pickled dict) gives the world size, a FileStore path (so that
test workers never race for a port), an output directory and the jobs:
each `(name, kwargs)` runs the function `job_<name>` of this module on
every rank, in order. A job's result, or the error it raised, goes into
`<out>/rank<r>.pkl` under its name. Imports nothing of JAX: the JAX side
runs in the test process, and arrays travel as numpy.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import pathlib
import pickle
import subprocess
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import cvaegan_tpu_torch  # noqa: E402
from cvaegan_tpu_torch.convert import net_leaves  # noqa: E402
from cvaegan_tpu_torch.core import config as tconfig  # noqa: E402
from cvaegan_tpu_torch.core.schedules import progressive_lambda  # noqa: E402
from cvaegan_tpu_torch.kernels import block_attention as ba  # noqa: E402
from cvaegan_tpu_torch.kernels import ring_attention as ra  # noqa: E402
from cvaegan_tpu_torch.models import layers as tl  # noqa: E402
from cvaegan_tpu_torch.parallel import distributed  # noqa: E402
from cvaegan_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402


def settings(batch_size: int, epochs: int = 1) -> tconfig.Settings:
    s = tconfig.Settings()
    s.gan.batch_size = batch_size
    s.gan.epochs = epochs
    return s


def digest(tensors) -> str:
    """sha256 of the tensors' bytes: equal digests are bitwise-equal states."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def state_of(trainer) -> dict:
    """Every leaf of the CVAE-GAN state by Flax path and in the Flax
    layout, with its Adam moments (`#mu`, `#nu`) and counts."""
    out = {}
    for name in ("encoder", "generator", "discriminator", "classifier"):
        net, opt = trainer.state[name], trainer.optimizers[name]
        slot = {id(p): i for i, p in enumerate(opt.params)}
        for path, (tensor, transposed) in net_leaves(net).items():
            key = f"{name}/{'/'.join(path)}"
            leaves = {key: tensor.detach()}
            if path[0] == "params":
                leaves[key + "#mu"] = opt.m[slot[id(tensor)]]
                leaves[key + "#nu"] = opt.v[slot[id(tensor)]]
            for k, t in leaves.items():
                out[k] = (t.T if transposed else t).numpy().copy()
        out[f"{name}#count"] = int(opt.count)
    return out


# ------------------------------------------------------------------- jobs
def job_mesh_basics(tree, x, y):
    world = dist.get_world_size()
    out = {"world_mesh": mesh_lib.make_mesh(world, 1).shape,
           "global_mesh": distributed.global_mesh().shape,
           "global_mesh_2": distributed.global_mesh(n_model=2).shape,
           "multi_host": distributed.is_multi_host()}
    for what, fn in (("too_many", lambda: mesh_lib.make_mesh(64, 2)),
                     ("bad_model", lambda: distributed.global_mesh(n_model=3))):
        try:
            fn()
            out[what] = None
        except ValueError as e:
            out[what] = str(e)
    mesh = mesh_lib.make_mesh(world // 2, 2)
    out["mesh_2x2"] = mesh.shape
    out["coords"] = (mesh.local_rank("data"), mesh.local_rank("model"))
    with mesh_lib.use_mesh(mesh_lib.make_mesh(world, 1)) as m:
        for rows in (8, 6, 2):  # 6 and 2 leave the last of 4 ranks no rows
            try:
                out[f"shard_{rows}"] = mesh_lib.shard_leading(torch.arange(rows)).tolist()
            except ValueError as e:
                out[f"shard_{rows}"] = str(e)
        out["current"] = mesh_lib.current_mesh() is m
    out["after"] = mesh_lib.current_mesh() is None
    port = cvaegan_tpu_torch.CVAEGAN(seed=0, device="cpu", settings=settings(32))
    port._prepare((x, y))
    port.load_jax_state(tree)
    shardings = mesh_lib.shard_net_state(port.state, mesh)
    out["specs"] = {net: {"/".join(p): tuple(s.spec) for p, s in leaves.items()}
                    for net, leaves in shardings.items()}
    try:
        mesh_lib.place(port.state, shardings, port.optimizers)
        out["place_model"] = None
    except NotImplementedError as e:
        out["place_model"] = str(e)
    # replicated specs place: the first rank's state on every rank
    if dist.get_rank():
        with torch.no_grad():
            for p in port.state.parameters():
                p.add_(1.0)
    data_mesh = mesh_lib.make_mesh(world, 1)
    mesh_lib.place(port.state, mesh_lib.shard_net_state(port.state, data_mesh),
                   port.optimizers)
    out["placed"] = digest(port.state.state_dict().values())
    return out


def job_cvaegan_steps(tree, x, y, batch_size, inputs, masks, epoch):
    """The CVAE-GAN's D, C and E+G steps from `tree`, each on its fixed
    global inputs and dropout keep-masks, under a data mesh of the
    world."""
    queue = [m for step in ("d", "c", "g") for m in masks[step]]

    def keep_mask(x_, keep_prob, generator):
        mask = torch.from_numpy(queue.pop(0))
        return mesh_lib.local_draw(lambda shape: mask, x_.shape)

    plain, tl._keep_mask = tl._keep_mask, keep_mask
    try:
        return steps_on_masks(tree, x, y, batch_size, inputs, epoch, queue)
    finally:
        tl._keep_mask = plain


def steps_on_masks(tree, x, y, batch_size, inputs, epoch, queue):
    mesh = mesh_lib.make_mesh(dist.get_world_size(), 1)
    out = {}
    for kind in ("d", "c", "g"):
        port = cvaegan_tpu_torch.CVAEGAN(seed=0, device="cpu", settings=settings(batch_size))
        port._prepare((x, y))
        port.load_jax_state(tree)
        with mesh_lib.use_mesh(mesh), mesh_lib.data_parallel(batch_size):
            t = [mesh_lib.shard_leading(torch.from_numpy(a)) for a in inputs[kind]]
            if kind == "g":
                lam = progressive_lambda(torch.tensor(epoch), 0.5, 200, 500)
                got = port._g_step(t[0], t[1].long(), t[2], t[3], lam)
                loss = {k: float(v) for k, v in got.items()}
            else:
                step = port._d_step if kind == "d" else port._c_step
                loss = float(step(t[0], t[1].long(), t[2]))
        state = state_of(port)
        out[kind] = {"loss": loss, "rows": int(t[0].shape[0]),
                     "digest": digest(torch.from_numpy(np.asarray(v)) for v in state.values()),
                     "state": state if dist.get_rank() == 0 else None}
    assert not queue, len(queue)
    return out


def draw_moments(trainer, seed: int = 5) -> None:
    """Adam moments drawn by numpy (count 3, |m| < 2e-4, v in [1e-8,
    1e-6]), as the port's parity tests start from: from a real first
    step's near-zero v, Adam divides the float32 noise of exactly-zero
    gradients by its eps, and the critics' losses drift apart."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for opt in trainer.optimizers.values():
            for m, v in zip(opt.m, opt.v):
                m.copy_(torch.from_numpy(rng.uniform(-2e-4, 2e-4, m.shape).astype(np.float32)))
                v.copy_(torch.from_numpy(rng.uniform(1e-8, 1e-6, v.shape).astype(np.float32)))
            opt.count.fill_(3)


def one_epoch(name, x, y, batch_size, mesh):
    """One epoch of trainer `name` from seed 0 and drawn Adam moments,
    under `mesh` (or none)."""
    cls = getattr(cvaegan_tpu_torch, name)
    model = cls(seed=0, device="cpu", settings=settings(batch_size))
    model.verbose = False
    with mesh_lib.use_mesh(mesh):
        model._prepare((x, y))
        draw_moments(model)
        model._fit_prepared(1)
    return {"losses": {k: v[0] for k, v in model.loss_history.items()},
            "digest": digest(model._static_tensors()[:-1])}


def job_epochs(names, x, y, batch_size):
    mesh = mesh_lib.make_mesh(dist.get_world_size(), 1)
    mesh_lib.COLLECTIVES = 0
    out = {name: one_epoch(name, x, y, batch_size, mesh) for name in names}
    out["collectives"] = mesh_lib.COLLECTIVES
    return out


def job_epoch_2x2(x, y, batch_size):
    mesh = mesh_lib.make_mesh(dist.get_world_size() // 2, 2)
    return one_epoch("CVAEGAN", x, y, batch_size, mesh)


def job_seed_bank(x, y, batch_size, seeds, epochs):
    mesh = mesh_lib.make_mesh(dist.get_world_size(), 1)
    bank = cvaegan_tpu_torch.SeedBank(cvaegan_tpu_torch.CVAEGAN, seeds=seeds,
                                      settings=settings(batch_size, epochs),
                                      device="cpu", mesh=mesh)
    trainers = bank.fit([(x, y)] * len(seeds))
    out = {"histories": [dict(t.loss_history) for t in trainers],
           "digests": [digest(t._static_tensors()[:-1]) for t in trainers],
           "rng": [digest([t.generator.get_state()]) for t in trainers],
           "held": [t.seed for t in bank._held],
           "steps_per_sec_positive": bank.steps_per_sec > 0}
    try:
        cvaegan_tpu_torch.SeedBank(cvaegan_tpu_torch.CVAEGAN, seeds=seeds[:-1],
                                   device="cpu", mesh=mesh)
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    return out


def job_ring(cases):
    mesh = mesh_lib.make_mesh(dist.get_world_size(), 1)
    out = {}
    for key, (q, k, v) in cases.items():
        q, k, v = (torch.from_numpy(a) for a in (q, k, v))
        got, ent = ra.ring_attention(q, k, v, mesh, with_entropy=True)
        plain = ra.ring_attention(q, k, v, mesh)
        out[key] = {"out": got.numpy(), "ent": ent.numpy(), "plain_out": plain.numpy(),
                    "ref": ba.reference_attention(q, k, v).numpy(),
                    "ref_ent": ba.reference_attention_entropy(q, k).numpy()}
        try:
            ra.ring_attention(q[:, :-1], k[:, :-1], v[:, :-1], mesh)
            out[key]["uneven"] = None
        except ValueError as e:
            out[key]["uneven"] = str(e)
    return out


# ------------------------------------------------------------ the world
def start_world(tmp, world: int, jobs):
    """Spawn a gloo world of `world` ranks of this script running `jobs`
    (in the test process); returns a function that waits for it and gives
    each rank's results."""
    tmp = pathlib.Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    spec = {"world": world, "store": str(tmp / "store"), "out": str(tmp),
            "jobs": jobs, "timeout": 120}
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(tmp / "spec.pkl"), str(r)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]

    def wait():
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=240))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
        for r, (p, (_, err)) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
        results = []
        for r in range(world):
            with open(tmp / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results

    return wait


def job(results, name):
    """One job's results of every rank; a rank's error fails the test."""
    out = [r[name] for r in results]
    for r, res in enumerate(out):
        assert "error" not in res, f"rank {r}: {res.get('error')}"
    return out


# ------------------------------------------------------------------- main
def main(spec_path: str, rank: int) -> None:
    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(spec["store"], spec["world"]),
                            rank=rank, world_size=spec["world"],
                            timeout=datetime.timedelta(seconds=spec.get("timeout", 300)))
    results = {}
    for name, kwargs in spec["jobs"]:
        try:
            results[name] = globals()[f"job_{name}"](**kwargs)
        except Exception:  # reported to the test, which fails on it
            results[name] = {"error": traceback.format_exc()}
    with open(os.path.join(spec["out"], f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
