"""One rank of a gloo world for the port's multi-device tests
(`tests/test_torch_port_parallel.py`, `tests/test_torch_port_ring_attention.py`,
`tests/test_torch_port_tensor_parallel.py`).

    python tests/torch_port_parallel_worker.py <spec.pkl> <rank>

The spec (a pickled dict) gives the world size, a FileStore path (so that
test workers never race for a port), an output directory and the jobs:
each `(name, kwargs)` runs the function `job_<name>` of this module on
every rank, in order. A job's result, or the error it raised, goes into
`<out>/rank<r>.pkl` under its name. Imports nothing of JAX: the JAX side
runs in the test process, and arrays travel as numpy.
"""

from __future__ import annotations

import copy
import datetime
import hashlib
import os
import pathlib
import pickle
import subprocess
import sys
import time
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


def one_epoch(name, x, y, batch_size, mesh, placed=False):
    """One epoch of trainer `name` from seed 0 and drawn Adam moments,
    under `mesh` (or none); `placed`: on the state placed with
    `shard_net_state`'s specs (`whole` is then the digest of its gathered
    leaves)."""
    cls = getattr(cvaegan_tpu_torch, name)
    model = cls(seed=0, device="cpu", settings=settings(batch_size))
    model.verbose = False
    with mesh_lib.use_mesh(mesh):
        model._prepare((x, y))
        draw_moments(model)
        if placed:
            place(model, mesh)
        model._fit_prepared(1)
    out = {"losses": {k: v[0] for k, v in model.loss_history.items()},
           "digest": digest(model._static_tensors()[:-1])}
    if placed:
        out["whole"] = digest(mesh_lib.gather_leaf(t) for t in model._static_tensors()[:-1])
    return out


def place(trainer, mesh, n_model=None):
    """Place a trainer's state and optimizers on `shard_net_state`'s specs."""
    mesh_lib.place(trainer.state, mesh_lib.shard_net_state(trainer.state, mesh, n_model),
                   trainer.optimizers)


def job_epochs(names, x, y, batch_size):
    mesh = mesh_lib.make_mesh(dist.get_world_size(), 1)
    mesh_lib.COLLECTIVES = 0
    out = {name: one_epoch(name, x, y, batch_size, mesh) for name in names}
    out["collectives"] = mesh_lib.COLLECTIVES
    return out


def job_epoch_2x2(x, y, batch_size):
    mesh = mesh_lib.make_mesh(dist.get_world_size() // 2, 2)
    return one_epoch("CVAEGAN", x, y, batch_size, mesh)


def job_seed_bank(x, y, batch_size, seeds, epochs, n_model=1):
    mesh = mesh_lib.make_mesh(dist.get_world_size() // n_model, n_model)
    bank = cvaegan_tpu_torch.SeedBank(cvaegan_tpu_torch.CVAEGAN, seeds=seeds,
                                      settings=settings(batch_size, epochs),
                                      device="cpu", mesh=mesh)
    trainers = bank.fit([(x, y)] * len(seeds))
    out = {"histories": [dict(t.loss_history) for t in trainers],
           "digests": [digest(t._static_tensors()[:-1]) for t in trainers],
           "rng": [digest([t.generator.get_state()]) for t in trainers],
           "held": [t.seed for t in bank._held],
           "held_digests": [digest(t._static_tensors()[:-1]) for t in bank._held],
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


# ------------------------------------------------- tensor parallelism
def _model_mesh():
    """The ('data', world / 2, 'model' 2) mesh of the world."""
    return mesh_lib.make_mesh(dist.get_world_size() // 2, 2)


def _trainer(name, tree, x, y, batch_size=32):
    model = getattr(cvaegan_tpu_torch, name)(seed=0, device="cpu",
                                            settings=settings(batch_size))
    model.verbose = False
    model._prepare((x, y))
    model.load_jax_state(tree)
    return model


def _flax_leaves(trainer, gather=False):
    """Every network leaf of a trainer (its own slice, or gathered whole),
    and each parameter's Adam moments (`#mu`, `#nu`), by `network/Flax
    path`, in the Flax layout, as numpy."""
    out = {}
    for name, net, _ in mesh_lib._networks(trainer.state):
        opt = trainer.optimizers.get(name)
        slot = {id(p): i for i, p in enumerate(opt.params)} if opt else {}
        for path, (tensor, transposed) in net_leaves(net).items():
            key = f"{name}/{'/'.join(path)}"
            leaves = {key: tensor}
            if id(tensor) in slot:
                leaves[key + "#mu"] = opt.m[slot[id(tensor)]]
                leaves[key + "#nu"] = opt.v[slot[id(tensor)]]
            for k, t in leaves.items():
                t = (mesh_lib.gather_leaf(t) if gather else t).detach()
                out[k] = (t.T if transposed else t).numpy().copy()
    return out


def job_tp_place(trees, x, y):
    """A converted CVAE-GAN and TMG-GAN placed on the (world/2, 2) mesh:
    each rank's slices and the gathered leaves; and a state placed on
    replicated specs after the ranks' states were made to differ."""
    mesh = _model_mesh()
    out = {}
    for name, tree in trees.items():
        model = _trainer(name, tree, x, y)
        place(model, mesh)
        before = digest(model._static_tensors()[:-1])
        model._sync_ranks(mesh)  # as a fit under the mesh does: slices stay
        out[name] = {"synced_unchanged": digest(model._static_tensors()[:-1]) == before,
                     "local": _flax_leaves(model),
                     "whole": _flax_leaves(model, gather=True),
                     "counts": {k: int(o.count) for k, o in model.optimizers.items()},
                     "shards": sum(mesh_lib.shard_of(t) is not None
                                   for t in model._static_tensors())}
    mapping = {"kernel": torch.arange(24.0).reshape(4, 6), "odd": torch.zeros(4, 3),
               "nested": {"scale": torch.arange(8.0)}, "step": 3}
    mesh_lib.place(mapping, mesh_lib.shard_net_state(mapping, mesh))
    out["mapping"] = {"kernel": mapping["kernel"].numpy(), "odd": tuple(mapping["odd"].shape),
                      "scale": mapping["nested"]["scale"].numpy(),
                      "whole": mesh_lib.gather_leaf(mapping["kernel"]).numpy()}
    model = _trainer("CVAEGAN", trees["CVAEGAN"], x, y)
    if dist.get_rank():
        with torch.no_grad():
            for p in model.state.parameters():
                p.add_(1.0)
    mesh_lib.place(model.state, mesh_lib.shard_net_state(model.state, mesh, n_model=1),
                   model.optimizers)
    out["replicated"] = digest(model.state.state_dict().values())
    try:
        mesh_lib.place(model.state, {"generator": {("params", "Dense_0", "kernel"):
                                                   mesh_lib.NamedSharding(mesh, mesh_lib.P(
                                                       "data", None))}})
        out["data_spec"] = None
    except ValueError as e:
        out["data_spec"] = str(e)
    return out


def job_tp_steps(tree, x, y, batch_size, inputs, masks, epoch):
    """The CVAE-GAN's D, C and E+G steps, as `job_cvaegan_steps`, on the
    (world/2, 2) mesh with the state placed: each step's loss and the
    gathered state (rank 0's), and digests of the local and the gathered
    state."""
    queue = [m for step in ("d", "c", "g") for m in masks[step]]

    def keep_mask(x_, keep_prob, generator):
        mask = torch.from_numpy(queue.pop(0))
        return mesh_lib.local_draw(lambda shape: mask, x_.shape)

    plain, tl._keep_mask = tl._keep_mask, keep_mask
    mesh = _model_mesh()
    out = {}
    try:
        for kind in ("d", "c", "g"):
            port = _trainer("CVAEGAN", tree, x, y, batch_size)
            place(port, mesh)
            with mesh_lib.use_mesh(mesh), mesh_lib.data_parallel(batch_size):
                t = [mesh_lib.shard_leading(torch.from_numpy(a)) for a in inputs[kind]]
                if kind == "g":
                    lam = progressive_lambda(torch.tensor(epoch), 0.5, 200, 500)
                    got = port._g_step(t[0], t[1].long(), t[2], t[3], lam)
                    loss = {k: float(v) for k, v in got.items()}
                else:
                    step = port._d_step if kind == "d" else port._c_step
                    loss = float(step(t[0], t[1].long(), t[2]))
            whole = _flax_leaves(port, gather=True)
            out[kind] = {"loss": loss, "rows": int(t[0].shape[0]),
                         "local": digest(port._static_tensors()[:-1]),
                         "whole": digest(torch.from_numpy(v) for v in whole.values()),
                         "state": whole if dist.get_rank() == 0 else None,
                         "counts": {k: int(o.count) for k, o in port.optimizers.items()}}
    finally:
        tl._keep_mask = plain
    assert not queue, len(queue)
    return out


def job_tp_spectral(forwards):
    """SpectralDense layers (rows and v sliced; weight replicated with v
    sliced; rows sliced with v whole) placed on the (world/2, 2) mesh:
    `forwards` train forwards and one eval forward, each layer's gathered
    u, v, sigma, outputs and weight gradient beside an unplaced copy's."""
    mesh = _model_mesh()
    out = {}
    for in_f, out_f in ((8, 16), (64, 1), (35, 4)):
        g = torch.Generator().manual_seed(in_f * 100 + out_f)
        layer = tl.SpectralDense(in_f, out_f)
        layer.init_from(g)
        x = torch.randn(6, in_f, generator=g)
        c = torch.randn(6, out_f, generator=g) / (6 * out_f)  # gradients of order 1
        ref = copy.deepcopy(layer)
        place_module(layer, mesh)
        res = {}
        for name, m in (("placed", layer), ("plain", ref)):
            m.train()
            for _ in range(forwards):
                y = m(x)
            (y * c).sum().backward()
            m.eval()
            ev = m(x)
            with torch.no_grad():
                v = mesh_lib.gather_leaf(m.v)
                w = mesh_lib.gather_leaf(m.weight)
                u = mesh_lib.gather_leaf(m.u)
                sigma = torch.dot(u, w @ v)
            res[name] = {"u": u.numpy().copy(), "v": v.numpy().copy(),
                         "sigma": float(sigma), "train_out": y.detach().numpy(),
                         "eval_out": ev.detach().numpy(),
                         "grad": _whole_grad(m.weight)}
        res["sliced"] = {k: mesh_lib.shard_of(getattr(layer, k)) is not None
                         for k in ("weight", "u", "v")}
        out[(in_f, out_f)] = res
    return out


def _whole_grad(param):
    """A parameter's gradient, gathered whole where the parameter is sliced."""
    shard = mesh_lib.shard_of(param)
    grad = param.grad if shard is None else mesh_lib._gather(param.grad, shard.dim, shard)
    return grad.numpy().copy()


def place_module(module, mesh, n_model=None):
    mesh_lib.place(module, mesh_lib.shard_net_state(module, mesh, n_model))


def job_tp_epochs(names, x, y, batch_size):
    """One epoch of each trainer on the placed state under the
    (world/2, 2) mesh."""
    mesh = _model_mesh()
    mesh_lib.COLLECTIVES = 0
    out = {name: one_epoch(name, x, y, batch_size, mesh, placed=True) for name in names}
    out["collectives"] = mesh_lib.COLLECTIVES
    return out


def job_tp_fits(names, x, y, batch_size, epochs, loops=None):
    """`fit` of `epochs` epochs of each trainer placed on the (world/2, 2)
    mesh, under it (the fit first syncs the ranks, slices kept; `loops`
    steps of each kind per class round, the settings' by default), then 8
    qualified samples of class 0."""
    mesh = _model_mesh()
    out = {}
    for name in names:
        s = settings(batch_size, epochs)
        if loops is not None:
            s.gan.d_loop_num = s.gan.c_loop_num = s.gan.g_loop_num = loops
        model = getattr(cvaegan_tpu_torch, name)(seed=0, device="cpu", settings=s)
        model.verbose = False
        model._prepare((x, y))
        place(model, mesh)
        with mesh_lib.use_mesh(mesh):
            model.fit((x, y))
            try:
                q = model.generate_qualified_samples(0, 8, confidence_threshold=0.0)
            except TypeError:  # TMG-GAN's filter takes no threshold
                q = model.generate_qualified_samples(0, 8)
        out[name] = {"history": {k: list(v) for k, v in model.loss_history.items()},
                     "qualified": q}
    return out


def job_tp_serving(tree, x, y):
    """The CVAE-GAN's serving entry points on a placed state and on an
    unplaced one from the same tree and generator state."""
    mesh = _model_mesh()
    placed, plain = _trainer("CVAEGAN", tree, x, y), _trainer("CVAEGAN", tree, x, y)
    place(placed, mesh)
    out = {}
    for name, m in (("placed", placed), ("plain", plain)):
        fast = m.generate_samples_fast(3, 40)
        out[name] = {"samples": m.generate_samples(1, 40),
                     "reconstructed": m.reconstruct_samples(x[:24], y[:24]),
                     "fast": fast, "fast_again": m.generate_samples_fast(3, 40),
                     "cached_fold": "fast_fold" in m._gen_cache}
    return out


def job_tp_capture_key(x, y, batch_size, ckpt):
    """A 1-epoch fit, `place`, a second fit: the capture key before and
    after, and the captures a stand-in for `capture_graphs` was asked for
    (the CPU has no CUDA graph); then a checkpoint of the placed state
    saved into `ckpt` and restored into another placed trainer."""
    from cvaegan_tpu_torch.algorithms import base
    from cvaegan_tpu_torch.utils import checkpoint

    mesh = _model_mesh()
    captured = []

    class Graph:
        def __init__(self, body):
            self.replay = body

    def capture(bodies, warm_up, static, generators, device):
        captured.append([tuple(t.shape) for t in static])
        return [Graph(body) for body in bodies]

    model = cvaegan_tpu_torch.CVAEGAN(seed=0, device="cpu", settings=settings(batch_size))
    model.verbose = False
    out = {}
    plain, base.capture_graphs = base.capture_graphs, capture
    try:
        with mesh_lib.use_mesh(mesh):
            model._prepare((x, y))
            with mesh_lib.data_parallel(batch_size):
                model._captured_epoch()()
                before = model._capture_key()
                place(model, mesh)
                model._captured_epoch()()
                after = model._capture_key()
                model._captured_epoch()()  # the placed capture is kept
    finally:
        base.capture_graphs = plain
    out["key_changed"] = before != after
    out["stale_kept"] = before in model._graphs
    out["captures"] = captured
    checkpoint.save_checkpoint(model, ckpt)  # rank 0 writes; returns once it has
    out["whole"] = _flax_leaves(model, gather=True)
    other = cvaegan_tpu_torch.CVAEGAN(seed=1, device="cpu", settings=settings(batch_size))
    other.verbose = False
    other._prepare((x, y))
    place(other, mesh)
    checkpoint.restore_checkpoint(other, ckpt, (x, y))
    out["restored_local_equal"] = digest(other._static_tensors()[:-1]) == digest(
        model._static_tensors()[:-1])
    return out


# ------------------------------------------------------------ the world
def start_world(tmp, world: int, jobs, wait_seconds: int = 240):
    """Spawn a gloo world of `world` ranks of this script running `jobs`
    (in the test process); returns a function that waits for it (up to
    `wait_seconds` for each rank) and gives each rank's results."""
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
                outs.append(p.communicate(timeout=wait_seconds))
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
    results = {"seconds": {}}
    for name, kwargs in spec["jobs"]:
        t0 = time.perf_counter()
        try:
            results[name] = globals()[f"job_{name}"](**kwargs)
        except Exception:  # reported to the test, which fails on it
            results[name] = {"error": traceback.format_exc()}
        results["seconds"][name] = time.perf_counter() - t0
    with open(os.path.join(spec["out"], f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
