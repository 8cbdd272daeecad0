"""One rank of a gloo world for the port's multi-device tests
(`tests/test_torch_port_parallel.py`, `tests/test_torch_port_ring_attention.py`,
`tests/test_torch_port_tensor_parallel.py`).

    python tests/torch_port_parallel_worker.py <spec.pkl> <rank>

The spec (a pickled dict) gives the world size, a FileStore path (so that
test workers never race for a port), an output directory and the jobs:
each `(name, kwargs)` runs the function `job_<name>` of this module on
every rank, in order. Imports nothing of JAX: the JAX side runs in the test
process, and arrays travel as numpy.

The world is guarded so that one failure cannot run on into later jobs:

  * every rank records the collectives it issues through
    `torch.distributed` in a job (`CollectiveLog`: per process group, the
    op, the group's ranks, each tensor's dtype and shape, the reduce op
    and root), as a running sha256 and a count;
  * after each job the ranks agree, on a group of their own, that the job
    succeeded everywhere and that every rank of each group issued the same
    sequence (`parted` names the first collective where two ranks differ:
    gloo pairs collectives by order alone, so a same-sized pair out of
    step would otherwise hand over wrong data without an error);
  * a rank whose job raised, or a world whose sequences parted, writes the
    error to `<out>/fail-rank<r>.pkl` and exits; every other rank's
    watchdog sees the file and exits within a second, so no rank goes on to
    the next job's collectives, and no peer waits out gloo's timeout;
  * each rank writes its results to `<out>/rank<r>.pkl` after every agreed
    job, and its output to `<out>/rank<r>.log` (never a pipe the test
    process might not read in time).

`start_world(...)()` gives each rank's results; a job that failed, or that
came after a failure, holds `{"error": <the first failure's text>}`, which
`job` turns into the test's failure.
"""

from __future__ import annotations

import copy
import datetime
import functools
import hashlib
import inspect
import os
import pathlib
import pickle
import subprocess
import sys
import threading
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


def settings(batch_size: int, epochs: int = 1, dtype: str = "float32") -> tconfig.Settings:
    s = tconfig.Settings()
    s.gan.batch_size = batch_size
    s.gan.epochs = epochs
    s.gan.compute_dtype = dtype
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


def job_cvaegan_steps(tree, x, y, batch_size, inputs, masks, epoch, dtype="float32"):
    """The CVAE-GAN's D, C and E+G steps from `tree`, each on its fixed
    global inputs and dropout keep-masks, under a data mesh of the
    world, under the compute policy `dtype` (the steps run outside a
    trainer's own policy block: the process-wide setting). `inputs` and
    `masks` are keyed by step, in order: "d", "c", "g", or one of them
    followed by more characters for another key's step of that kind."""
    queue = [m for step in inputs for m in masks[step]]

    def keep_mask(x_, keep_prob, generator):
        mask = torch.from_numpy(queue.pop(0))
        return mesh_lib.local_draw(lambda shape: mask, x_.shape)

    plain, tl._keep_mask = tl._keep_mask, keep_mask
    policy, tconfig.settings.gan.compute_dtype = tconfig.settings.gan.compute_dtype, dtype
    try:
        return steps_on_masks(tree, x, y, batch_size, inputs, epoch, queue)
    finally:
        tl._keep_mask = plain
        tconfig.settings.gan.compute_dtype = policy


def job_cvaegan_steps_bf16(**kwargs):
    """`job_cvaegan_steps` under the bf16 policy."""
    return job_cvaegan_steps(**kwargs, dtype="bfloat16")


def steps_on_masks(tree, x, y, batch_size, inputs, epoch, queue):
    mesh = mesh_lib.make_mesh(dist.get_world_size(), 1)
    out = {}
    for kind in inputs:
        port = cvaegan_tpu_torch.CVAEGAN(seed=0, device="cpu", settings=settings(batch_size))
        port._prepare((x, y))
        port.load_jax_state(tree)
        with mesh_lib.use_mesh(mesh), mesh_lib.data_parallel(batch_size):
            t = [mesh_lib.shard_leading(torch.from_numpy(a)) for a in inputs[kind]]
            if kind[0] == "g":
                lam = progressive_lambda(torch.tensor(epoch), 0.5, 200, 500)
                got = port._g_step(t[0], t[1].long(), t[2], t[3], lam)
                loss = {k: float(v) for k, v in got.items()}
            else:
                step = port._d_step if kind[0] == "d" else port._c_step
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


def one_epoch(name, x, y, batch_size, mesh, placed=False, dtype="float32", nudge=0.0):
    """One epoch of trainer `name` from seed 0 and drawn Adam moments,
    under `mesh` (or none) and the compute policy `dtype`; `placed`: on
    the state placed with `shard_net_state`'s specs (`whole` is then the
    digest of its gathered leaves); `nudge`: every parameter first scaled
    by 1 + nudge N(0, 1) (torch seed 1)."""
    cls = getattr(cvaegan_tpu_torch, name)
    model = cls(seed=0, device="cpu", settings=settings(batch_size, dtype=dtype))
    model.verbose = False
    with mesh_lib.use_mesh(mesh):
        model._prepare((x, y))
        draw_moments(model)
        if nudge:
            g = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for p in model.state.parameters():
                    p.mul_(1.0 + nudge * torch.randn(p.shape, generator=g))
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


def job_epochs(names, x, y, batch_size, dtype="float32"):
    mesh = mesh_lib.make_mesh(dist.get_world_size(), 1)
    mesh_lib.COLLECTIVES = 0
    out = {name: one_epoch(name, x, y, batch_size, mesh, dtype=dtype) for name in names}
    out["collectives"] = mesh_lib.COLLECTIVES
    return out


def job_epochs_bf16(**kwargs):
    """`job_epochs` under the bf16 policy."""
    return job_epochs(**kwargs, dtype="bfloat16")


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


def job_tp_epochs(names, x, y, batch_size, dtype="float32"):
    """One epoch of each trainer on the placed state under the
    (world/2, 2) mesh."""
    mesh = _model_mesh()
    mesh_lib.COLLECTIVES = 0
    out = {name: one_epoch(name, x, y, batch_size, mesh, placed=True, dtype=dtype)
           for name in names}
    out["collectives"] = mesh_lib.COLLECTIVES
    return out


def job_tp_epochs_bf16(**kwargs):
    """`job_tp_epochs` under the bf16 policy."""
    return job_tp_epochs(**kwargs, dtype="bfloat16")


def streamed_fit(x_csv, y_csv, window_rows, batch_size, epochs, mesh, seed=0,
                 balanced=False):
    """`fit_streamed` of a CVAE-GAN of trainer seed `seed` under `mesh` (or
    none), its Adam moments drawn as the first window builds the state
    (numpy seed 5 + seed): a rank of another seed holds another state until
    the first window's `_sync_ranks` gives it rank 0's. Returns how often
    the ranks were synced, the digest of the static tensors and the
    generator as the first window's epochs start, and after each window
    the digest, the state (`state_of`) and the loss history so far."""
    model = cvaegan_tpu_torch.CVAEGAN(seed=seed, device="cpu",
                                      settings=settings(batch_size), balanced_mode=balanced)
    model.verbose = False
    out = {"windows": [], "syncs": 0}
    build, sync, fit = model._build_state, model._sync_ranks, model._fit_prepared

    def built():
        state = build()
        draw_moments(model, 5 + seed)
        return state

    def sync_ranks(m):
        sync(m)
        out["syncs"] += 1

    def fitted(epochs_, eager=False):
        if not out["windows"]:
            out["synced"] = digest([*model._static_tensors()[:-1],
                                    model.generator.get_state()])
        fit(epochs_, eager)
        out["windows"].append({
            "digest": digest(model._static_tensors()[:-1]), "state": state_of(model),
            "history": {k: list(v) for k, v in model.loss_history.items()}})

    model._build_state, model._sync_ranks, model._fit_prepared = built, sync_ranks, fitted
    with mesh_lib.use_mesh(mesh):
        out["n_windows"] = model.fit_streamed(x_csv, y_csv, window_rows=window_rows,
                                              epochs_per_window=epochs)
    return out


def job_streamed(x_csv, y_csv, window_rows, batch_size, epochs):
    """`streamed_fit` on a data mesh of the world, each rank of trainer seed
    = its rank, in strict and in balanced mode; then the same corpus at a
    batch that leaves the last data rank no rows: the error every rank
    raises."""
    mesh = mesh_lib.make_mesh(dist.get_world_size(), 1)
    out = {mode: streamed_fit(x_csv, y_csv, window_rows, batch_size, epochs, mesh,
                              seed=dist.get_rank(), balanced=mode == "balanced")
           for mode in ("strict", "balanced")}
    for mode in out:  # rank 0's states are the test's; the others' digests
        for w in out[mode]["windows"]:
            if dist.get_rank():
                w["state"] = None
    try:
        streamed_fit(x_csv, y_csv, window_rows, dist.get_world_size() - 1, epochs, mesh)
        out["empty_shard"] = None
    except ValueError as e:
        out["empty_shard"] = str(e)
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


def job_fail_between(fail_rank):
    """Two all-reduces; rank `fail_rank` raises between them (the guard's
    own test)."""
    dist.all_reduce(torch.ones(4))
    if dist.get_rank() == fail_rank:
        raise RuntimeError(f"planted failure on rank {fail_rank}")
    dist.all_reduce(torch.ones(4))
    return {"done": True}


def job_out_of_step(odd_rank):
    """An all-reduce of 6 floats that rank `odd_rank` issues as [3, 2] and
    the others as [2, 3]: gloo pairs them without an error (the guard's
    own test)."""
    shape = (3, 2) if dist.get_rank() == odd_rank else (2, 3)
    dist.all_reduce(torch.ones(4))
    dist.all_reduce(torch.ones(shape))
    return {"done": True}


def job_in_step():
    dist.all_reduce(torch.ones(4))
    return {"done": True}


# ------------------------------------------------------------ the guard
#: the `torch.distributed` functions `CollectiveLog` records; the port calls
#: them as `torch.distributed.<name>` (`dist.isend`/`irecv` travel inside
#: `batch_isend_irecv`, whose `P2POp` checks for the originals)
RECORDED = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter_tensor",
            "broadcast", "barrier", "reduce", "gather", "scatter", "all_to_all_single",
            "all_gather_object", "broadcast_object_list", "batch_isend_irecv")


def _describe(value) -> str:
    """A collective's argument as the sequence records it: a tensor by
    dtype and shape, a list by its items, a reduce op or a root as text;
    objects by type only (their pickles may differ between ranks)."""
    if isinstance(value, torch.Tensor):
        return f"{str(value.dtype).removeprefix('torch.')}{list(value.shape)}"
    if isinstance(value, dist.P2POp):
        return f"{value.op.__name__}:{_describe(value.tensor)}"
    if isinstance(value, (list, tuple)):
        return "[" + ",".join(_describe(v) for v in value) + "]"
    if isinstance(value, (int, str)) or value is None or type(value).__name__ in (
            "ReduceOp", "RedOpType"):
        return str(value)
    return type(value).__name__


class CollectiveLog:
    """Wraps `torch.distributed`'s collectives while installed: per process
    group (by its global ranks), the sequence of collectives this rank
    issued since `reset`, as a running sha256 and a count, and the entries
    themselves, to name where two ranks part."""

    #: arguments left out: the group (the key), and outputs, whose shapes
    #: follow the inputs'
    SKIP = {"group", "async_op", "tensor_list", "object_list", "output_tensor", "output",
            "gather_list", "scatter_list", "timeout", "device_ids", "device"}

    def __init__(self):
        self.originals = {name: getattr(dist, name) for name in RECORDED}
        self.reset()

    def reset(self) -> None:
        self.groups: dict = {}

    def install(self) -> None:
        for name, fn in self.originals.items():
            setattr(dist, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def recorded(*args, **kwargs):
            bound = sig.bind(*args, **kwargs).arguments
            group = bound.get("group")
            if name == "batch_isend_irecv":
                group = bound["p2p_op_list"][0].group
                # the peers are rank-relative: record the ops and tensors only
                entry = name + "(" + _describe(bound["p2p_op_list"]) + ")"
            else:
                entry = name + "(" + ",".join(f"{k}={_describe(v)}" for k, v in bound.items()
                                              if k not in self.SKIP) + ")"
            self._record(group, entry)
            return fn(*args, **kwargs)

        return recorded

    def _record(self, group, entry: str) -> None:
        ranks = tuple(dist.get_process_group_ranks(group) if group is not None
                      else range(dist.get_world_size()))
        seq = self.groups.get(ranks)
        if seq is None:
            seq = self.groups[ranks] = {"sha": hashlib.sha256(), "entries": []}
        seq["sha"].update(entry.encode() + b"\n")
        seq["entries"].append(entry)

    def summary(self) -> dict:
        """{group ranks: (count, sha256)} of the job so far."""
        return {ranks: (len(seq["entries"]), seq["sha"].hexdigest())
                for ranks, seq in self.groups.items()}

    def sequences(self) -> dict:
        """{group ranks: [entry, ...]}: the collectives themselves."""
        return {ranks: seq["entries"] for ranks, seq in self.groups.items()}


def parted(summaries, sequences=None):
    """The first group whose ranks issued different sequences, described,
    or None. `summaries[r]` is rank r's `CollectiveLog.summary()`; with
    `sequences` (each rank's `CollectiveLog.sequences()`) the description
    names the first collective at which the ranks differ."""
    groups = sorted({g for s in summaries for g in s})
    for ranks in groups:
        seen = {r: summaries[r].get(ranks, (0, hashlib.sha256().hexdigest())) for r in ranks}
        if len(set(seen.values())) == 1:
            continue
        text = f"group {list(ranks)}: " + ", ".join(
            f"rank {r} issued {n} collectives (sha256 {h[:12]})" for r, (n, h) in seen.items())
        if sequences is not None:
            seqs = {r: sequences[r].get(ranks, []) for r in ranks}
            at = next(i for i in range(max(map(len, seqs.values())) + 1)
                      if len({tuple(s[i:i + 1]) for s in seqs.values()}) > 1)
            text += f"; they part at collective #{at}: " + "; ".join(
                f"rank {r}: {s[at] if at < len(s) else '(none)'}" for r, s in seqs.items())
        return text
    return None


def _write(path: pathlib.Path, obj) -> None:
    """Pickle `obj` to `path` atomically (a reader never sees half a file)."""
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


def _watch(out: pathlib.Path, rank: int) -> None:
    """Exit as soon as another rank has written a failure: this rank's peers
    are gone or about to go, and its next collective would wait out gloo's
    timeout."""
    while True:
        if any(p.name != f"fail-rank{rank}.pkl" for p in out.glob("fail-rank*.pkl")):
            (out / f"stopped-rank{rank}").write_text(repr(time.time()))
            os._exit(3)
        time.sleep(0.2)


def _fail(out: pathlib.Path, rank: int, name: str, error: str, results: dict) -> None:
    results[name] = {"error": error}
    _write(out / f"rank{rank}.pkl", results)
    _write(out / f"fail-rank{rank}.pkl", {"time": time.time(), "rank": rank, "job": name,
                                          "error": error})
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(1)


# ------------------------------------------------------------ the world
class World(list):
    """Each rank's results, in rank order, and how the world ended:
    `first_error` (None when every job passed everywhere), and
    `seconds_after_failure`, from the first failure to the last rank's end
    (a rank the test process had to kill ends when it was killed)."""

    first_error = None
    seconds_after_failure = None


def start_world(tmp, world: int, jobs, wait_seconds: int = 900, timeout: int = 300):
    """Spawn a gloo world of `world` ranks of this script running `jobs`
    (in the test process); returns a function that waits for it, at most
    `wait_seconds` from the spawn, and gives a `World`. `timeout` is gloo's
    for one collective (an oversubscribed box may keep a peer away for
    tens of seconds; a failed job ends the world at once regardless)."""
    tmp = pathlib.Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    spec = {"world": world, "store": str(tmp / "store"), "out": str(tmp),
            "jobs": jobs, "timeout": timeout}
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    started = time.monotonic()
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(tmp / "spec.pkl"), str(r)],
                              env=env, stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]

    def wait() -> World:
        hung = failed_at = None
        while any(p.poll() is None for p in procs):
            if failed_at is None and (any(p.returncode not in (None, 0) for p in procs)
                                      or any(tmp.glob("fail-rank*.pkl"))):
                failed_at = time.monotonic()
            if failed_at is not None and time.monotonic() - failed_at > 10:
                break  # every rank's watchdog had time to see the failure
            if time.monotonic() - started > wait_seconds:
                hung = f"the world did not end within {wait_seconds} s of its spawn"
                break
            time.sleep(0.1)
        killed = [p.poll() is None for p in procs]
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
        return _collect(tmp, world, jobs, procs, hung, time.time() if any(killed) else None)

    return wait


def _collect(tmp: pathlib.Path, world: int, jobs, procs, hung, killed_at) -> World:
    """Each rank's results; every job from the first failure on holds that
    failure's text."""
    results = World()
    for r in range(world):
        path = tmp / f"rank{r}.pkl"
        results.append(pickle.loads(path.read_bytes()) if path.exists() else {"seconds": {}})
    failures = sorted((pickle.loads(p.read_bytes()) for p in tmp.glob("fail-rank*.pkl")),
                      key=lambda f: f["time"])
    if failures:
        first = failures[0]
        results.first_error = (f"job {first['job']!r} failed first, on rank {first['rank']}:"
                               f"\n{first['error']}")
        ends = [f["time"] for f in failures]
        ends += [float(p.read_text()) for p in tmp.glob("stopped-rank*")]
        results.seconds_after_failure = max(ends + [killed_at or 0.0]) - first["time"]
    elif hung or any(p.returncode for p in procs):
        bad = next((r for r, p in enumerate(procs) if p.returncode), 0)
        log = (tmp / f"rank{bad}.log").read_text(errors="replace")[-3000:]
        results.first_error = hung or (f"rank {bad} exited with code {procs[bad].returncode}"
                                       f" and wrote no failure:\n{log}")
    if results.first_error is not None:
        for res in results:
            for name, _ in jobs:
                if name not in res or "error" in res[name]:
                    res[name] = {"error": results.first_error}
    return results


def job(results, name):
    """One job's results of every rank; a rank's error fails the test."""
    out = [r[name] for r in results]
    for r, res in enumerate(out):
        assert "error" not in res, f"rank {r}: {res.get('error')}"
    return out


def assert_in_step(results) -> None:
    """Every rank of each group issued the same sequence of collectives in
    every job (the digests of `CollectiveLog`), and the world recorded some."""
    assert results.first_error is None, results.first_error
    logs = results[0]["collectives"]
    assert any(logs.values()), f"no job recorded a collective: {list(logs)}"
    for name in logs:
        summaries = [res["collectives"][name] for res in results]
        assert parted(summaries) is None, f"job {name!r}: {parted(summaries)}"


# ------------------------------------------------------------------- main
def main(spec_path: str, rank: int) -> None:
    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    out = pathlib.Path(spec["out"])
    timeout = datetime.timedelta(seconds=spec["timeout"])
    dist.init_process_group("gloo", store=dist.FileStore(spec["store"], spec["world"]),
                            rank=rank, world_size=spec["world"], timeout=timeout)
    guard = dist.new_group(backend="gloo", timeout=timeout)  # the agreements' own group
    threading.Thread(target=_watch, args=(out, rank), daemon=True).start()
    log = CollectiveLog()
    gather = log.originals["all_gather_object"]
    log.install()
    results = {"seconds": {}, "collectives": {}}
    for name, kwargs in spec["jobs"]:
        t0 = time.perf_counter()
        log.reset()
        try:
            results[name] = globals()[f"job_{name}"](**kwargs)
        except Exception:
            _fail(out, rank, name, f"rank {rank}: {traceback.format_exc()}", results)
        results["seconds"][name] = time.perf_counter() - t0
        results["collectives"][name] = log.summary()
        summaries = [None] * spec["world"]
        gather(summaries, log.summary(), group=guard)
        if parted(summaries) is not None:  # every rank finds the same
            sequences = [None] * spec["world"]
            gather(sequences, log.sequences(), group=guard)
            _fail(out, rank, name, "the ranks' collectives parted: "
                  + parted(summaries, sequences), results)
        _write(out / f"rank{rank}.pkl", results)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
