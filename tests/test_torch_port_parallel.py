"""The port's data-parallel layer (`cvaegan_tpu_torch/parallel/`) against
the JAX package's (`cvaegan_tpu/parallel/`, `tests/test_parallel.py`).

Each module-scoped world is one gloo process group of CPU ranks, spawned
once (`torch_port_parallel_worker.py`, FileStore rendezvous under the
test's temporary directory, one torch thread per rank); the tests read
its results. The JAX side runs here, on conftest's 8 virtual CPU
devices, and arrays travel as numpy.

  * mesh construction, `shard_leading`, the JAX package's errors, and
    `shard_net_state`'s specs equal JAX's for a converted CVAE-GAN state
    (the 'model' axis itself: `test_torch_port_tensor_parallel.py`);
  * the CVAE-GAN's D, C and E+G steps on one fixed global batch of 64 rows
    (and the same dropout keep-masks, served to Flax's
    `jax.random.bernoulli` and to each rank's slice of them), on 4 ranks
    and on an uneven 3-rank world (shards of 22, 22, 20 rows), against
    the JAX step under `use_mesh(make_mesh(n, 1))` from the same weights,
    at rtol 1e-5, atol 1e-6, as `test_torch_port_training.py` holds the
    single-device steps;
  * one epoch of every trainer on 4 ranks against the port's
    single-process epoch from the same seed, at the JAX package's own
    band for its sharded epoch (`tests/test_parallel.py:87-88`: rtol 5e-2,
    atol 5e-3), with every rank's state bitwise equal to every other's.
    Both start from the same drawn Adam moments: from a real first step's
    near-zero v, Adam divides the float32 noise of exactly-zero gradients
    by its eps, and a critic's loss drifts apart in one epoch under any
    change of summation order (RAIN-GAN's adversarial loss, measured:
    -2.14 single-process against -0.27 on 4 ranks from the real first
    step; 11.9117 against 11.9115 from drawn moments);
  * a 2x2 mesh with replicated parameters (the data group's wiring);
  * `distributed.initialize` in loopback, in a subprocess.
"""

import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from cvaegan_tpu import CVAEGAN as JaxCVAEGAN
from cvaegan_tpu.core import config as jconfig
from cvaegan_tpu.parallel import mesh as jmesh
from cvaegan_tpu_torch.core.schedules import progressive_lambda
from cvaegan_tpu_torch.parallel import mesh as mesh_lib

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import torch_port_parallel_worker as worker  # noqa: E402
from test_torch_port_bf16 import BF16_TOL  # noqa: E402
from test_torch_port_bf16_zoo import ANCHOR_KEYS, assert_anchored, gate_misses  # noqa: E402
from torch_port_parallel_worker import job, start_world  # noqa: E402

TRAINERS = ["CVAEGAN", "TMGGAN", "CTGAN", "RAIN_GAN", "QG_SMOTE", "SNGAN",
            "CGAN", "CVAE", "VAEGAN", "GAN", "VAE"]
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
EPOCH_TOL = dict(rtol=5e-2, atol=5e-3)
STEP_BATCH, EPOCH_BATCH = 64, 32
#: the trainers whose epoch runs under the bf16 policy on the 4 data ranks
BF16_EPOCHS = ["RAIN_GAN"]
#: relative nudges of the single-process bf16 epoch's parameters, of one
#: to ten float32 roundings, whose epochs span the chaotic losses' band
#: (`assert_bf16_epoch_close`)
BF16_NUDGES = (0.0, 1e-7, 2e-7, 1e-6)
EPOCH = 350.0  # inside the lambda_class ramp


# ------------------------------------------------------------ JAX side
def _tree(state):
    """A JAX trainer state as plain nested numpy dicts, Adam state included."""
    tree = {}
    for name, ns in state.items():
        adam_state = ns.opt_state[0]
        tree[name] = jax.device_get({
            "params": ns.params, **ns.mutables,
            "opt_state": {"count": adam_state.count, "mu": adam_state.mu,
                          "nu": adam_state.nu}})
    return tree


def _warm(jt):
    """The JAX trainer's state after one D, C and G step (BatchNorm
    statistics and u/v off their initial values), with drawn Adam
    moments (count 3, |mu| < 2e-4, nu in [1e-8, 1e-6])."""
    data, state = jt._data, jt.state
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    state, _ = jax.jit(lambda s, k: jt._d_step(s, data, 1, k))(state, keys[0])
    state, _ = jax.jit(lambda s, k: jt._c_step(s, data, 1, k))(state, keys[1])
    state, _ = jax.jit(lambda s, k: jt._g_step(s, data, 1, jnp.float32(EPOCH), k))(
        state, keys[2])
    rng = np.random.default_rng(5)
    for name, ns in state.items():
        adam_state, *rest = ns.opt_state
        adam_state = adam_state._replace(
            count=jnp.int32(3),
            mu=jax.tree.map(lambda a: jnp.asarray(rng.uniform(-2e-4, 2e-4, a.shape),
                                                  jnp.float32), adam_state.mu),
            nu=jax.tree.map(lambda a: jnp.asarray(rng.uniform(1e-8, 1e-6, a.shape),
                                                  jnp.float32), adam_state.nu))
        state[name] = ns.replace(opt_state=(adam_state, *rest))
    return state


def _step_inputs(jt, kind, key, class_id, eps_dtype=jnp.float32):
    """The global inputs the JAX step draws from `key` (its own split); eps
    in `eps_dtype`, the activations' dtype (as float32 values)."""
    cfg = jt.gan_cfg
    if kind == "g":
        k_x, k_eps, k_z, _, _ = jax.random.split(key, 5)
        x_real, y = jt._sample_batch(k_x, jt._data, class_id)
        return [np.array(a) for a in (
            x_real, y, jax.random.normal(k_z, (cfg.batch_size, cfg.z_size)),
            jax.random.normal(k_eps, (cfg.batch_size, cfg.z_size), eps_dtype).astype(
                jnp.float32))]
    k_x, k_z, _, _ = jax.random.split(key, 4)
    x_real, y = jt._sample_batch(k_x, jt._data, class_id)
    return [np.array(a) for a in (
        x_real, y, jax.random.normal(k_z, (cfg.batch_size, cfg.z_size)))]


def _jax_step(jt, state, kind, key, class_id, n, monkeypatch):
    """The JAX step under `use_mesh(make_mesh(n, 1))` on replicated state
    and data; Flax's dropout draws numpy keep-masks, returned in call
    order (the same for every n: the generator restarts)."""
    rng, masks = np.random.default_rng(11), []

    def bernoulli(key, p=0.5, shape=None):
        masks.append(rng.random(shape) < p)
        return jnp.asarray(masks[-1])

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    mesh = jmesh.make_mesh(n, 1)
    put = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: jax.device_put(a, NamedSharding(mesh, P())), tree)
    step = {"d": jt._d_step, "c": jt._c_step,
            "g": lambda s, d, c, k: jt._g_step(s, d, c, jnp.float32(EPOCH), k)}[kind]
    with jmesh.use_mesh(mesh):
        new_state, loss = jax.jit(lambda s, d, k: step(s, d, class_id, k))(
            put(state), put(jt._data), key)
    monkeypatch.undo()
    return jax.device_get(new_state), jax.device_get(loss), masks


def _exact_step(tree, x, y, kind, inputs, masks):
    """The port's CVAE-GAN step in float64 under no policy, single process,
    on the global inputs and keep-masks: the bf16 steps' yardstick
    (`tests/test_torch_port_bf16.py`). Returns (state as `state_of`, loss)."""
    from cvaegan_tpu_torch import CVAEGAN
    from cvaegan_tpu_torch.core import losses as tlosses
    from cvaegan_tpu_torch.models import layers as tl

    port = CVAEGAN(seed=0, device="cpu", settings=worker.settings(STEP_BATCH))
    port._prepare((x, y))
    port.load_jax_state(tree)
    port.state.double()
    for opt in port.optimizers.values():
        opt.m, opt.v = [m.double() for m in opt.m], [v.double() for v in opt.v]
    queue = list(masks)
    t = [torch.from_numpy(np.asarray(a, np.float64 if a.dtype.kind == "f" else None))
         for a in inputs]
    with pytest.MonkeyPatch.context() as mp, tl.dtype_override(torch.float32):
        mp.setattr(tl, "_keep_mask", lambda x_, keep_prob, generator:
                   torch.from_numpy(queue.pop(0)))
        mp.setattr(tlosses, "_f32", lambda *xs: xs[0] if len(xs) == 1 else xs)
        if kind == "g":
            lam = progressive_lambda(torch.tensor(EPOCH, dtype=torch.float64), 0.5, 200, 500)
            loss = {k: float(v) for k, v in port._g_step(t[0], t[1].long(), t[2], t[3],
                                                         lam).items()}
        else:
            loss = float((port._d_step if kind == "d" else port._c_step)(
                t[0], t[1].long(), t[2]))
    assert not queue
    return worker.state_of(port), loss


def bf16_epochs(name, x, y):
    """The port's single-process bf16 epoch of `name`, from the state of
    `worker.one_epoch` and from that state nudged by each of BF16_NUDGES."""
    return [worker.one_epoch(name, x, y, EPOCH_BATCH, None, dtype="bfloat16", nudge=n)
            for n in BF16_NUDGES]


def assert_bf16_epoch_close(losses, epochs):
    """A bf16 epoch's losses against the single-process bf16 `epochs`
    (`bf16_epochs`): each loss the unnudged epoch holds within EPOCH_TOL
    of the nudged ones agrees with it at EPOCH_TOL; a chaotic loss, one
    that a nudge of one to ten float32 roundings moves past EPOCH_TOL
    (RAIN-GAN's adversarial loss under bf16: 10.5 moves to 8.625 at 2e-7,
    its critic's bf16 scores near 10 round in steps of 1/16), lies within
    EPOCH_TOL of the span of the nudged epochs."""
    base = epochs[0]["losses"]
    chaotic = 0
    for k, v in base.items():
        spread = [e["losses"][k] for e in epochs]
        lo, hi = min(spread), max(spread)
        band = EPOCH_TOL["atol"] + EPOCH_TOL["rtol"] * abs(v)
        if hi - lo <= band:
            np.testing.assert_allclose(losses[k], v, err_msg=k, **EPOCH_TOL)
            continue
        chaotic += 1
        margin = EPOCH_TOL["atol"] + EPOCH_TOL["rtol"] * max(abs(lo), abs(hi))
        assert lo - margin <= losses[k] <= hi + margin, (k, losses[k], spread)
    assert chaotic < len(base), "every loss moved under the nudges"


def _jax_steps_again(jt, state, kind, steps, n):
    """`_jax_step` of the step `kind` at the other keys of `steps` (those
    named `kind` + a suffix), from the one compiled step the first
    `_jax_step` of `kind` traced: its keep-masks are constants of it, the
    same at every key. Returns {name: (new state, loss, masks)}."""
    rng, masks = np.random.default_rng(11), []

    def bernoulli(key, p=0.5, shape=None):
        masks.append(rng.random(shape) < p)
        return jnp.asarray(masks[-1])

    mesh = jmesh.make_mesh(n, 1)
    put = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: jax.device_put(a, NamedSharding(mesh, P())), tree)
    step = {"d": jt._d_step, "c": jt._c_step,
            "g": lambda s, d, c, k: jt._g_step(s, d, c, jnp.float32(EPOCH), k)}[kind]
    out = {}
    with pytest.MonkeyPatch.context() as mp, jmesh.use_mesh(mesh):
        mp.setattr(jax.random, "bernoulli", bernoulli)
        compiled = {}
        for name, (key, class_id) in steps.items():
            if name[0] != kind or name == kind:
                continue
            if class_id not in compiled:
                compiled[class_id] = jax.jit(lambda s, d, k, c=class_id: step(s, d, c, k))
            new_state, loss = compiled[class_id](put(state), put(jt._data), key)
            out[name] = (jax.device_get(new_state), jax.device_get(loss), list(masks))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, blob_dataset):
    """The 4-rank and the uneven 3-rank world, their JAX steps (float32,
    and bf16 on 4 devices with the float64 steps that measure them) and
    the port's single-process epochs."""
    mp = pytest.MonkeyPatch()
    old_batch = jconfig.settings.gan.batch_size
    jconfig.settings.gan.batch_size = STEP_BATCH
    try:
        jt = JaxCVAEGAN(seed=0)
        jt.verbose = False
        jt._prepare(blob_dataset)
        state = _warm(jt)
        tree = _tree(state)
        x, y = blob_dataset.tr_samples, blob_dataset.tr_labels
        steps = {"d": (jax.random.PRNGKey(21), 3), "c": (jax.random.PRNGKey(23), 1),
                 "g": (jax.random.PRNGKey(22), 2)}
        inputs = {kind: _step_inputs(jt, kind, *steps[kind]) for kind in steps}
        jax_steps = {(4, kind): _jax_step(jt, state, kind, key, class_id, 4, mp)
                     for kind, (key, class_id) in steps.items()}
        masks = {kind: jax_steps[4, kind][2] for kind in steps}
        step_job = ("cvaegan_steps", dict(tree=tree, x=x, y=y, batch_size=STEP_BATCH,
                                          inputs=inputs, masks=masks, epoch=EPOCH))
        jconfig.settings.gan.compute_dtype = "bfloat16"
        try:
            steps16 = {**steps, **{f"d{i}": (jax.random.PRNGKey(21 + 100 * i), 3)
                                   for i in range(1, ANCHOR_KEYS)}}
            inputs16 = {kind: _step_inputs(jt, kind[0], *steps16[kind], eps_dtype=jnp.bfloat16)
                        for kind in steps16}
            jax_bf16 = {kind: _jax_step(jt, state, kind, key, class_id, 4, mp)
                        for kind, (key, class_id) in steps.items()}
            jax_bf16.update(_jax_steps_again(jt, state, "d", steps16, 4))
        finally:
            jconfig.settings.gan.compute_dtype = "float32"
        masks16 = {kind: jax_bf16[kind][2] for kind in steps16}
        root = tmp_path_factory.mktemp("worlds")
        wait4 = start_world(root / "w4", 4, [
            ("mesh_basics", dict(tree=tree, x=x, y=y)), step_job,
            ("epochs", dict(names=TRAINERS, x=x, y=y, batch_size=EPOCH_BATCH)),
            ("epoch_2x2", dict(x=x, y=y, batch_size=EPOCH_BATCH)),
            ("cvaegan_steps_bf16", dict(tree=tree, x=x, y=y, batch_size=STEP_BATCH,
                                        inputs=inputs16, masks=masks16, epoch=EPOCH)),
            ("epochs_bf16", dict(names=BF16_EPOCHS, x=x, y=y, batch_size=EPOCH_BATCH))])
        wait3 = start_world(root / "w3", 3, [step_job])
        # while the worlds run: the JAX steps on 3 devices (the same masks)
        for kind, (key, class_id) in steps.items():
            jax_steps[3, kind] = _jax_step(jt, state, kind, key, class_id, 3, mp)
            assert all(np.array_equal(a, b) for a, b in zip(jax_steps[3, kind][2],
                                                            masks[kind]))
        torch.set_num_threads(1)
        single = {name: worker.one_epoch(name, x, y, EPOCH_BATCH, None) for name in TRAINERS}
        single_bf16 = {name: bf16_epochs(name, x, y) for name in BF16_EPOCHS}
        exact16 = {kind: _exact_step(tree, x, y, kind[0], inputs16[kind], masks16[kind])
                   for kind in steps16}
        jax_specs = jmesh.shard_net_state(state, jmesh.make_mesh(2, 2))
        yield {4: wait4(), 3: wait3(), "jax": jax_steps, "single": single,
               "jax_specs": jax_specs, "tree": tree, "jax_bf16": jax_bf16,
               "exact_bf16": exact16, "single_bf16": single_bf16}
    finally:
        jconfig.settings.gan.batch_size = old_batch
        mp.undo()


@pytest.mark.parametrize("n", [4, 3])
def test_ranks_issue_the_same_collectives(worlds, n):
    """In every job, every rank of each process group issued the same
    sequence of collectives (op, group, dtypes and shapes)."""
    worker.assert_in_step(worlds[n])


# ------------------------------------------------------------------ mesh
def test_shard_leading_noop_without_mesh():
    x = torch.ones(8, 4)
    assert mesh_lib.current_mesh() is None
    assert mesh_lib.shard_leading(x) is x
    assert mesh_lib.local_rows(x) is x
    assert mesh_lib.batch_layout() is None


def test_shard_net_state_specs_of_a_mapping():
    """`tests/test_parallel.py::test_shard_net_state_specs` on the port:
    a mapping's leaves get the same specs by shape (the mesh's sizes are
    all `shard_net_state` reads)."""
    from test_torch_port_seed_bank import _Grid

    mesh = mesh_lib.Mesh(_Grid(4, 2))
    assert mesh.shape == {"data": 4, "model": 2}
    state = {"kernel": torch.zeros(30, 256), "odd_kernel": torch.zeros(30, 31),
             "scale": torch.zeros(128), "count": torch.zeros(()),
             "nested": {"bias": np.zeros(6, np.float32)}, "step": 3}
    got = {k: v.spec for k, v in mesh_lib.shard_net_state(state, mesh).items()
           if k != "nested"}
    assert got == {"kernel": P(None, "model"), "odd_kernel": P(), "scale": P("model"),
                   "count": P(), "step": P()}
    assert mesh_lib.shard_net_state(state, mesh)["nested"]["bias"].spec == P("model")
    assert mesh_lib.replicated(mesh).spec == P()
    assert mesh_lib.shard_net_state(state, mesh_lib.Mesh(_Grid(8, 1)))["kernel"].spec == P()


def test_entry_points_refuse_without_their_backend():
    """`make_mesh` needs a process group, and `initialize` on CUDA a card:
    neither falls back to a single device or the CPU."""
    import torch.distributed as dist

    from cvaegan_tpu_torch.parallel import distributed

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        mesh_lib.make_mesh(1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            distributed.initialize(coordinator_address="127.0.0.1:1", num_processes=1,
                                   process_id=0)
    with pytest.raises(ValueError, match="num_processes and process_id"):
        distributed.initialize(coordinator_address="127.0.0.1:1", device="cpu")
    assert not dist.is_initialized() and not distributed.is_multi_host()


def test_make_mesh_shapes_and_errors(worlds):
    out = job(worlds[4], "mesh_basics")
    for r, res in enumerate(out):
        assert res["world_mesh"] == res["global_mesh"] == {"data": 4, "model": 1}
        assert res["mesh_2x2"] == res["global_mesh_2"] == {"data": 2, "model": 2}
        assert res["coords"] == (r // 2, r % 2)
        assert res["too_many"] == "mesh needs 128 devices, found 4"
        assert "does not divide" in res["bad_model"]
        assert res["current"] and res["after"]
        assert res["multi_host"] is False
        assert res["shard_8"] == [2 * r, 2 * r + 1]
    # ceil-sized shards: 6 rows would be 2, 2, 2 and none, 2 rows 1, 1, none
    # and none: every rank raises, not only those left without rows
    for res in out:
        assert "leaves data rank 3 of 4 without rows" in res["shard_6"]
        assert "leaves data rank 3 of 4 without rows" in res["shard_2"]


def test_shard_net_state_specs_equal_jax(worlds):
    """The same per-leaf specs as JAX's for the same weights on a mesh of
    'model' 2 (a Dense kernel `[in, out]` whose out divides 2 is
    P(None, 'model'), a 1-D leaf P('model'), the rest P())."""
    out = job(worlds[4], "mesh_basics")
    assert all(res["specs"] == out[0]["specs"] for res in out)
    specs, jax_specs = out[0]["specs"], worlds["jax_specs"]
    n = 0
    for net, leaves in specs.items():
        ns = jax_specs[net]
        tree = {"params": ns.params, **ns.mutables}
        for path, spec in leaves.items():
            node = tree
            for k in path.split("/"):
                node = node[k]
            assert spec == tuple(node.spec), (net, path)
            n += 1
    assert n == sum(len(jax.tree.leaves({"params": jax_specs[net].params,
                                         **jax_specs[net].mutables})) for net in specs)
    assert {s for leaves in specs.values() for s in leaves.values()} == {
        (), (None, "model"), ("model",)}


# ----------------------------------------------------------------- steps
def _lookup(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


@pytest.mark.parametrize("n", [4, 3])
@pytest.mark.parametrize("kind", ["d", "c", "g"])
def test_cvaegan_step_matches_jax_mesh(worlds, n, kind):
    out = job(worlds[n], "cvaegan_steps")
    new_state, loss, _ = worlds["jax"][n, kind]
    rows = [res[kind]["rows"] for res in out]
    assert sum(rows) == STEP_BATCH and rows == ([16] * 4 if n == 4 else [22, 22, 20])
    assert len({res[kind]["digest"] for res in out}) == 1, "ranks differ"
    got = out[0][kind]
    if kind == "g":
        for k, v in got["loss"].items():
            np.testing.assert_allclose(v, np.asarray(loss[k]), err_msg=k, **STEP_TOL)
    else:
        np.testing.assert_allclose(got["loss"], np.asarray(loss), **STEP_TOL)
    tree = _tree(new_state)
    for key, value in got["state"].items():
        name, _, rest = key.partition("/")
        if key.endswith("#count"):
            assert value == int(tree[key.split("#")[0]]["opt_state"]["count"]), key
            continue
        path, _, moment = rest.partition("#")
        path = tuple(path.split("/"))
        want = (_lookup(tree[name]["opt_state"][moment], path[1:]) if moment
                else _lookup(tree[name], path))
        np.testing.assert_allclose(value, want, err_msg=key, **STEP_TOL)


@pytest.mark.parametrize("kind", ["d", "c", "g"])
def test_cvaegan_bf16_step_on_mesh_as_exact_as_jax(worlds, kind):
    """The D, C and E+G steps under the bf16 policy on 4 data ranks, held as
    the single-process bf16 steps are (`tests/test_torch_port_bf16_zoo.py`)
    to JAX's bf16 step under `use_mesh(make_mesh(4, 1))`: losses within
    BF16_TOL of JAX's, every tensor float32 (counts int), and each as exact
    as JAX's against the single-process float64 step on the same global
    inputs and keep-masks (eps drawn in bf16, as JAX draws it). The D step
    misses that gate at its own key on one tensor (the critic's last bias:
    2.3x JAX's error), where JAX's C and E+G steps miss the mirrored gate
    on three: it is held over ANCHOR_KEYS keys by `assert_anchored`, as the
    single-process ANCHORED steps are (ROADMAP C9)."""
    out = job(worlds[4], "cvaegan_steps_bf16")
    names = [kind] + ([f"d{i}" for i in range(1, ANCHOR_KEYS)] if kind == "d" else [])
    per_key = []
    for step in names:
        new_state, loss, _ = worlds["jax_bf16"][step]
        exact, exact_loss = worlds["exact_bf16"][step]
        assert [res[step]["rows"] for res in out] == [16] * 4
        assert len({res[step]["digest"] for res in out}) == 1, "ranks differ"
        got = out[0][step]
        losses = ({k: (got["loss"][k], float(loss[k]), exact_loss[k]) for k in got["loss"]}
                  if kind == "g" else {"loss": (got["loss"], float(loss), exact_loss)})
        if len(names) == 1:
            for g, w, _ in losses.values():
                assert abs(g - w) <= BF16_TOL["atol"] + BF16_TOL["rtol"] * abs(w), (g, w)
        errors = {f"loss {k}": (abs(g - e), abs(w - e), abs(e)) for k, (g, w, e) in losses.items()}
        state, tree = got["state"], _tree(new_state)
        assert state.keys() == exact.keys()
        for key in state:
            name, _, rest = key.partition("/")
            if key.endswith("#count"):
                assert state[key] == exact[key] == int(
                    tree[name.split("#")[0]]["opt_state"]["count"]), key
                continue
            path, _, moment = rest.partition("#")
            path = tuple(path.split("/"))
            want = (_lookup(tree[name]["opt_state"][moment], path[1:]) if moment
                    else _lookup(tree[name], path))
            assert state[key].dtype == np.float32, key
            e = np.asarray(exact[key], np.float64)
            errors[key] = (float(np.abs(state[key] - e).max()),
                           float(np.abs(np.asarray(want, np.float64) - e).max()),
                           float(np.abs(e).max()))
        per_key.append(errors)
    if len(per_key) == 1:
        for key, errs in per_key[0].items():
            if not key.startswith("loss "):
                assert not gate_misses(*errs)[0], (key, errs)
    else:
        assert_anchored(per_key)


# ----------------------------------------------------------------- epochs
@pytest.mark.parametrize("name", BF16_EPOCHS)
def test_bf16_epoch_matches_single_process(worlds, name):
    """One epoch under the bf16 policy on 4 data ranks against the
    single-process bf16 epoch, at the float32 epochs' band where the
    single process holds it under nudges of its parameters
    (`assert_bf16_epoch_close`); every rank's state bitwise equal."""
    out = job(worlds[4], "epochs_bf16")
    assert len({res[name]["digest"] for res in out}) == 1, "ranks differ"
    assert_bf16_epoch_close(out[0][name]["losses"], worlds["single_bf16"][name])
    assert out[0]["collectives"] > 0


@pytest.mark.parametrize("name", TRAINERS)
def test_epoch_matches_single_process(worlds, name):
    """One epoch on 4 data ranks (batch 32: 8 rows each) against the
    single-process epoch; every rank ends in the same state, bitwise."""
    out = job(worlds[4], "epochs")
    single = worlds["single"][name]
    assert len({res[name]["digest"] for res in out}) == 1, "ranks differ"
    assert all(res[name]["losses"] == out[0][name]["losses"] for res in out)
    for k, v in single["losses"].items():
        np.testing.assert_allclose(out[0][name]["losses"][k], v, err_msg=k, **EPOCH_TOL)
    assert out[0]["collectives"] > 0


def test_epoch_on_2x2_mesh(worlds):
    """A ('data' 2, 'model' 2) mesh with replicated parameters: gradients
    and BatchNorm moments are summed over the data group only, so the
    epoch is the 2-rank data-parallel one, and all 4 ranks agree."""
    out = job(worlds[4], "epoch_2x2")
    single = worlds["single"]["CVAEGAN"]
    assert len({res["digest"] for res in out}) == 1, "ranks differ"
    for k, v in single["losses"].items():
        np.testing.assert_allclose(out[0]["losses"][k], v, err_msg=k, **EPOCH_TOL)


# ------------------------------------------------------------- loopback
def test_distributed_initialize_loopback(tmp_path):
    """`distributed.initialize` joins a 1-process gloo group at an
    explicit coordinator address, and from torchrun's environment, and
    the global mesh trains an epoch (the loopback form of a multi-host
    run, as `tests/test_parallel.py:171-223`)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = textwrap.dedent(f"""
        import numpy as np, torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        from cvaegan_tpu_torch import CVAEGAN
        from cvaegan_tpu_torch.core import config as tconfig
        from cvaegan_tpu_torch.parallel import distributed, mesh as mesh_lib
        distributed.initialize(coordinator_address="127.0.0.1:{port}",
                               num_processes=1, process_id=0, device="cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert not distributed.is_multi_host()
        mesh = distributed.global_mesh()
        assert mesh.shape == {{"data": 1, "model": 1}}
        s = tconfig.Settings()
        s.gan.epochs, s.gan.batch_size = 1, 16
        rng = np.random.default_rng(0)
        x = rng.random((100, 6), dtype=np.float32)
        y = (np.arange(100) % 3).astype(np.int32)
        m = CVAEGAN(seed=0, device="cpu", settings=s)
        m.verbose = False
        mesh_lib.COLLECTIVES = 0
        with mesh_lib.use_mesh(mesh):
            m.fit((x, y))
        assert mesh_lib.COLLECTIVES > 0
        assert all(np.isfinite(v).all() for v in m.loss_history.values())
        dist.destroy_process_group()
        import os
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT="{port}", RANK="0",
                          WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1")
        distributed.initialize(device="cpu")
        assert distributed.global_mesh().shape == {{"data": 1, "model": 1}}
        assert not distributed.is_multi_host()
        dist.destroy_process_group()
        print("LOOPBACK_OK")
    """)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=240, env=env, cwd=pathlib.Path(__file__).parent.parent)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOOPBACK_OK" in r.stdout
