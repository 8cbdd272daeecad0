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
from cvaegan_tpu_torch.parallel import mesh as mesh_lib

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import torch_port_parallel_worker as worker  # noqa: E402
from torch_port_parallel_worker import job, start_world  # noqa: E402

TRAINERS = ["CVAEGAN", "TMGGAN", "CTGAN", "RAIN_GAN", "QG_SMOTE", "SNGAN",
            "CGAN", "CVAE", "VAEGAN", "GAN", "VAE"]
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
EPOCH_TOL = dict(rtol=5e-2, atol=5e-3)
STEP_BATCH, EPOCH_BATCH = 64, 32
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


def _step_inputs(jt, kind, key, class_id):
    """The global inputs the JAX step draws from `key` (its own split)."""
    cfg = jt.gan_cfg
    if kind == "g":
        k_x, k_eps, k_z, _, _ = jax.random.split(key, 5)
        x_real, y = jt._sample_batch(k_x, jt._data, class_id)
        return [np.array(a) for a in (
            x_real, y, jax.random.normal(k_z, (cfg.batch_size, cfg.z_size)),
            jax.random.normal(k_eps, (cfg.batch_size, cfg.z_size)))]
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


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, blob_dataset):
    """The 4-rank and the uneven 3-rank world, their JAX steps and the
    port's single-process epochs."""
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
        root = tmp_path_factory.mktemp("worlds")
        wait4 = start_world(root / "w4", 4, [
            ("mesh_basics", dict(tree=tree, x=x, y=y)), step_job,
            ("epochs", dict(names=TRAINERS, x=x, y=y, batch_size=EPOCH_BATCH)),
            ("epoch_2x2", dict(x=x, y=y, batch_size=EPOCH_BATCH))])
        wait3 = start_world(root / "w3", 3, [step_job])
        # while the worlds run: the JAX steps on 3 devices (the same masks)
        for kind, (key, class_id) in steps.items():
            jax_steps[3, kind] = _jax_step(jt, state, kind, key, class_id, 3, mp)
            assert all(np.array_equal(a, b) for a, b in zip(jax_steps[3, kind][2],
                                                            masks[kind]))
        torch.set_num_threads(1)
        single = {name: worker.one_epoch(name, x, y, EPOCH_BATCH, None) for name in TRAINERS}
        jax_specs = jmesh.shard_net_state(state, jmesh.make_mesh(2, 2))
        yield {4: wait4(), 3: wait3(), "jax": jax_steps, "single": single,
               "jax_specs": jax_specs, "tree": tree}
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


# ----------------------------------------------------------------- epochs
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
