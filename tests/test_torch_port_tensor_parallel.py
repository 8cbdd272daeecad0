"""The port's tensor parallelism over the mesh's 'model' axis
(`cvaegan_tpu_torch/parallel/mesh.py`: `place`, the 'model' collectives;
`models/layers.py`) against the JAX package's (`cvaegan_tpu/parallel/
mesh.py`, `tests/test_parallel.py`).

Two module-scoped gloo worlds of CPU ranks, spawned once
(`torch_port_parallel_worker.py`, one torch thread per rank): 8 ranks as a
('data' 4, 'model' 2) mesh, and 2 ranks as a (1, 2) one for the exact
checks. The JAX side runs here, on conftest's 8 virtual CPU devices, and
arrays travel as numpy.

  * `shard_net_state`'s specs equal JAX's leaf by leaf for every trainer,
    TMG-GAN's stacked generators included (a generator's Dense kernel
    replicated, its bias and BatchNorm leaves sharded);
  * `place` leaves on each rank exactly the JAX shard of every leaf and
    Adam moment on the device of the same mesh coordinates
    (`jax.device_put(..., NamedSharding)`, `addressable_shards`), for a
    converted CVAE-GAN and TMG-GAN; `gather_leaf` gives the whole leaf;
  * the CVAE-GAN's D, C and E+G steps on 4x2 against JAX's under
    `use_mesh(make_mesh(4, 2))` on a state placed with `shard_net_state`,
    gathered, at rtol 1e-5, atol 1e-6; SpectralDense's u, v and sigma
    after 5 train forwards against the single process at the same band;
  * one epoch of every trainer on the (1, 2) world and of the four
    hardest (CVAE-GAN, TMG-GAN, CTGAN, RAIN-GAN) on 4x2 (all eleven on 8
    ranks would take about twice the module's budget), against the
    port's single-process epoch at the JAX package's band (rtol 5e-2,
    atol 5e-3), ranks of one model coordinate bitwise equal, the gathered
    states of all ranks bitwise equal;
  * 3-epoch fits on 4x2 (one step of each kind per class round: a smoke
    of the fit, whose epochs the tests above hold) followed by qualified
    sampling; the serving entry
    points on a (1, 2)-placed CVAE-GAN against the single process; the
    capture key across `place`; a checkpoint saved placed and restored in
    this process; a seed bank on 4x2.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import cvaegan_tpu
import cvaegan_tpu_torch
from cvaegan_tpu.core import config as jconfig
from cvaegan_tpu.parallel import mesh as jmesh
from cvaegan_tpu_torch.parallel import mesh as mesh_lib
from cvaegan_tpu_torch.utils import checkpoint

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import torch_port_parallel_worker as worker  # noqa: E402
from test_torch_port_parallel import (  # noqa: E402
    EPOCH,
    assert_bf16_epoch_close,
    bf16_epochs,
    EPOCH_TOL,
    STEP_TOL,
    TRAINERS,
    _lookup,
    _step_inputs,
    _tree,
    _warm,
)
from test_torch_port_seed_bank import _Grid  # noqa: E402
from torch_port_parallel_worker import job, start_world  # noqa: E402

HARDEST = ["CVAEGAN", "TMGGAN", "CTGAN", "RAIN_GAN"]
#: the trainers whose placed epoch runs under the bf16 policy on (1, 2)
BF16_EPOCHS = ["RAIN_GAN"]
#: the streamed corpus: windows of STREAM_WINDOW rows (the second without
#: class 2), STREAM_EPOCHS epochs each, batch STREAM_BATCH over 2 data ranks
STREAM_WINDOW, STREAM_EPOCHS, STREAM_BATCH = 120, 2, 16
FITS = ["CVAEGAN", "TMGGAN", "CTGAN", "QG_SMOTE"]
STEP_BATCH, EPOCH_BATCH, FIT_EPOCHS = 64, 32, 3
BANK_SEEDS = [0, 1, 2, 3]


# ------------------------------------------------------------ JAX side
def _drawn(state, seed=5):
    """A JAX trainer state with numpy-drawn Adam moments (count kept)."""
    rng = np.random.default_rng(seed)
    for name, ns in state.items():
        adam_state, *rest = ns.opt_state
        adam_state = adam_state._replace(
            mu=jax.tree.map(lambda a: jnp.asarray(rng.uniform(-2e-4, 2e-4, a.shape),
                                                  jnp.float32), adam_state.mu),
            nu=jax.tree.map(lambda a: jnp.asarray(rng.uniform(1e-8, 1e-6, a.shape),
                                                  jnp.float32), adam_state.nu))
        state[name] = ns.replace(opt_state=(adam_state, *rest))
    return state


def _jax_tp_step(jt, state, kind, key, class_id, mp):
    """The JAX step under `use_mesh(make_mesh(4, 2))` on a state placed
    with `shard_net_state` and replicated data; Flax's dropout draws
    numpy keep-masks, returned in call order."""
    rng, masks = np.random.default_rng(11), []

    def bernoulli(key, p=0.5, shape=None):
        masks.append(rng.random(shape) < p)
        return jnp.asarray(masks[-1])

    mp.setattr(jax.random, "bernoulli", bernoulli)
    mesh = jmesh.make_mesh(4, 2)
    placed = jmesh.place(state, jmesh.shard_net_state(state, mesh))
    data = jax.tree.map(lambda a: jax.device_put(a, NamedSharding(mesh, P())), jt._data)
    step = {"d": jt._d_step, "c": jt._c_step,
            "g": lambda s, d, c, k: jt._g_step(s, d, c, jnp.float32(EPOCH), k)}[kind]
    with jmesh.use_mesh(mesh):
        new_state, loss = jax.jit(lambda s, d, k: step(s, d, class_id, k))(placed, data, key)
    mp.undo()
    return jax.device_get(new_state), jax.device_get(loss), masks


def _jax_trainer(name, blob_dataset):
    jt = getattr(cvaegan_tpu, name)(seed=0)
    jt.verbose = False
    jt._prepare(blob_dataset)
    return jt


def _stream_corpus(path, blob_dataset):
    """Two windows of the blob rows as a CSV pair (x, one-hot y) written
    with numpy, the second window without class 2, and a last window of
    half the rows."""
    x, y = blob_dataset.tr_samples, blob_dataset.tr_labels
    first = np.arange(STREAM_WINDOW)
    second = np.nonzero(y != 2)[0][STREAM_WINDOW:2 * STREAM_WINDOW]
    rows = np.concatenate([first, second])
    path.mkdir(parents=True)
    np.savetxt(path / "x.csv", x[rows], delimiter=",", fmt="%.9g")
    np.savetxt(path / "y.csv", np.eye(5, dtype=np.int64)[y[rows]], delimiter=",", fmt="%d")
    return str(path / "x.csv"), str(path / "y.csv")


@pytest.fixture(scope="module")
def tp(tmp_path_factory, blob_dataset):
    """Both worlds' results, the JAX steps and states, and the port's
    single-process epochs."""
    mp = pytest.MonkeyPatch()
    old_batch = jconfig.settings.gan.batch_size
    jconfig.settings.gan.batch_size = STEP_BATCH
    old_threads = torch.get_num_threads()
    try:
        jt = _jax_trainer("CVAEGAN", blob_dataset)
        state = _warm(jt)
        tree = _tree(state)
        tmg = _drawn(_jax_trainer("TMGGAN", blob_dataset).state)
        trees = {"CVAEGAN": tree, "TMGGAN": _tree(tmg)}
        x, y = blob_dataset.tr_samples, blob_dataset.tr_labels
        steps = {"d": (jax.random.PRNGKey(21), 3), "c": (jax.random.PRNGKey(23), 1),
                 "g": (jax.random.PRNGKey(22), 2)}
        inputs = {kind: _step_inputs(jt, kind, *steps[kind]) for kind in steps}
        jax_steps = {kind: _jax_tp_step(jt, state, kind, key, class_id, mp)
                     for kind, (key, class_id) in steps.items()}
        masks = {kind: jax_steps[kind][2] for kind in steps}
        root = tmp_path_factory.mktemp("tp")
        bx = np.random.default_rng(0).random((200, 12), dtype=np.float32)
        by = (np.arange(200) % 5).astype(np.int32)
        wait8 = start_world(root / "w8", 8, [
            ("tp_place", dict(trees=trees, x=x, y=y)),
            ("tp_steps", dict(tree=tree, x=x, y=y, batch_size=STEP_BATCH, inputs=inputs,
                              masks=masks, epoch=EPOCH)),
            ("tp_spectral", dict(forwards=5)),
            ("tp_epochs", dict(names=HARDEST, x=x, y=y, batch_size=EPOCH_BATCH)),
            ("tp_fits", dict(names=FITS, x=x, y=y, batch_size=EPOCH_BATCH,
                             epochs=FIT_EPOCHS, loops=1)),
            ("seed_bank", dict(x=bx, y=by, batch_size=16, seeds=BANK_SEEDS, epochs=1,
                               n_model=2))])
        ckpt = root / "ckpt"
        corpus = _stream_corpus(root / "corpus", blob_dataset)
        stream = dict(window_rows=STREAM_WINDOW, batch_size=STREAM_BATCH,
                      epochs=STREAM_EPOCHS)
        wait2 = start_world(root / "w2", 2, [
            ("tp_epochs", dict(names=TRAINERS, x=x, y=y, batch_size=EPOCH_BATCH)),
            ("tp_serving", dict(tree=tree, x=x, y=y)),
            ("tp_capture_key", dict(x=x, y=y, batch_size=EPOCH_BATCH, ckpt=str(ckpt))),
            ("tp_epochs_bf16", dict(names=BF16_EPOCHS, x=x, y=y, batch_size=EPOCH_BATCH)),
            ("streamed", dict(x_csv=corpus[0], y_csv=corpus[1], **stream))])
        torch.set_num_threads(1)
        # while the worlds run: the specs of every trainer, both packages
        specs = {name: (_port_specs(name, x, y),
                        jmesh.shard_net_state(_jax_trainer(name, blob_dataset).state,
                                              jmesh.make_mesh(4, 2)))
                 for name in TRAINERS}
        single = {name: worker.one_epoch(name, x, y, EPOCH_BATCH, None) for name in TRAINERS}
        single_bf16 = {name: bf16_epochs(name, x, y) for name in BF16_EPOCHS}
        streamed = {mode: worker.streamed_fit(*corpus, STREAM_WINDOW, STREAM_BATCH,
                                              STREAM_EPOCHS, None, balanced=mode == "balanced")
                    for mode in ("strict", "balanced")}
        worlds = {8: wait8(), 2: wait2()}
        print("job seconds:", {w: res[0]["seconds"] for w, res in worlds.items()})
        yield {**worlds, "specs": specs, "jax": jax_steps, "single": single, "ckpt": ckpt,
               "trees": trees, "jax_states": {"CVAEGAN": state, "TMGGAN": tmg},
               "single_bf16": single_bf16, "streamed": streamed}
    finally:
        jconfig.settings.gan.batch_size = old_batch
        torch.set_num_threads(old_threads)
        mp.undo()


@pytest.mark.parametrize("world", [8, 2])
def test_ranks_issue_the_same_collectives(tp, world):
    """In every job, every rank of each process group issued the same
    sequence of collectives (op, group, dtypes and shapes)."""
    worker.assert_in_step(tp[world])


# ----------------------------------------------------------------- specs
def _jax_leaves(ns):
    return {"params": ns.params, **ns.mutables}


def _port_specs(name, x, y):
    port = getattr(cvaegan_tpu_torch, name)(seed=0, device="cpu",
                                            settings=worker.settings(EPOCH_BATCH))
    port._prepare((x, y))
    return mesh_lib.shard_net_state(port.state, mesh_lib.Mesh(_Grid(4, 2)))


@pytest.mark.parametrize("name", TRAINERS)
def test_shard_net_state_specs_equal_jax(tp, name):
    """For every trainer, the spec of each leaf equals JAX's for the same
    shapes on a 4x2 mesh; a TMG-GAN generator's is JAX's stacked spec
    without its leading axis (fault C5: the port read each generator's own
    shapes and sharded its kernels)."""
    specs, jax_specs = tp["specs"][name]
    covered = {}
    for net, leaves in specs.items():
        jname, _, member = net.partition(".")
        tree = _jax_leaves(jax_specs[jname])
        for path, sharding in leaves.items():
            node = tree
            for k in path:
                node = node[k]
            want = tuple(node.spec)[1:] if member else tuple(node.spec)
            assert tuple(sharding.spec) == want, (net, path)
            covered[jname, path] = True
    assert len(covered) == sum(len(jax.tree.leaves(_jax_leaves(jax_specs[n])))
                               for n in jax_specs)
    if name == "TMGGAN":
        gen = specs["gens.0"]
        assert gen["params", "MLPTrunk_0", "Dense_0", "kernel"].spec == P()
        assert gen["params", "MLPTrunk_0", "Dense_0", "bias"].spec == P("model")
        assert gen["batch_stats", "MLPTrunk_0", "BatchNorm_0", "BatchNorm_0",
                   "mean"].spec == P("model")


# ----------------------------------------------------------------- place
def _jax_shard(leaf, spec, rank):
    """The shard of `leaf` on the device at the 4x2 mesh's coordinates of
    port rank `rank` (data rank // 2, model rank % 2)."""
    mesh = jmesh.make_mesh(4, 2)
    arr = jax.device_put(jnp.asarray(leaf), NamedSharding(mesh, spec))
    device = mesh.devices[rank // 2, rank % 2]
    (shard,) = [s for s in arr.addressable_shards if s.device == device]
    return np.asarray(leaf)[shard.index]


@pytest.mark.parametrize("name", ["CVAEGAN", "TMGGAN"])
def test_place_holds_each_rank_jax_shard(tp, name):
    """Each rank holds, of every leaf and Adam moment, exactly the JAX
    shard of its device; `gather_leaf` gives the whole leaf; counts stay
    whole."""
    out = job(tp[8], "tp_place")
    state = tp["jax_states"][name]
    specs = jmesh.shard_net_state(state, jmesh.make_mesh(4, 2))
    tree = tp["trees"][name]
    sharded = 0
    for key in out[0][name]["local"]:
        net, _, rest = key.partition("/")
        path, _, moment = rest.partition("#")
        jname, _, member = net.partition(".")
        path = tuple(path.split("/"))
        ns = specs[jname]
        if moment:
            spec = _lookup_spec(ns.opt_state[0].mu, path[1:])
            leaf = _lookup(tree[jname]["opt_state"][moment], path[1:])
        else:
            spec = _lookup_spec(_jax_leaves(ns), path)
            leaf = _lookup(tree[jname], path)
        if member:  # one generator of the stack: its entry, its spec's tail
            leaf, spec = leaf[int(member)], P(*tuple(spec)[1:])
        sharded += "model" in spec
        for r, res in enumerate(out):
            np.testing.assert_array_equal(res[name]["local"][key], _jax_shard(leaf, spec, r),
                                          err_msg=f"{key} on rank {r}")
            np.testing.assert_array_equal(res[name]["whole"][key], leaf, err_msg=key)
    assert sharded > 10
    for res in out:
        assert res[name]["shards"] > 10
        assert res[name]["synced_unchanged"], "a fit's sync overwrote a rank's slices"
        counts = tree["gens"]["opt_state"]["count"] if name == "TMGGAN" else None
        for k, v in res[name]["counts"].items():
            want = (counts[int(k.split(".")[1])] if k.startswith("gens.")
                    else tree[k]["opt_state"]["count"])
            assert v == int(want), k


def _lookup_spec(tree, path):
    for key in path:
        tree = tree[key]
    return tree.spec


def test_place_replicated_specs_mappings_and_refusals(tp):
    """Replicated specs make every rank hold the first rank's state (the
    ranks' states differed before); a mapping of tensors is placed by key
    (its kernel `[in, out]` by output columns, as JAX's `device_put`);
    a parameter spec naming 'data' is refused before any leaf changes."""
    out = job(tp[8], "tp_place")
    assert len({res["replicated"] for res in out}) == 1
    kernel, scale = np.arange(24.0).reshape(4, 6), np.arange(8.0)
    for r, res in enumerate(out):
        got = res["mapping"]
        np.testing.assert_array_equal(got["kernel"], _jax_shard(kernel, P(None, "model"), r))
        np.testing.assert_array_equal(got["scale"], _jax_shard(scale, P("model"), r))
        np.testing.assert_array_equal(got["whole"], kernel)
        assert got["odd"] == (4, 3)
        assert "over one axis of 'model'" in res["data_spec"]


# ----------------------------------------------------------------- steps
@pytest.mark.parametrize("kind", ["d", "c", "g"])
def test_cvaegan_step_on_4x2_matches_jax(tp, kind):
    out = job(tp[8], "tp_steps")
    new_state, loss, _ = tp["jax"][kind]
    assert [res[kind]["rows"] for res in out] == [16] * 8
    assert len({res[kind]["whole"] for res in out}) == 1, "gathered states differ"
    for m in range(2):
        assert len({res[kind]["local"] for res in out[m::2]}) == 1, f"model rank {m}"
    got = out[0][kind]
    if kind == "g":
        for k, v in got["loss"].items():
            np.testing.assert_allclose(v, np.asarray(loss[k]), err_msg=k, **STEP_TOL)
    else:
        np.testing.assert_allclose(got["loss"], np.asarray(loss), **STEP_TOL)
    tree = _tree(new_state)
    for key, value in got["state"].items():
        name, _, rest = key.partition("/")
        path, _, moment = rest.partition("#")
        path = tuple(path.split("/"))
        want = (_lookup(tree[name]["opt_state"][moment], path[1:]) if moment
                else _lookup(tree[name], path))
        np.testing.assert_allclose(value, want, err_msg=key, **STEP_TOL)
    for name, count in got["counts"].items():
        assert count == int(tree[name]["opt_state"]["count"]), name


def test_spectral_dense_sliced_matches_single_process(tp):
    """Rows and v sliced (8 -> 16), weight replicated with v sliced
    (64 -> 1), rows sliced with v whole (35 -> 4): u, v and sigma after 5
    train forwards, the outputs and the weight's gradient (of a loss whose
    gradients are of order 1), gathered, against an unplaced copy."""
    out = job(tp[8], "tp_spectral")
    want_sliced = {(8, 16): (True, True, True), (64, 1): (False, False, True),
                   (35, 4): (True, True, False)}
    for dims, sliced in want_sliced.items():
        res = out[0][dims]
        assert tuple(res["sliced"][k] for k in ("weight", "u", "v")) == sliced, dims
        for k in ("u", "v", "sigma", "train_out", "eval_out", "grad"):
            np.testing.assert_allclose(res["placed"][k], res["plain"][k],
                                       err_msg=f"{dims} {k}", **STEP_TOL)
        for other in out[1:]:
            np.testing.assert_array_equal(other[dims]["placed"]["u"], res["placed"]["u"])


# ----------------------------------------------------------------- epochs
def _check_epochs(tp, world, name, dtype="float32"):
    bf16 = dtype == "bfloat16"
    out = job(tp[world], "tp_epochs_bf16" if bf16 else "tp_epochs")
    single = tp["single"][name]
    assert len({res[name]["whole"] for res in out}) == 1, "gathered states differ"
    for m in range(2):
        assert len({res[name]["digest"] for res in out[m::2]}) == 1, f"model rank {m}"
    assert all(res[name]["losses"] == out[0][name]["losses"] for res in out)
    if bf16:
        assert_bf16_epoch_close(out[0][name]["losses"], tp["single_bf16"][name])
    else:
        for k, v in single["losses"].items():
            np.testing.assert_allclose(out[0][name]["losses"][k], v, err_msg=k, **EPOCH_TOL)
    assert out[0]["collectives"] > 0


@pytest.mark.parametrize("name", TRAINERS)
def test_epoch_on_1x2_matches_single_process(tp, name):
    _check_epochs(tp, 2, name)


@pytest.mark.parametrize("name", HARDEST)
def test_epoch_on_4x2_matches_single_process(tp, name):
    _check_epochs(tp, 8, name)


@pytest.mark.parametrize("name", BF16_EPOCHS)
def test_bf16_epoch_on_1x2_matches_single_process(tp, name):
    """One placed epoch under the bf16 policy on (1, 2) against the
    single-process bf16 epoch, at the float32 epochs' band where the single
    process holds it under nudges (`assert_bf16_epoch_close`)."""
    _check_epochs(tp, 2, name, dtype="bfloat16")


# -------------------------------------------------------------- streamed
def _close(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k], np.float64), np.asarray(b[k], np.float64),
                                   err_msg=f"{what} {k}", **EPOCH_TOL)


@pytest.mark.parametrize("mode", ["strict", "balanced"])
def test_streamed_fit_on_2_data_ranks_matches_single_process(tp, mode):
    """`fit_streamed` of two windows (the second without class 2: strict
    rounds leave it out, balanced labels are drawn over the four present
    classes, and a rank's 8 rows of a batch need not hold each) on 2 data
    ranks whose trainers are of seeds 0 and 1: the first window's
    `_sync_ranks` (once, and only then) gives rank 1 rank 0's networks,
    Adam state and generator, bitwise, which are the single process's;
    after each window both ranks are bitwise equal, and their state and
    loss history agree with the single-process streamed fit at the
    epochs' band."""
    out = job(tp[2], "streamed")
    single = tp["streamed"][mode]
    assert single["syncs"] == 0 and len(single["windows"]) == single["n_windows"] == 2
    assert [res[mode]["syncs"] for res in out] == [1, 1]
    assert {res[mode]["synced"] for res in out} == {single["synced"]}
    for w in range(2):
        assert len({res[mode]["windows"][w]["digest"] for res in out}) == 1, f"window {w}"
        got, want = out[0][mode]["windows"][w], single["windows"][w]
        assert all(len(v) == (w + 1) * STREAM_EPOCHS for v in got["history"].values())
        _close(got["history"], want["history"], f"window {w} history")
        _close(got["state"], want["state"], f"window {w} state")


def test_streamed_fit_with_an_empty_data_shard_raises(tp):
    """A batch of 1 row on 2 data ranks leaves rank 1 no rows: where JAX
    pads the empty shard, the port raises on every rank (ROADMAP C, "Under
    a mesh"), after the first window's sync and before any collective of
    the epoch, so no rank is left waiting."""
    for res in job(tp[2], "streamed"):
        assert "leaves data rank 1 of 2 without rows" in res["empty_shard"]


# ----------------------------------------------------------- fits, serving
@pytest.mark.parametrize("name", FITS)
def test_fit_on_4x2_then_qualified_samples(tp, name, blob_dataset):
    out = job(tp[8], "tp_fits")
    for res in out:
        assert res[name]["history"] == out[0][name]["history"]
        for k, v in res[name]["history"].items():
            assert len(v) == FIT_EPOCHS and np.isfinite(v).all(), k
        q = res[name]["qualified"]
        assert q.shape[1:] == (blob_dataset.feature_num,) and np.isfinite(q).all()
        np.testing.assert_array_equal(q, out[0][name]["qualified"])
    if name == "TMGGAN":  # its filter falls back to arbitrary rows: always 8
        assert out[0][name]["qualified"].shape[0] == 8


def test_serving_on_placed_state_matches_single_process(tp):
    """`generate_samples`, `reconstruct_samples` and `generate_samples_fast`
    (B1's plain version on the CPU) on a (1, 2)-placed CVAE-GAN against an
    unplaced one from the same generator state; the placed fast path keeps
    its gathered fold."""
    out = job(tp[2], "tp_serving")
    for res in out:
        placed, plain = res["placed"], res["plain"]
        for k in ("samples", "reconstructed", "fast", "fast_again"):
            assert placed[k].shape == plain[k].shape and np.isfinite(placed[k]).all(), k
            np.testing.assert_allclose(placed[k], plain[k], err_msg=k, **STEP_TOL)
        assert placed["cached_fold"] and not plain["cached_fold"]
    np.testing.assert_array_equal(out[0]["placed"]["fast"], out[1]["placed"]["fast"])


def test_capture_key_carries_the_placement(tp):
    """A fit, `place`, a fit: the key changes, the capture made before the
    placement is dropped and the second fit captures anew (on sliced
    shapes); a third run keeps the placed capture."""
    for res in job(tp[2], "tp_capture_key"):
        assert res["key_changed"] and not res["stale_kept"]
        first, second = res["captures"]
        assert len(first) == len(second) and first != second


def test_checkpoint_saved_placed_restores_in_one_process(tp, blob_dataset):
    """Saved on the (1, 2) world from a placed state: whole leaves, which a
    single process restores bitwise; restored into a placed trainer, each
    rank gets back its slices."""
    out = job(tp[2], "tp_capture_key")
    assert all(res["restored_local_equal"] for res in out)
    model = cvaegan_tpu_torch.CVAEGAN(seed=1, device="cpu",
                                      settings=worker.settings(EPOCH_BATCH))
    model.verbose = False
    checkpoint.restore_checkpoint(model, tp["ckpt"], (blob_dataset.tr_samples,
                                                      blob_dataset.tr_labels))
    got = worker._flax_leaves(model)
    assert got.keys() == out[0]["whole"].keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v, out[0]["whole"][k], err_msg=k)


def test_seed_bank_splits_seeds_over_data_only(tp):
    """On 4x2 the bank's replicas go over 'data' only: each data rank holds
    one seed, and the model ranks of one data coordinate hold the same
    replica, bitwise (the JAX bank replicates over 'model')."""
    out = job(tp[8], "seed_bank")
    assert [res["held"] for res in out] == [[s] for s in BANK_SEEDS for _ in range(2)]
    for d in range(4):
        assert out[2 * d]["held_digests"] == out[2 * d + 1]["held_digests"]
    assert len({tuple(res["digests"]) for res in out}) == 1


# ------------------------------------------------------------------ slow
@pytest.mark.slow
@pytest.mark.parametrize("name", FITS)
def test_sharded_full_fit_parity(tmp_path, name, blob_dataset):
    """`tests/test_parallel.py::test_sharded_full_fit_parity` on the port:
    a 50-epoch fit placed on 4x2 against the single process, the first
    epoch at the band, the mean of the last 10 epochs statistically."""
    x, y = blob_dataset.tr_samples, blob_dataset.tr_labels
    wait = start_world(tmp_path / "w", 8, [("tp_fits", dict(
        names=[name], x=x, y=y, batch_size=EPOCH_BATCH, epochs=50))], wait_seconds=1800)
    model = getattr(cvaegan_tpu_torch, name)(seed=0, device="cpu",
                                            settings=worker.settings(EPOCH_BATCH, 50))
    model.verbose = False
    model.fit((x, y))
    sharded = job(wait(), "tp_fits")[0][name]["history"]
    for k, u in model.loss_history.items():
        s, u = np.asarray(sharded[k]), np.asarray(u)
        assert s.shape == u.shape == (50,) and np.isfinite(s).all()
        np.testing.assert_allclose(s[0], u[0], err_msg=f"epoch-0 {k}", **EPOCH_TOL)
        ms, mu = s[-10:].mean(), u[-10:].mean()
        assert abs(ms - mu) <= max(0.1, 0.5 * max(abs(ms), abs(mu))), k
