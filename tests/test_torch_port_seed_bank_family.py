"""The port's SeedBank of RAIN-GAN, SNGAN, CTGAN, QG-SMOTE and TMG-GAN.

A bank of K = 2 replicas against the JAX package and against the port's
own serial trainers:

  (a) each network of the five trainers, stacked as a banked network from
      two replicas loaded from JAX parameters, against `jax.vmap` of the
      Flax `apply` over the two replicas' stacked variables, in train and
      eval mode: outputs, new BatchNorm statistics and new spectral u/v;
  (b) `layers.state_frozen` reaches the banked layers: under it a train
      forward moves no running statistic and no u/v, as the serial layers;
  (c) one banked step of every kind (D, C and G; QG-SMOTE's regressor
      step; TMG-GAN's CD, G and diversity steps) against `jax.vmap` of the
      JAX trainer's own step over the two replicas' stacked states, each
      replica fed the inputs its own key gives in the serial step tests
      (`_steps` of `tests/test_torch_port_{sngan_ctgan,qg_smote,tmg_gan}.py`,
      RAIN-GAN's as `tests/test_torch_port_rain_training.py` builds them);
  (d) banked class rounds against the serial trainers, the second replica
      lacking the class of the second round;
  (e) 3-epoch bank fits against serial fits;
  (f) bank mode runs no chunk hook; (g) a TMG-GAN bank refuses
      `balanced_mode`, as its trainer does.

The JAX states are built as the serial step tests build theirs (BatchNorm
statistics and Adam moments drawn by numpy, spectral u/v drawn and then
power-iterated), one per replica from trainers of seeds 0 and 1, so the
replicas differ in every tensor. Dropout keep-masks are fed to both
sides: Flax draws one per call site under `jax.vmap`, shared by the two
replicas, and the banked layers take it broadcast over K. Tolerances are
those of the serial tests: rtol 1e-5, atol 1e-6 (TOL), RAIN-GAN at atol
1e-5 (NET_TOL), CTGAN's D step GP_TOL, QG-SMOTE's E+G step G_TOL and
TMG-GAN's diversity step DIV_TOL, each justified there by a float64 run
(ROADMAP §C).

The fits of (d) and (e) start from drawn Adam moments, as
`tests/test_torch_port_seed_bank.py` explains: from a real first step
Adam turns the rounding of batched against unbatched matmuls into
parameter moves of ~lr. They run one step of each kind per class round
(`*_loop_num` 1) at batch 16, which keeps the file fast; epoch 0 is held
at rtol 1e-3, atol 1e-4 and every epoch to the JAX bank test's drift band,
rtol 0.35, atol 0.02 (`tests/test_seed_bank.py:61-70`).
"""

import copy
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_family import TOL, _normal, _t, _tree, _warm_state
from test_torch_port_layers import _assert_state
from test_torch_port_qg_smote import G_TOL, errors_over_tol
from test_torch_port_qg_smote import _steps as qg_steps
from test_torch_port_seed_bank import _draw_moments, _fixture, _settings, _tensors, data_mesh
from test_torch_port_sngan_ctgan import GP_TOL, _assert_state_matches, power_iterated
from test_torch_port_sngan_ctgan import _steps as sngan_ctgan_steps
from test_torch_port_tmg_gan import DIV_TOL, GEN_COUNTS
from test_torch_port_tmg_gan import _assert_state_matches as tmg_assert_state_matches
from test_torch_port_tmg_gan import _steps as tmg_steps

import cvaegan_tpu
import cvaegan_tpu_torch
from cvaegan_tpu_torch.algorithms.seed_bank import SeedBank
from cvaegan_tpu_torch.kernels import block_attention as tba
from cvaegan_tpu_torch.models import banked
from cvaegan_tpu_torch.models.layers import forward_with, state_frozen

NET_TOL = dict(rtol=1e-5, atol=1e-5)
#: a fit's epoch 0, bank against serial, from drawn moments
FIT_TOL = dict(rtol=1e-3, atol=1e-4)
SEEDS = [3, 11]
EPOCH = 350.0
CLASS_ID = 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


class _Masks(list):
    """The keep-masks Flax drew and the port has not taken yet; `replay()`
    queues every mask drawn so far again, for a second port run."""

    def __init__(self):
        super().__init__()
        self.drawn = []

    def replay(self):
        self[:] = self.drawn


@pytest.fixture
def masks(monkeypatch):
    """The same dropout keep-masks for Flax and the banked networks, in call
    order. Under `jax.vmap` Flax draws one mask per call site, at one
    replica's shape, and both replicas use it; the port's mask is taken at
    that shape and broadcast over K."""
    rng = np.random.default_rng(11)
    queue = _Masks()

    def bernoulli(key, p=0.5, shape=None):
        queue.drawn.append(rng.random(shape) < p)
        queue.append(queue.drawn[-1])
        return jnp.asarray(queue[-1])

    def keep_mask(x, keep_prob, generator):
        mask = queue.pop(0)
        assert mask.shape == tuple(x.shape[1:])
        return torch.from_numpy(mask)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    monkeypatch.setattr(banked, "_keep_mask", keep_mask)
    return queue


def _row(tree, k):
    return jax.tree.map(lambda a: a[k], tree)


_TWINS = {}


def _scaled_params(state, seed):
    """`state` with every parameter scaled by 1 + 0.1 n, n standard normal
    drawn by numpy: a second replica that differs in every weight."""
    rng = np.random.default_rng(seed)

    def scale(p):
        return jnp.asarray(p * (1.0 + 0.1 * rng.standard_normal(np.shape(p))), jnp.float32)

    return {name: ns.replace(params=jax.tree.map(scale, ns.params))
            for name, ns in state.items()}


def twins(name, blob_dataset):
    """(the JAX trainer, the two replicas' JAX states, those stacked on a
    leading axis, their numpy trees), built once per trainer from one JAX
    trainer of seed 0: replica k's state is made warm as the serial step
    tests make theirs, from numpy seed 60 + k, replica 1's parameters
    scaled by `_scaled_params` before its u/v are power-iterated (TMG-GAN:
    its generators' Adam counts GEN_COUNTS, reversed for replica 1)."""
    if name not in _TWINS:
        jt = getattr(cvaegan_tpu, name)(seed=0)
        jt.verbose = False
        jt._prepare(blob_dataset)
        states = []
        for k in range(2):
            state = _warm_state(jt, 60 + k)
            if k:
                state = _scaled_params(state, 70)
            state = power_iterated(state)
            if name == "TMGGAN":
                gens = state["gens"]
                adam_state, *rest = gens.opt_state
                counts = GEN_COUNTS if k == 0 else GEN_COUNTS[::-1]
                adam_state = adam_state._replace(count=jnp.asarray(counts, jnp.int32))
                state["gens"] = gens.replace(opt_state=(adam_state, *rest))
            states.append(state)
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
        _TWINS[name] = (jt, states, stacked, [_tree(s) for s in states])
    return _TWINS[name]


def loaded_bank(name, blob_dataset, datasets=None, balanced=False):
    """A SeedBank of the two replicas, each trainer loaded from its JAX
    tree and prepared on its dataset (the blob fixture unless given), and
    its banked trainer."""
    _, _, _, trees = twins(name, blob_dataset)
    datasets = datasets or [(blob_dataset.tr_samples, blob_dataset.tr_labels)] * 2
    bank = SeedBank(getattr(cvaegan_tpu_torch, name), [0, 1], device="cpu",
                    balanced_mode=balanced)
    for t, tree, ds in zip(bank.trainers, trees, datasets):
        t._prepare(ds)
        t.load_jax_state(tree)
    return bank, bank._load()


# ----------------------------------------------------------------- networks
N = 48


def _inputs(name, net, jt, seed):
    """One replica's forward inputs (numpy), as the trainer's steps give
    them: rows, labels, z, CTGAN's column masks."""
    rng = np.random.default_rng(300 + seed)
    x = rng.random((N, jt.feature_num), dtype=np.float32)
    y = rng.integers(0, jt.label_num, N).astype(np.int32)
    z = rng.standard_normal((N, jt.gan_cfg.z_size)).astype(np.float32)
    mask = np.eye(jt.feature_num, dtype=np.float32)[rng.integers(0, jt.feature_num, N)]
    takes_z = net == "generator"
    if name == "TMGGAN":
        return (z,) if takes_z else (x,)
    if net == "classifier":
        return (x,)
    if name == "CTGAN" and net in ("generator", "discriminator"):
        return (z if takes_z else x, y, mask)
    return (z if takes_z else x, y)


NETWORKS = [(n, net) for n, nets in (
    ("RAIN_GAN", ("encoder", "generator", "discriminator", "classifier")),
    ("SNGAN", ("generator", "discriminator", "classifier")),
    ("CTGAN", ("generator", "discriminator", "classifier")),
    ("QG_SMOTE", ("encoder", "regressor")),
    ("TMGGAN", ("cd", "generator"))) for net in nets]
#: TMG-GAN's generator under test: class 1's of the stacked bank
TMG_GEN = 1


def _flax_variables(name, net, state):
    if name == "TMGGAN" and net == "generator":
        gens = state["gens"]
        return jax.tree.map(lambda a: a[TMG_GEN], {"params": gens.params, **gens.mutables})
    return {"params": state[net].params, **state[net].mutables}


def _port_net(name, net, trainer):
    if name == "TMGGAN" and net == "generator":
        return trainer.state["gens"][TMG_GEN]
    return trainer.state[net]


def _leaves(out):
    return [t for part in (out if isinstance(out, tuple) else (out,))
            for t in (_leaves(part) if isinstance(part, tuple) else [part])]


def _tensors_of(args, dtype=torch.float32):
    return [torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a).to(dtype)
            for a in args]


def _network_runs(name, net, train, blob_dataset):
    """(the vmapped Flax forward's outputs and new mutables, the two
    replicas' variables, the banked network, its replicas' port networks,
    its inputs): the Flax forward has run, the banked one not yet."""
    jt, states, _, _ = twins(name, blob_dataset)
    module = jt.modules[net]
    variables = [_flax_variables(name, net, s) for s in states]
    stacked_vars = jax.tree.map(lambda *xs: jnp.stack(xs), *variables)
    args = [np.stack(parts) for parts in zip(*(_inputs(name, net, jt, k) for k in range(2)))]
    mutable = [k for k in variables[0] if k != "params"]

    def apply(v, *a):
        if train:
            return module.apply(v, *a, train=True, rngs={"dropout": jax.random.PRNGKey(1)},
                                mutable=mutable)
        return module.apply(v, *a, train=False), {}

    want, new_mut = jax.vmap(apply)(stacked_vars, *(jnp.asarray(a) for a in args))
    bank, _ = loaded_bank(name, blob_dataset)
    nets = [_port_net(name, net, t) for t in bank.trainers]
    return (jax.tree.leaves(want), new_mut), variables, banked.stack(nets).train(train), nets, args


def _banked_forward(stacked, inputs):
    with torch.no_grad():
        return _leaves(forward_with(
            stacked, *inputs, generator=banked.ReplicaGenerators([torch.Generator()] * 2, "cpu")))


#: train-mode forwards whose BatchNorm normalises the batch of a spectral
#: layer's outputs: both packages' float32 outputs lie beyond rtol 1e-5,
#: atol 1e-6 of float64 (`test_batchnorm_forwards_against_float64`)
BN_TOL = dict(rtol=1e-5, atol=5e-6)
BN_FORWARDS = [("SNGAN", "generator"), ("CTGAN", "discriminator")]


def _network_tol(name, net, train):
    if name == "RAIN_GAN":
        return NET_TOL
    return BN_TOL if train and (name, net) in BN_FORWARDS else TOL


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name,net", NETWORKS)
def test_banked_network_matches_vmapped_flax(name, net, train, masks, blob_dataset):
    """A banked network of two replicas loaded from JAX parameters against
    `jax.vmap` of its Flax module's `apply` over the stacked variables:
    every output (RAIN's attention probabilities included), and in train
    mode each replica's new BatchNorm statistics and u/v (eval mode: its
    state unchanged), handed back by `banked.store`."""
    (want, new_mut), variables, stacked, nets, args = _network_runs(
        name, net, train, blob_dataset)
    got = _banked_forward(stacked, _tensors_of(args))
    assert not masks
    tol = _network_tol(name, net, train)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    copies = [copy.deepcopy(n) for n in nets]
    banked.store(stacked, copies)
    for k, c in enumerate(copies):
        _assert_state(c, {**variables[k], **jax.device_get(_row(dict(new_mut), k))})


def _errors_over(outputs, reference, tol):
    return max(float((np.abs(np.asarray(o, np.float64) - r.numpy())
                      / (tol["atol"] + tol["rtol"] * np.abs(r.numpy()))).max())
               for o, r in zip(outputs, reference))


@pytest.mark.parametrize("name,net", BN_FORWARDS)
def test_batchnorm_forwards_against_float64(name, net, masks, blob_dataset):
    """Why BN_TOL: the banked network run in float64 (same inputs, same
    keep-masks) is the reference; the banked float32 forward and the JAX
    package's lie within BN_TOL of it, and one of them beyond rtol 1e-5,
    atol 1e-6."""
    (want, _), _, stacked, _, args = _network_runs(name, net, True, blob_dataset)
    stacked64 = copy.deepcopy(stacked).double()
    got = _banked_forward(stacked, _tensors_of(args))
    masks.replay()
    exact = _banked_forward(stacked64, _tensors_of(args, torch.float64))
    assert not masks
    errors = [_errors_over([g.numpy() for g in got], exact, tol) for tol in (TOL, BN_TOL)]
    jax_errors = [_errors_over(want, exact, tol) for tol in (TOL, BN_TOL)]
    assert max(errors[0], jax_errors[0]) > 1.0, (errors, jax_errors)
    assert max(errors[1], jax_errors[1]) <= 1.0, (errors, jax_errors)


def test_banked_attention_on_the_kernel_path_keeps_the_replica_axis():
    """A banked attention block whose input `[K, b, seq, dim]` takes the
    kernel path (forced here: on the CPU the kernel's wrapper runs its plain
    version) folds the replica axis into the kernel's batch: each
    replica's output and row entropies `[K, b, h, seq]` are its serial
    block's on the same path, and its output the dense path's."""
    from cvaegan_tpu_torch.models.attention import ResidualAttentionBlock

    g = torch.Generator().manual_seed(1)
    blocks = [ResidualAttentionBlock(64, 32) for _ in range(2)]
    with torch.no_grad():
        for block in blocks:
            for p in block.parameters():
                p.normal_(0.0, p.shape[-1] ** -0.5 if p.dim() == 2 else 0.1, generator=g)
            block.attention.use_kernel = True
    stacked = banked.stack(blocks).eval()
    x = torch.randn(2, 3, 128, 64, generator=g)
    with torch.no_grad():
        out, stats = stacked(x)
        assert stats.value.shape == (2, 3, 4, 128)
        for k, block in enumerate(blocks):
            want, want_stats = block.eval()(x[k])
            np.testing.assert_allclose(out[k].numpy(), want.numpy(), **NET_TOL)
            np.testing.assert_allclose(stats.value[k].numpy(), want_stats.value.numpy(),
                                       **NET_TOL)
            block.attention.use_kernel = False
            dense, _ = block(x[k])
            np.testing.assert_allclose(out[k].numpy(), dense.numpy(), **NET_TOL)


FROZEN = [("CTGAN", "discriminator"), ("CTGAN", "generator"), ("SNGAN", "generator"),
          ("RAIN_GAN", "discriminator"), ("QG_SMOTE", "encoder"), ("TMGGAN", "cd")]


@pytest.mark.parametrize("name,net", FROZEN)
def test_state_frozen_reaches_banked_layers(name, net, blob_dataset):
    """Under `state_frozen` a banked train forward keeps batch statistics,
    dropout and the current u/v but moves no running statistic and no u/v,
    and gives each replica what its serial network gives under
    `state_frozen`; the layers update again after the block."""
    jt, _, _, _ = twins(name, blob_dataset)
    bank, _ = loaded_bank(name, blob_dataset)
    nets = [_port_net(name, net, t).train() for t in bank.trainers]
    stacked = banked.stack(nets).train()
    inputs = _tensors_of([np.stack(parts) for parts in
                          zip(*(_inputs(name, net, jt, k) for k in range(2)))])
    rg = banked.ReplicaGenerators([torch.Generator().manual_seed(s) for s in (5, 6)], "cpu")
    gens = [torch.Generator().manual_seed(s) for s in (5, 6)]
    before = {k: v.clone() for k, v in stacked.state_dict().items()}
    with state_frozen(stacked), torch.no_grad():
        got = _leaves(forward_with(stacked, *inputs, generator=rg))
    for k, v in stacked.state_dict().items():
        assert torch.equal(v, before[k]), k
    layers = [m for m in stacked.modules() if hasattr(m, "update_state")]
    assert layers and all(m.update_state for m in layers)
    for k, serial in enumerate(nets):
        with state_frozen(serial), torch.no_grad():
            want = _leaves(forward_with(serial, *(a[k] for a in inputs), generator=gens[k]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[k].numpy(), w.numpy(),
                                       **_network_tol(name, net, True))
    with torch.no_grad():
        forward_with(stacked, *inputs, generator=rg)
    assert any(not torch.equal(v, before[k]) for k, v in stacked.state_dict().items()
               if not k.endswith(("weight", "bias")))


# -------------------------------------------------------------------- steps
class _Call(NamedTuple):
    method: str
    args: tuple


class _Recorder:
    """Stands in for a port trainer in the serial tests' `_steps`: each step
    or draw method it is asked for returns the call (method, arguments)
    instead of running, so one replica's inputs can be read off."""

    def __init__(self, port):
        self._lambda_class = port._lambda_class

    def __getattr__(self, method):
        return lambda *args: _Call(method, args)


def _rain_steps(kind, jt, port, key):
    """RAIN-GAN's step inputs from `key`, as
    `tests/test_torch_port_rain_training.py::test_steps_match_jax` draws them."""
    data = jt._data
    if kind == "g":
        k_x, k_eps, k_z = jax.random.split(key, 3)
        x, y, eps, z = _t(*jt._sample_batch(k_x, data, CLASS_ID), _normal(jt, k_eps),
                          _normal(jt, k_z))
        lam = port._lambda_class(torch.tensor(EPOCH))
        return (lambda s, k: jt._g_step(s, data, CLASS_ID, jnp.float32(EPOCH), k),
                lambda: port._g_step(x, y.long(), z, eps, lam))
    k_x, k_z = jax.random.split(key)
    x, y, z = _t(*jt._sample_batch(k_x, data, CLASS_ID), _normal(jt, k_z))
    step = jt._d_step if kind == "d" else jt._c_step
    port_step = port._d_step if kind == "d" else port._c_step
    return lambda s, k: step(s, data, CLASS_ID, k), lambda: port_step(x, y.long(), z)


def _replica_steps(name, kind, jt, port, key):
    if name == "RAIN_GAN":
        return _rain_steps(kind, jt, port, key)
    if name == "QG_SMOTE":
        return qg_steps(kind, jt, port, key)
    if name == "TMGGAN":
        return tmg_steps(kind, jt, port, key, 1000.0)  # the cosine term on
    return sngan_ctgan_steps(name, kind, jt, port, key)


def _stacked(calls):
    """One banked call from the replicas' calls: tensors of a batch stacked
    on a leading axis, nested calls stacked in turn, class ids and device
    scalars (lambda_class, the epoch) shared."""
    args = []
    for parts in zip(*(c.args for c in calls)):
        if isinstance(parts[0], _Call):
            args.append(_stacked(parts))
        elif isinstance(parts[0], torch.Tensor) and parts[0].dim() > 0:
            args.append(torch.stack(parts))
        else:
            args.append(parts[0])
    return _Call(calls[0].method, tuple(args))


def _run(view, call):
    args = [_run(view, a) if isinstance(a, _Call) else a for a in call.args]
    return getattr(view, call.method)(*args)


STEPS = [(n, k) for n, kinds in (("RAIN_GAN", "dcg"), ("SNGAN", "dcg"), ("CTGAN", "dcg"),
                                 ("QG_SMOTE", "dcqg"), ("TMGGAN", ("cd", "g", "div")))
         for k in kinds]


def _step_tol(name, kind):
    return {("RAIN_GAN", "d"): NET_TOL, ("RAIN_GAN", "c"): NET_TOL,
            ("RAIN_GAN", "g"): NET_TOL, ("CTGAN", "d"): GP_TOL, ("QG_SMOTE", "g"): G_TOL,
            ("TMGGAN", "div"): DIV_TOL}.get((name, kind), TOL)


def _step_runs(name, kind, blob_dataset):
    """(a loaded bank, its banked trainer, the banked call of the step,
    the vmapped JAX step's new state and losses): the JAX step has run,
    the banked one not yet."""
    jt, _, stacked_state, _ = twins(name, blob_dataset)
    bank, view = loaded_bank(name, blob_dataset)
    keys = [jax.random.PRNGKey(70 + 10 * k + STEPS.index((name, kind))) for k in range(2)]
    recorder = _Recorder(bank.trainers[0])
    steps = [_replica_steps(name, kind, jt, recorder, key) for key in keys]
    new_state, want = jax.jit(jax.vmap(steps[0][0]))(stacked_state, jnp.stack(keys))
    return bank, view, _stacked([port_step() for _, port_step in steps]), new_state, want


def _float64(trainer):
    """`trainer` (a banked or a serial one) in float64: its networks, Adam
    moments, data and draws; the caller removes the losses' float32 cast
    (`core.losses._f32`)."""
    trainer.state.double()
    for opt in trainer.optimizers.values():
        opt.m, opt.v = [m.double() for m in opt.m], [v.double() for v in opt.v]
    trainer._data = {k: v.double() if isinstance(v, torch.Tensor) and v.is_floating_point()
                     else v for k, v in trainer._data.items()}
    for draw in ("_normal", "_uniform"):
        setattr(trainer, draw, lambda shape, draw=getattr(trainer, draw): draw(shape).double())
    return trainer


def _float64_call(call):
    return _Call(call.method, tuple(
        _float64_call(a) if isinstance(a, _Call)
        else a.double() if isinstance(a, torch.Tensor) and a.is_floating_point() else a
        for a in call.args))


def _assert_as_exact_as(trainers, others, exact):
    """Each replica's tensors (every parameter, buffer and Adam tensor)
    lie within GP_TOL of its float64 run `exact`, or no farther from it
    than twice another float32 run of the same step (`others`) does."""
    for k, (t, other, ref) in enumerate(zip(trainers, others, exact)):
        got, theirs = errors_over_tol(t, ref, GP_TOL), errors_over_tol(other, ref, GP_TOL)
        assert got <= max(2.0 * theirs, 1.0), (k, got, theirs)


def _no_float32_cast(monkeypatch):
    from cvaegan_tpu_torch.core import losses as tlosses

    monkeypatch.setattr(tlosses, "_f32", lambda *xs: xs[0] if len(xs) == 1 else xs)


@pytest.mark.parametrize("name,kind", STEPS)
def test_banked_step_matches_vmapped_jax(name, kind, masks, blob_dataset, monkeypatch):
    """One banked step from the two replicas' states against `jax.vmap` of
    the JAX trainer's step over them, each replica on its own key's
    inputs: each replica's losses, then every parameter, BatchNorm
    statistic, spectral u/v and Adam tensor (moments and count; TMG-GAN's
    per-generator counts) of each replica. No kernel launches.

    CTGAN's D step: how far float32 lies from the exact step depends on
    the state and the draws (the penalty's double backward), and is far
    beyond GP_TOL at some (`test_banked_rounds_match_serial`), so its
    tensors are held to the banked step run in float64 by
    `_assert_as_exact_as`, against the JAX package's float32 step."""
    bank, view, call, new_state, want = _step_runs(name, kind, blob_dataset)
    before = (tba.LAUNCHES, tba.ENTROPY_LAUNCHES)
    got = _run(view, call)
    assert (tba.LAUNCHES, tba.ENTROPY_LAUNCHES) == before
    assert not masks
    tol = _step_tol(name, kind)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            assert got[key].shape == (2,)
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key,
                                       **tol)
    else:
        assert got.shape == (2,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    bank._store()
    if (name, kind) == ("CTGAN", "d"):
        bank64, view64 = loaded_bank(name, blob_dataset)
        _no_float32_cast(monkeypatch)
        masks.replay()
        _run(_float64(view64), _float64_call(call))
        bank64._store()
        from_jax = [copy.deepcopy(t) for t in bank.trainers]
        for k, t in enumerate(from_jax):
            t.load_jax_state(_tree(_row(new_state, k)))
        _assert_as_exact_as(bank.trainers, from_jax, bank64.trainers)
        return
    for k, t in enumerate(bank.trainers):
        if name == "TMGGAN":
            tmg_assert_state_matches(t, _row(new_state, k), tol)
        else:
            _assert_state_matches(t, _row(new_state, k), **tol)


# ----------------------------------------------------------- rounds, fits
def _round_settings(epochs=1):
    settings = _settings(epochs=epochs, batch_size=16)
    settings.gan.d_loop_num = settings.gan.c_loop_num = settings.gan.g_loop_num = 1
    return settings


def _kwargs(balanced, ema):
    return {**({"balanced_mode": True} if balanced else {}),
            **({"ema_filter": True} if ema else {})}


def _trainer(cls, seed, ds, settings, balanced=False, ema=False):
    t = cls(seed=seed, device="cpu", settings=settings, **_kwargs(balanced, ema))
    t.verbose = False
    t._prepare(ds)
    _draw_moments(t, seed)
    return t


def _bank(cls, datasets, settings, balanced=False, ema=False):
    bank = SeedBank(cls, SEEDS, settings=settings, device="cpu", **_kwargs(balanced, ema))
    for t, ds in zip(bank.trainers, datasets):
        t.verbose = False
        t._prepare(ds)
        _draw_moments(t, t.seed)
    return bank


def _datasets():
    """Two committed study fixtures, the second without class 3."""
    return [_fixture(0), _fixture(1, drop=3)]


ROUNDS = [("RAIN_GAN", False), ("SNGAN", False), ("CTGAN", False), ("QG_SMOTE", False),
          ("QG_SMOTE", True), ("TMGGAN", False)]


@pytest.mark.parametrize("name,balanced", ROUNDS)
def test_banked_rounds_match_serial(name, balanced, blob_dataset, monkeypatch):
    """Class rounds 2 and 3 (one step of each kind; balanced: the mixed
    round), every input drawn through the draw methods, then TMG-GAN's
    diversity step, from the two replicas' warm states (drawn moments),
    against serial port trainers loaded from the same states: replica 1's
    blob rows of class 3 are relabelled 0, so its round of class 3 is
    masked: it keeps every tensor (TMG-GAN: generator 3 and its Adam
    count), draws nothing and keeps round 2's losses. Tolerances are the
    steps' of (c). CTGAN's D step in float32 lies from its float64 run by
    an amount that depends on the state and the draws, at replica 1's far
    beyond GP_TOL for the serial trainer too, so CTGAN's tensors are held
    to the serial trainers run in float64 by `_assert_as_exact_as`,
    against the serial float32 run, and its losses at the fits' epoch-0
    tolerance, rtol 1e-3, atol 1e-4."""
    cls = getattr(cvaegan_tpu_torch, name)
    _, _, _, trees = twins(name, blob_dataset)
    x, y = blob_dataset.tr_samples, blob_dataset.tr_labels
    datasets = [(x, y), (x, np.where(y == 3, 0, y).astype(y.dtype))]
    bank, view = loaded_bank(name, blob_dataset, datasets, balanced)
    serial = []
    for tree, ds, present in zip(trees, datasets, ([2, 3], [2])):
        t = cls(seed=bank.trainers[len(serial)].seed, device="cpu",
                **({"balanced_mode": True} if balanced else {}))
        t._prepare(ds)
        t.load_jax_state(tree)
        t._class_rounds = lambda present=present: [None] if balanced else present
        serial.append(t)
    view._union_rounds = [None] if balanced else [2, 3]
    assert balanced or view._active[3] == [True, False]
    counts = dict.fromkeys(cls.loops, 1)
    epoch = torch.tensor(EPOCH)

    def rounds_of(trainer):
        out = trainer._rounds(lambda c: trainer._round(c, epoch, counts))
        if name == "TMGGAN":
            trainer._diversity_step(trainer._diversity_z())
        return out

    exact = [copy.deepcopy(t) for t in serial] if name == "CTGAN" else []
    got = rounds_of(view)
    want = [rounds_of(t) for t in serial]
    bank._store()
    if exact:
        _no_float32_cast(monkeypatch)
        for t in exact:
            rounds_of(_float64(t))
        _assert_as_exact_as(bank.trainers, serial, exact)
    tol = {"CTGAN": FIT_TOL, "RAIN_GAN": NET_TOL}.get(name, TOL)
    for k, (a, b) in enumerate(zip(bank.trainers, serial)):
        for key in cls.loss_keys:
            np.testing.assert_allclose(got[key][k].numpy(), want[k][key].numpy(),
                                       err_msg=key, **tol)
        if not exact:
            for u, v in zip(_tensors(a), _tensors(b)):
                np.testing.assert_allclose(u.numpy(), v.numpy(), **tol)
        assert torch.equal(a.generator.get_state(), b.generator.get_state())
    if name == "TMGGAN":
        counts_of = [[int(t.optimizers[f"gens.{i}"].count) for i in range(5)]
                     for t in bank.trainers]
        step = [1, 1, 2, 2, 1]
        assert counts_of == [[c + s for c, s in zip(GEN_COUNTS, step)],
                             [c + s - (i == 3) for i, (c, s) in
                              enumerate(zip(GEN_COUNTS[::-1], step))]]


FITS = [("RAIN_GAN", True, False), ("SNGAN", False, False),
        ("CTGAN", False, False), ("CTGAN", True, True), ("QG_SMOTE", False, False),
        ("QG_SMOTE", True, False), ("TMGGAN", False, False)]


@pytest.mark.parametrize("name,balanced,ema", FITS)
def test_bank_fit_matches_serial(name, balanced, ema):
    """3-epoch fits of K = 2 on two fixtures, the second without class 3,
    against serial fits from the same drawn moments: each replica's loss
    history (epoch 0 at rtol 1e-3, atol 1e-4; every epoch in the drift
    band), its generator's state, and with `ema_filter` its EMA
    classifier."""
    cls = getattr(cvaegan_tpu_torch, name)
    settings, datasets = _round_settings(epochs=3), _datasets()
    bank = _bank(cls, datasets, settings, balanced, ema)
    trainers = bank.fit(datasets)
    assert bank.steps_per_sec > 0
    for a, ds in zip(trainers, datasets):
        b = _trainer(cls, a.seed, ds, settings, balanced, ema)
        b.fit(ds)
        for key in cls.loss_keys:
            got, want = np.asarray(a.loss_history[key]), np.asarray(b.loss_history[key])
            assert got.shape == want.shape == (3,)
            np.testing.assert_allclose(got[0], want[0], err_msg=f"{key} epoch 0", **FIT_TOL)
            np.testing.assert_allclose(got, want, rtol=0.35, atol=0.02,
                                       err_msg=f"{key} drift band")
        assert torch.equal(a.generator.get_state(), b.generator.get_state())
        assert ("classifier_ema" in a.state) == ema
        if ema:
            for x, y in zip(a.state["classifier_ema"].parameters(),
                            b.state["classifier_ema"].parameters()):
                np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), **FIT_TOL)
    steps = [a._steps_per_epoch() for a in trainers]
    if name == "TMGGAN":
        assert steps == [5 * 2 + 1, 4 * 2 + 1]


@pytest.mark.parametrize("name,balanced", [("RAIN_GAN", True), ("TMGGAN", False)])
def test_bank_runs_no_chunk_hook(monkeypatch, name, balanced):
    """RAIN-GAN's attention history and TMG-GAN's scatters are serial-fit
    features: a bank fit calls no `_on_chunk_end`, where a serial fit of
    the same settings calls it after every chunk."""
    cls = getattr(cvaegan_tpu_torch, name)
    runs = []
    monkeypatch.setattr(cls, "_on_chunk_end", lambda self, epochs_done: runs.append(epochs_done))
    monkeypatch.setattr(cls, "epoch_chunk", 1)
    settings = _round_settings(epochs=2)
    datasets = _datasets()
    trainers = _bank(cls, datasets, settings, balanced).fit(datasets)
    assert runs == []
    assert all(len(v) == 2 for t in trainers for v in t.loss_history.values())
    if name == "RAIN_GAN":
        assert all(v == [] for t in trainers for v in t.attention_history.values())
    _trainer(cls, 0, datasets[0], settings, balanced).fit(datasets[0])
    assert runs == [1, 2]


def test_tmg_gan_bank_refuses_balanced_mode():
    with pytest.raises(ValueError, match="balanced_mode"):
        SeedBank(cvaegan_tpu_torch.TMGGAN, seeds=[0, 1], device="cpu", balanced_mode=True)
    with pytest.raises(TypeError, match="Mesh"):
        SeedBank(cvaegan_tpu_torch.TMGGAN, seeds=[0, 1], device="cpu", mesh=object())
    with pytest.raises(ValueError, match="do not divide"):
        SeedBank(cvaegan_tpu_torch.TMGGAN, seeds=[0, 1, 2], device="cpu", mesh=data_mesh(2))
