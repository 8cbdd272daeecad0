"""The port's CGAN, CVAE, GAN, VAE and VAE-GAN against the JAX package's.

For each trainer a JAX trainer is built on the blob fixture (`_prepare`,
no fit); its BatchNorm statistics and spectral u/v are moved off their
initial values and its Adam moments replaced by numpy draws (count 3,
|mu| < 2e-4, nu in [1e-8, 1e-6]: see `tests/test_torch_port_training.py`
for why a real first step's moments cannot be compared), and the state,
Adam state included, is carried into the port with `load_jax_state`.
Then each D, C and G step the trainer has runs on both sides from that
state, on the same inputs (drawn on the JAX side from the step's own key
split) and the same dropout keep-masks: losses, every parameter,
BatchNorm statistic, spectral u/v and Adam tensor agree at rtol 1e-5,
atol 1e-6, as do the eval forwards of the generator (or decoder),
encoder and classifier. The epoch's order of steps is checked by
counting calls; the serving entry points by their JAX signatures and
output shapes; each trainer's pipeline by its artifact.
"""

import inspect
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvaegan_tpu
import cvaegan_tpu_torch
from cvaegan_tpu.core.state import apply_eval as jax_apply_eval
from cvaegan_tpu_torch.convert import net_leaves
from cvaegan_tpu_torch.core import config as tconfig
from cvaegan_tpu_torch.core.state import apply_eval
from cvaegan_tpu_torch.data.tabular import TabularDataset
from cvaegan_tpu_torch.models import layers as tl
from cvaegan_tpu_torch.pipelines import balance as tbalance

TOL = dict(rtol=1e-5, atol=1e-6)
EPOCH = 350.0  # inside the lambda_class ramp
CLASS_ID = 2
NAMES = ("CGAN", "CVAE", "GAN", "VAE", "VAEGAN")
KINDS = {"CGAN": "dcg", "CVAE": "cg", "GAN": "dcg", "VAE": "cg", "VAEGAN": "dg"}
CONDITIONAL = ("CGAN", "CVAE")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


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


def _warm_state(jt, seed):
    """The JAX trainer's state with BatchNorm statistics, spectral u/v and
    Adam moments drawn by numpy."""
    rng = np.random.default_rng(seed)

    def draw(low, high, signed):
        def leaf(x):
            mag = rng.uniform(low, high, np.shape(x))
            sign = rng.choice([-1.0, 1.0], np.shape(x)) if signed else 1.0
            return jnp.asarray(sign * mag, jnp.float32)
        return leaf

    def mutable(path, x):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return jnp.asarray(rng.uniform(0.5, 1.5, np.shape(x)), jnp.float32)
        if "'mean'" in name:
            return jnp.asarray(0.1 * rng.standard_normal(np.shape(x)), jnp.float32)
        v = rng.standard_normal(np.shape(x))
        return jnp.asarray(v / np.linalg.norm(v), jnp.float32)  # spectral u, v

    state = dict(jt.state)
    for name, ns in state.items():
        adam_state, *rest = ns.opt_state
        adam_state = adam_state._replace(
            count=jnp.int32(3), mu=jax.tree.map(draw(0.0, 2e-4, True), adam_state.mu),
            nu=jax.tree.map(draw(1e-8, 1e-6, False), adam_state.nu))
        state[name] = ns.replace(
            mutables=jax.tree_util.tree_map_with_path(mutable, ns.mutables),
            opt_state=(adam_state, *rest))
    return state


_JAX = {}


def _jax(name, blob_dataset):
    """(JAX trainer, its warm state, the state as numpy trees), built once."""
    if name not in _JAX:
        jt = getattr(cvaegan_tpu, name)(seed=0)
        jt.verbose = False
        jt._prepare(blob_dataset)
        state = _warm_state(jt, NAMES.index(name))
        jt.state = state
        jt._clear_gen_caches()
        _JAX[name] = (jt, state, _tree(state))
    return _JAX[name]


def _port(name, blob_dataset):
    jt, _, tree = _jax(name, blob_dataset)
    port = getattr(cvaegan_tpu_torch, name)(seed=0, device="cpu")
    port._prepare((blob_dataset.tr_samples, blob_dataset.tr_labels))
    port.load_jax_state(tree)
    return port


def _lookup(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _assert_state_matches(port, jstate):
    tree = _tree(jstate)
    assert set(tree) == set(port.state.keys())
    for name, net in port.state.items():
        opt = port.optimizers[name]
        slot = {id(p): i for i, p in enumerate(opt.params)}
        for path, (tensor, transposed) in net_leaves(net).items():
            want = _lookup(tree[name], path)
            want = want.T if transposed else want
            where = f"{name}/{'/'.join(path)}"
            np.testing.assert_allclose(tensor.detach().numpy(), want, err_msg=where, **TOL)
            if path[0] == "params":
                for moment, got in (("mu", opt.m), ("nu", opt.v)):
                    m = _lookup(tree[name]["opt_state"][moment], path[1:])
                    np.testing.assert_allclose(
                        got[slot[id(tensor)]].numpy(), m.T if transposed else m,
                        err_msg=f"{where} Adam {moment}", **TOL)
        assert int(opt.count) == int(tree[name]["opt_state"]["count"]), name


@pytest.fixture
def masks(monkeypatch):
    """The same dropout keep-masks for Flax and the port, in call order."""
    rng = np.random.default_rng(11)
    queue = []

    def bernoulli(key, p=0.5, shape=None):
        mask = rng.random(shape) < p
        queue.append(mask)
        return jnp.asarray(mask)

    def keep_mask(x, keep_prob, generator):
        mask = queue.pop(0)
        assert mask.shape == tuple(x.shape)
        return torch.from_numpy(mask)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    monkeypatch.setattr(tl, "_keep_mask", keep_mask)
    return queue


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _normal(jt, key):
    return jax.random.normal(key, (jt.gan_cfg.batch_size, jt.gan_cfg.z_size))


def _random_batch(jt, key):
    from cvaegan_tpu.data.sampler import sample_random_batch

    return sample_random_batch(key, jt._data["samples"], jt._data["labels"],
                               jt.gan_cfg.batch_size)


def _steps(name, kind, jt, port, key):
    """(the JAX step as a function of (state, key), the port's step on the
    same inputs as a thunk)."""
    data = jt._data
    lam = port._lambda_class(torch.tensor(EPOCH)) if name in CONDITIONAL else None
    if name in CONDITIONAL:
        if kind in "dc":
            k_x, k_z, _ = jax.random.split(key, 3)
            x, y, z = _t(*jt._sample_batch(k_x, data, CLASS_ID), _normal(jt, k_z))
            step = jt._d_step if kind == "d" else jt._c_step
            port_step = port._d_step if kind == "d" else port._c_step
            return (lambda s, k: step(s, data, CLASS_ID, k),
                    lambda: port_step(x, y.long(), z))
        jax_g = lambda s, k: jt._g_step(s, data, CLASS_ID, jnp.float32(EPOCH), k)  # noqa: E731
        if name == "CGAN":
            k_y, k_z, _, _ = jax.random.split(key, 4)
            y, z = _t(jt._sample_labels(k_y, data, CLASS_ID), _normal(jt, k_z))
            return jax_g, lambda: port._g_step(y.long(), z, lam)
        k_x, k_eps, _ = jax.random.split(key, 3)
        x, y, eps = _t(*jt._sample_batch(k_x, data, CLASS_ID), _normal(jt, k_eps))
        return jax_g, lambda: port._g_step(x, y.long(), eps, lam)
    step = getattr(jt, f"_{kind}_step")
    jax_step = lambda s, k: step(s, data, k)  # noqa: E731
    if kind == "d":
        k_x, k_z, _ = jax.random.split(key, 3)
        x, _ = _random_batch(jt, k_x)
        x, z = _t(x, _normal(jt, k_z))
        return jax_step, lambda: port._d_step(x, None, z)
    if kind == "c":
        k_x, _ = jax.random.split(key)
        x, y = _t(*_random_batch(jt, k_x))
        return jax_step, lambda: port._c_step(x, y)
    if name == "GAN":
        k_z, _ = jax.random.split(key)
        (z,) = _t(_normal(jt, k_z))
        return jax_step, lambda: port._g_step(z)
    if name == "VAE":
        k_x, k_eps = jax.random.split(key)
        x, _ = _random_batch(jt, k_x)
        x, eps = _t(x, _normal(jt, k_eps))
        return jax_step, lambda: port._g_step(x, eps)
    k_x, k_eps, k_z, _ = jax.random.split(key, 4)
    x, _ = _random_batch(jt, k_x)
    x, eps, z = _t(x, _normal(jt, k_eps), _normal(jt, k_z))
    return jax_step, lambda: port._g_step(x, z, eps)


@pytest.mark.parametrize("name,kind", [(n, k) for n in NAMES for k in KINDS[n]])
def test_steps_match_jax(name, kind, masks, blob_dataset):
    jt, state, _ = _jax(name, blob_dataset)
    port = _port(name, blob_dataset)
    key = jax.random.PRNGKey(30 + "dcg".index(kind))
    jax_step, port_step = _steps(name, kind, jt, port, key)
    new_state, want = jax.jit(jax_step)(state, key)
    got = port_step()
    assert not masks
    if kind == "g":
        assert set(got) == set(port.loss_keys) == set(want)
        for k in port.loss_keys:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_state_matches(port, new_state)


@pytest.mark.parametrize("name", NAMES)
def test_eval_forwards_match_jax(name, blob_dataset):
    jt, state, _ = _jax(name, blob_dataset)
    port = _port(name, blob_dataset)
    _assert_state_matches(port, state)
    rng = np.random.default_rng(1)
    z = rng.standard_normal((200, 128)).astype(np.float32)
    y = (np.arange(200) % 5).astype(np.int32)
    want = jt._generator_forward(state, jnp.asarray(z), jnp.asarray(y), None)
    got = port._generator_forward(port.state, torch.from_numpy(z), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    x, xy = blob_dataset.te_samples, blob_dataset.te_labels
    want = jt._classifier_logits(state, jnp.asarray(x))
    got = port._classifier_logits(port.state, torch.from_numpy(x))
    assert (want is None) == (got is None) == (name == "VAEGAN")
    if got is not None:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if "encoder" in state:
        args = (x, xy) if name in CONDITIONAL else (x,)
        wmu, wlv = jax_apply_eval(jt.modules["encoder"], state["encoder"], *args)
        mu, log_var = apply_eval(port.state["encoder"], *map(torch.from_numpy, args))
        np.testing.assert_allclose(mu.numpy(), np.asarray(wmu), **TOL)
        np.testing.assert_allclose(log_var.numpy(), np.asarray(wlv), **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_serving_has_the_jax_signatures(name, blob_dataset):
    jt, port = getattr(cvaegan_tpu, name), getattr(cvaegan_tpu_torch, name)
    assert port.conditional_sampling == jt.conditional_sampling
    for method in ("generate_samples", "generate_qualified_samples", "reconstruct_samples"):
        assert (list(inspect.signature(getattr(port, method)).parameters)
                == list(inspect.signature(getattr(jt, method)).parameters)), method
    model = _port(name, blob_dataset)
    x, y = blob_dataset.te_samples[:50], blob_dataset.te_labels[:50]
    if name in CONDITIONAL:
        out = model.generate_samples(1, 33)
        rng_state = model.generator.get_state()
        fast = model.generate_samples_fast(1, 33)
        model.generator.set_state(rng_state)
        plain = model._generator_forward(model.state, model._prior(33), model._labels(1, 33))
        np.testing.assert_allclose(fast, plain.numpy(), **TOL)
    else:
        out = model.generate_samples(33)
        with pytest.raises(NotImplementedError, match=model.name):
            model.generate_samples_fast(1, 33)
    assert out.shape == (33, 30) and out.dtype == np.float32 and np.isfinite(out).all()
    if name == "VAEGAN":
        with pytest.raises(NotImplementedError, match="qualified"):
            model.generate_qualified_samples(1, 10)
    else:
        q = model.generate_qualified_samples(1, 40, confidence_threshold=0.0)
        assert q.shape[1] == 30 and len(q) <= 40
        if len(q):
            logits = model._classifier_logits(model.state, torch.from_numpy(q))
            assert (logits.argmax(-1) == 1).all()
    if name in ("CGAN", "GAN"):
        with pytest.raises(NotImplementedError, match="encoder"):
            model.reconstruct_samples(x, y)
    else:
        recon = model.reconstruct_samples(x, y) if name == "CVAE" else model.reconstruct_samples(x)
        assert recon.shape == (50, 30) and np.isfinite(recon).all()


def test_load_jax_state_accounts_for_every_leaf(blob_dataset):
    import copy

    _, _, tree = _jax("VAE", blob_dataset)
    port = cvaegan_tpu_torch.VAE(device="cpu")
    port.load_jax_state(tree)
    assert (port.feature_num, port.label_num) == (30, 5)
    missing = copy.deepcopy(tree)
    del missing["decoder"]["batch_stats"]["MLPTrunk_0"]["BatchNorm_2"]
    with pytest.raises(ValueError, match="missing"):
        port.load_jax_state(missing)
    renamed = {("generator" if k == "decoder" else k): v for k, v in tree.items()}
    with pytest.raises(KeyError):
        port.load_jax_state(renamed)
    # VAE-GAN's networks do not know the classes: the data's count stays
    _, _, vtree = _jax("VAEGAN", blob_dataset)
    vport = cvaegan_tpu_torch.VAEGAN(device="cpu")
    vport._prepare((blob_dataset.tr_samples, blob_dataset.tr_labels))
    vport.load_jax_state(vtree)
    assert (vport.feature_num, vport.label_num) == (30, 5)


# -------------------------------------------------------------------- epoch
def _small_settings(epochs=1):
    settings = tconfig.Settings()
    settings.gan.batch_size = 16
    settings.gan.epochs = epochs
    return settings


def _record_steps(monkeypatch, trainer):
    calls = []
    for kind in ("d", "c", "g"):
        if not hasattr(trainer, f"_{kind}_step"):
            continue
        step = getattr(trainer, f"_{kind}_step")

        def wrapped(*args, _kind=kind, _step=step):
            out = _step(*args)
            calls.append((_kind, {k: float(v) for k, v in out.items()}
                          if _kind == "g" else None))
            return out

        monkeypatch.setattr(trainer, f"_{kind}_step", wrapped)
    return calls


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("balanced", [False, True])
def test_epoch_order(monkeypatch, name, balanced):
    rng = np.random.default_rng(0)
    x = rng.random((100, 12), dtype=np.float32)
    y = (np.arange(100) % 5).astype(np.int32)
    port = getattr(cvaegan_tpu_torch, name)(seed=0, device="cpu",
                                            settings=_small_settings(),
                                            balanced_mode=balanced)
    port.verbose = False
    port._prepare((x, y))
    calls = _record_steps(monkeypatch, port)
    port._fit_prepared(1)
    rounds = 5 if name in CONDITIONAL and not balanced else 1
    loops = {"d": 5, "c": 5, "g": 3}
    per_round = [kind for kind in KINDS[name] for _ in range(loops[kind])]
    assert [c[0] for c in calls] == per_round * rounds
    assert port._steps_per_epoch() == len(calls)
    last = calls[-1][1]
    assert {k: v[0] for k, v in port.loss_history.items()} == last
    assert all(np.isfinite(v) for v in last.values())


@pytest.mark.parametrize("model", ["cgan", "cvae", "gan", "vae", "vae_gan"])
def test_pipeline_of_each_trainer(tmp_path, model):
    settings = tconfig.Settings()
    settings.gan.epochs = 2
    settings.gan.batch_size = 32
    settings.classifier.epochs = 1
    settings.paths = tconfig.Paths(root=tmp_path / "data")
    cls_name, display, mode = tbalance.TRAINERS[model]
    ds = TabularDataset.synthetic_blobs(seed=0)
    result = tbalance.run_balance_pipeline(
        getattr(cvaegan_tpu_torch, cls_name), display, ds, out_dir=tmp_path,
        settings=settings, plot=False, generation_mode=mode, device="cpu")
    assert isinstance(result["model"], getattr(cvaegan_tpu_torch, cls_name))
    with open(result["pickle_path"], "rb") as f:
        tr_x, tr_y, te_x, te_y = pickle.load(f)
    base = ds.renormalized()
    n = len(base.tr_labels)
    np.testing.assert_array_equal(tr_y[:n], base.tr_labels)
    np.testing.assert_array_equal(te_y, base.te_labels)
    assert len(tr_x) == len(tr_y) and tr_x.shape[1] == 30
    if mode == "unconditional":
        assert len(tr_y) == 2 * n
    args = tbalance.make_cli("port").parse_args(["--model", model])
    assert tbalance.TRAINERS[args.model] == (cls_name, display, mode)


def test_pipeline_falls_back_for_a_trainer_without_the_options(tmp_path):
    """A trainer whose constructor refuses `balanced_mode`/`ema_filter` is
    built without them when neither is asked for, as in the JAX pipeline."""

    class Plain(cvaegan_tpu_torch.VAEGAN):
        def __init__(self, seed=None, settings=None, device="cuda"):
            super().__init__(seed=seed, settings=settings, device=device)

    settings = tconfig.Settings()
    settings.gan.epochs = 1
    settings.classifier.epochs = 1
    settings.paths = tconfig.Paths(root=tmp_path / "data")
    ds = TabularDataset.synthetic_blobs(n_samples=200, seed=0)
    result = tbalance.run_balance_pipeline(
        Plain, "VAE_GAN", ds, out_dir=tmp_path, settings=settings, plot=False,
        generation_mode="unconditional", device="cpu")
    assert isinstance(result["model"], Plain)
    with pytest.raises(TypeError):
        tbalance.run_balance_pipeline(
            Plain, "VAE_GAN", ds, out_dir=tmp_path, settings=settings, plot=False,
            generation_mode="unconditional", balanced_mode=True, device="cpu")
