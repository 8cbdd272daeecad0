"""The port's SeedBank against the port's own serial trainers.

A bank of K replicas must give each replica what its serial trainer of
the same seed gives: the banked networks' forwards and state updates, the
per-replica draws and Adam, one banked D, C and G step from K states
(rtol 1e-5, atol 1e-6), 3-epoch fits on two committed fixtures, and a
replica that lacks a class keeps its state through that class's round.
Then the per-replica API, a shared dataset, and input validation, as the
JAX bank's tests.

Batched and unbatched matmuls, and the spectral power iteration, sum in
other orders. From Adam's real first step that rounding noise is not
small: some gradients are exactly 0 in exact arithmetic (a bias or a
one-hot column before BatchNorm, the critic's biases of units active on
every row, whose real and fake terms cancel), Adam divides their ~1e-9
of noise by its eps of 1e-8 and moves them by up to ~lr per step, so a
critic's output, and the adversarial loss, drift apart by ~1e-2 within
one epoch (measured on CGAN: 0.0096 of 0.087). So, as the step parity
tests against the JAX package do (`tests/test_torch_port_training.py`),
the fits that are held to rtol 1e-3, atol 1e-4 at epoch 0 start from
drawn Adam moments (nu >= 1e-8, where the noise moves a parameter by
~1e-9); fits from the real first step are held to the JAX bank test's
own drift bands, rtol 0.35, atol 0.02 (`tests/test_seed_bank.py:65-70`).
"""

import pathlib

import numpy as np
import pytest
import torch

import cvaegan_tpu_torch
from cvaegan_tpu_torch import CVAEGAN, VAEGAN
from cvaegan_tpu_torch.algorithms.seed_bank import SeedBank
from cvaegan_tpu_torch.core import config as tconfig
from cvaegan_tpu_torch.core.state import Adam, init_net
from cvaegan_tpu_torch.data.tabular import TabularDataset
from cvaegan_tpu_torch.models import banked, mlp
from cvaegan_tpu_torch.parallel.mesh import Mesh

TOL = dict(rtol=1e-5, atol=1e-6)
SEEDS = [3, 11]
FIXTURES = pathlib.Path(__file__).parents[1] / "experiments" / "fixtures"
EPOCH = 350.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _fixture(seed, drop=None):
    """A committed study fixture; with `drop`, that class's rows are
    relabelled as class 0, so the class is absent and the shape kept."""
    d = np.load(FIXTURES / f"imb_s{seed}.npz")
    y = d["tr_y"].astype(np.int32)
    if drop is not None:
        y = np.where(y == drop, 0, y).astype(np.int32)
    return TabularDataset(d["tr_x"].astype(np.float32), y, d["te_x"].astype(np.float32),
                          d["te_y"].astype(np.int32), name=f"imb_s{seed}")


def _settings(epochs=1, batch_size=32):
    settings = tconfig.Settings()
    settings.gan.epochs = epochs
    settings.gan.batch_size = batch_size
    return settings


def _tensors(trainer):
    """Every state and Adam tensor of a trainer, in one order."""
    return [t.detach() for t in trainer._static_tensors()[:-1]]


# ----------------------------------------------------------------- networks
def _nets(cls, *args, **kwargs):
    """Two networks of one architecture from two seeds, with BatchNorm
    statistics and spectral u/v moved off their initial values."""
    out = []
    for seed in (0, 1):
        g = torch.Generator().manual_seed(seed)
        net = init_net(cls(*args, **kwargs), g, "cpu")
        with torch.no_grad():
            for name, buf in net.named_buffers():
                if name.endswith("running_mean"):
                    buf.normal_(0.0, 0.1, generator=g)
                elif name.endswith("running_var"):
                    buf.uniform_(0.5, 1.5, generator=g)
            for m in net.modules():
                if hasattr(m, "u"):  # a few power iterations
                    for _ in range(5):
                        m.v.copy_(torch.nn.functional.normalize(m.u @ m.weight, dim=0))
                        m.u.copy_(torch.nn.functional.normalize(m.weight @ m.v, dim=0))
        out.append(net)
    return out


NETWORKS = [
    (mlp.GaussianEncoder, (12, 5), {"latent_dim": 16}, True),
    (mlp.GaussianEncoder, (12, 0), {"latent_dim": 16}, False),
    (mlp.Generator, (16, 12), {"num_classes": 5}, True),
    (mlp.Generator, (16, 12), {}, False),
    (mlp.Discriminator, (12, 5), {"spectral": True}, True),
    (mlp.Discriminator, (12,), {"spectral": True}, False),
    (mlp.Classifier, (12, 5), {}, None),
]


@pytest.mark.parametrize("cls,args,kwargs,conditional", NETWORKS,
                         ids=lambda v: getattr(v, "__name__", None))
@pytest.mark.parametrize("train", [False, True])
def test_banked_network_matches_serial(cls, args, kwargs, conditional, train):
    """A banked network's forward on [K, batch, ...] equals each serial
    network's, and a train forward updates each replica's BatchNorm
    statistics and spectral u/v as the serial one does; `store` hands the
    replicas their state back."""
    nets = _nets(cls, *args, **kwargs)
    bank = banked.stack(nets)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((2, 40, args[0]), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 5, (2, 40)))
    gens = [torch.Generator().manual_seed(s) for s in (5, 6)]
    rg = banked.ReplicaGenerators([torch.Generator().manual_seed(s) for s in (5, 6)], "cpu")

    def call(net, xs, ys, generator):
        net.train(train)
        inputs = (xs,) if conditional is None else (xs, ys if conditional else None)
        if cls in (mlp.Discriminator, mlp.Classifier):
            inputs = inputs + (generator,)
        return net(*inputs)

    got = call(bank, x, y, rg)
    want = [call(net, x[k], y[k], gens[k]) for k, net in enumerate(nets)]
    got = got if isinstance(got, tuple) else (got,)
    for k, w in enumerate(want):
        w = w if isinstance(w, tuple) else (w,)
        for g_part, w_part in zip(got, w):
            np.testing.assert_allclose(g_part[k].detach().numpy(), w_part.detach().numpy(),
                                       **TOL)
    copies = _nets(cls, *args, **kwargs)
    banked.store(bank, copies)
    for a, b in zip(copies, nets):
        for (name, t), u in zip(a.state_dict().items(), b.state_dict().values()):
            np.testing.assert_allclose(t.numpy(), u.detach().numpy(), err_msg=name, **TOL)


def test_replica_generators_draw_as_each_replica():
    rg = banked.ReplicaGenerators([torch.Generator().manual_seed(s) for s in (1, 2, 3)],
                                  "cpu")
    gens = [torch.Generator().manual_seed(s) for s in (1, 2, 3)]
    rg.active = [True, False, True]
    z = rg.randn((4, 3))
    u = rg.rand((5,))
    r = rg.randint([7, 8, 9], (6,))
    for k in (0, 2):
        assert torch.equal(z[k], torch.randn((4, 3), generator=gens[k]))
        assert torch.equal(u[k], torch.rand((5,), generator=gens[k]))
        assert torch.equal(r[k], torch.randint(0, 7 + k, (6,), generator=gens[k]))
    assert not z[1].any() and not r[1].any()
    assert torch.equal(rg.generators[1].get_state(), gens[1].get_state())


def test_adam_with_replica_counts_is_k_adams():
    rng = np.random.default_rng(0)
    params = [rng.standard_normal((3, 4, 2)).astype(np.float32),
              rng.standard_normal((3, 5)).astype(np.float32)]
    bank = Adam([torch.tensor(p) for p in params], 1e-3, 0.5, 0.999, replicas=3)
    serial = [Adam([torch.tensor(p[k]) for p in params], 1e-3, 0.5, 0.999) for k in range(3)]
    bank.count.copy_(torch.tensor([0, 4, 9], dtype=torch.int32))
    for k, opt in enumerate(serial):
        opt.count.fill_(int(bank.count[k]))
    for _ in range(2):
        grads = [rng.standard_normal(p.shape).astype(np.float32) for p in params]
        bank.step([torch.from_numpy(g) for g in grads])
        for k, opt in enumerate(serial):
            opt.step([torch.from_numpy(g[k]) for g in grads])
    for k, opt in enumerate(serial):
        for got, want in zip(bank.tensors(), opt.tensors()):
            np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=1e-6, atol=1e-7)


# -------------------------------------------------------------------- steps
def _draw_moments(trainer, seed):
    """Adam moments drawn by numpy (count 3, |m| < 2e-4, v in [1e-8, 1e-6]),
    as the JAX parity tests start from."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for opt in trainer.optimizers.values():
            for m, v in zip(opt.m, opt.v):
                m.copy_(torch.from_numpy(rng.uniform(-2e-4, 2e-4, m.shape).astype(np.float32)))
                v.copy_(torch.from_numpy(rng.uniform(1e-8, 1e-6, v.shape).astype(np.float32)))
            opt.count.fill_(3)


def _replicas(cls, datasets, balanced, settings):
    out = []
    for k, (seed, ds) in enumerate(zip(SEEDS, datasets)):
        t = cls(seed=seed, device="cpu", settings=settings, balanced_mode=balanced)
        t._prepare(ds)
        _draw_moments(t, k)
        out.append(t)
    return out


@pytest.mark.parametrize("cls,balanced", [(CVAEGAN, False), (CVAEGAN, True),
                                          (VAEGAN, False)],
                         ids=["cvae_gan-strict", "cvae_gan-balanced", "vae_gan"])
def test_banked_steps_match_serial(cls, balanced):
    """One D, C and G step of each kind the trainer has (one round with
    each loop run once), every input drawn through the draw methods, from
    K = 2 states; replica 1 lacks class 3, which balanced draws avoid."""
    settings = _settings(batch_size=64)
    datasets = [_fixture(0), _fixture(1, drop=3)]
    serial = _replicas(cls, datasets, balanced, settings)
    bank = SeedBank(cls, SEEDS, settings=settings, device="cpu", balanced_mode=balanced)
    for t, ds, k in zip(bank.trainers, datasets, range(2)):
        t._prepare(ds)
        _draw_moments(t, k)
    view = bank._load()
    counts = dict.fromkeys(cls.loops, 1)
    epoch = torch.tensor(EPOCH)
    class_id = None if balanced or cls is VAEGAN else 1
    got = view._round(class_id, epoch, counts)
    want = [t._round(class_id, epoch, counts) for t in serial]
    bank._store()
    for k, (a, b) in enumerate(zip(bank.trainers, serial)):
        for key in cls.loss_keys:
            np.testing.assert_allclose(got[key][k].numpy(), want[k][key].numpy(),
                                       err_msg=key, **TOL)
        for x, y in zip(_tensors(a), _tensors(b)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)
        assert torch.equal(a.generator.get_state(), b.generator.get_state())


# --------------------------------------------------------------------- fits
def _serial_fit(cls, seed, ds, settings, balanced, drawn):
    t = cls(seed=seed, device="cpu", settings=settings, balanced_mode=balanced)
    t.verbose = False
    t._prepare(ds)
    if drawn:
        _draw_moments(t, seed)
    t.fit(ds)
    return t


def _bank_fit(cls, datasets, settings, balanced, drawn):
    bank = SeedBank(cls, SEEDS, settings=settings, device="cpu", balanced_mode=balanced)
    for t, ds in zip(bank.trainers, datasets):
        t._prepare(ds)
        if drawn:
            _draw_moments(t, t.seed)
    return bank, bank.fit(datasets)


@pytest.mark.parametrize("drawn", [True, False], ids=["drawn_moments", "first_step"])
@pytest.mark.parametrize("cls,balanced", [(CVAEGAN, False), (CVAEGAN, True),
                                          (VAEGAN, False)],
                         ids=["cvae_gan-strict", "cvae_gan-balanced", "vae_gan"])
def test_bank_fit_matches_serial(cls, balanced, drawn):
    """3-epoch fits of K = 2 on two fixtures, the second without class 3
    (its strict rounds of class 3 are masked), against serial fits."""
    settings = _settings(epochs=3)
    datasets = [_fixture(0), _fixture(1, drop=3)]
    serial = [_serial_fit(cls, seed, ds, settings, balanced, drawn)
              for seed, ds in zip(SEEDS, datasets)]
    bank, trainers = _bank_fit(cls, datasets, settings, balanced, drawn)
    assert bank.steps_per_sec > 0 and bank.fit_seconds > 0
    for a, b in zip(trainers, serial):
        for key in cls.loss_keys:
            got, want = np.asarray(a.loss_history[key]), np.asarray(b.loss_history[key])
            assert got.shape == want.shape == (3,)
            if drawn:
                np.testing.assert_allclose(got[0], want[0], rtol=1e-3, atol=1e-4,
                                           err_msg=f"{key} epoch 0")
            np.testing.assert_allclose(got, want, rtol=0.35, atol=0.02,
                                       err_msg=f"{key} drift band")
        assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_replica_without_a_class_keeps_its_state():
    """In strict mode the round of class 3 runs for replica 0 only:
    replica 1, which lacks the class, keeps every state and Adam tensor
    bitwise and draws nothing; its losses stay its last present round's."""
    settings = _settings(batch_size=32)
    bank = SeedBank(CVAEGAN, SEEDS, settings=settings, device="cpu")
    for t, ds in zip(bank.trainers, [_fixture(0), _fixture(1, drop=3)]):
        t._prepare(ds)
    view = bank._load()
    assert view._class_rounds() == [0, 1, 2, 3, 4]
    assert view._active[3] == [True, False]
    before = [t.clone() for t in view._static_tensors()[:-1]]
    rng_before = [g.get_state() for g in view._generators()]
    previous = {key: torch.tensor([1.0, 2.0]) for key in CVAEGAN.loss_keys}
    view._union_rounds = [2, 3]
    out = view._rounds(lambda c: previous if c == 2 else view._round(
        c, torch.tensor(EPOCH), dict.fromkeys(CVAEGAN.loops, 1)))
    after = view._static_tensors()[:-1]
    assert all(torch.equal(a[1], b[1]) for a, b in zip(after, before))
    assert sum(not torch.equal(a[0], b[0]) for a, b in zip(after, before)) > len(after) // 2
    assert torch.equal(view._generators()[1].get_state(), rng_before[1])
    assert not torch.equal(view._generators()[0].get_state(), rng_before[0])
    for key in CVAEGAN.loss_keys:
        assert float(out[key][1]) == 2.0 and float(out[key][0]) != 1.0
    assert view.generator.active == [True, True]


# ---------------------------------------------------------------------- API
def test_bank_shared_dataset_and_api():
    """One dataset shared by every replica; trained replicas expose the
    full per-trainer API; a second fit continues."""
    settings = _settings(epochs=2)
    ds = _fixture(2)
    bank = SeedBank(CVAEGAN, seeds=[0, 1, 2], settings=settings, device="cpu",
                    balanced_mode=True)
    trainers = bank.fit(ds)
    assert len(trainers) == 3 and all(t.seed == s for t, s in zip(trainers, [0, 1, 2]))
    assert all(len(v) == 2 for t in trainers for v in t.loss_history.values())
    out = trainers[1].generate_samples(0, 7)
    assert out.shape == (7, ds.tr_samples.shape[1])
    assert trainers[1].generate_samples_fast(0, 7).shape == (7, ds.tr_samples.shape[1])
    q = trainers[2].generate_qualified_samples(0, 5, confidence_threshold=0.0)
    assert q.shape[1] == ds.tr_samples.shape[1]
    assert trainers[0].reconstruct_samples(ds.tr_samples[:4], ds.tr_labels[:4]).shape == (4, 30)
    a = trainers[0].generate_samples(0, 4)
    b = trainers[1].generate_samples(0, 4)
    assert not np.allclose(a, b)
    view = bank._bank[1]
    bank.fit(ds)
    assert bank._bank[1] is view
    assert all(len(v) == 4 for t in trainers for v in t.loss_history.values())
    steps = {"encoder": 3, "generator": 3, "discriminator": 5, "classifier": 5}
    for name, opt in trainers[0].optimizers.items():
        assert int(opt.count) == 4 * steps[name], name


@pytest.mark.parametrize("name", ["CGAN", "CVAE", "GAN", "VAE"])
def test_bank_of_each_trainer(name):
    cls = getattr(cvaegan_tpu_torch, name)
    settings = _settings(batch_size=16)
    datasets = [_fixture(3), _fixture(4)]
    _, trainers = _bank_fit(cls, datasets, settings, False, True)
    for t, ds in zip(trainers, datasets):
        serial = _serial_fit(cls, t.seed, ds, settings, False, True)
        for key in cls.loss_keys:
            np.testing.assert_allclose(t.loss_history[key], serial.loss_history[key],
                                       rtol=1e-3, atol=1e-4, err_msg=key)


class _Grid:
    """A device mesh's axis sizes, all `Mesh.shape` reads: enough for the
    checks `SeedBank` makes before it needs a process group."""

    def __init__(self, *sizes):
        self.sizes = sizes

    def size(self, axis: int) -> int:
        return self.sizes[axis]


def data_mesh(n_data: int) -> Mesh:
    return Mesh(_Grid(n_data, 1))


def test_bank_input_validation(monkeypatch):
    with pytest.raises(ValueError, match="at least one seed"):
        SeedBank(CVAEGAN, seeds=[], device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        SeedBank(CVAEGAN, seeds=[0, 1], device="cpu", mesh=object())
    with pytest.raises(ValueError, match="3 seeds do not divide the mesh's 'data' axis"):
        SeedBank(CVAEGAN, seeds=[0, 1, 2], device="cpu", mesh=data_mesh(2))
    bank = SeedBank(CVAEGAN, seeds=[0, 1], settings=_settings(), device="cpu")
    with pytest.raises(ValueError, match="datasets"):
        bank.fit([_fixture(0)] * 3)
    short = _fixture(0)
    short = TabularDataset(short.tr_samples[:800], short.tr_labels[:800],
                           short.te_samples, short.te_labels)
    with pytest.raises(ValueError, match="one shape"):
        SeedBank(CVAEGAN, seeds=[0, 1], settings=_settings(), device="cpu").fit(
            [_fixture(0), short])
    fewer = _fixture(0)
    fewer = TabularDataset(fewer.tr_samples, np.minimum(fewer.tr_labels, 3),
                           fewer.te_samples, fewer.te_labels)
    with pytest.raises(ValueError, match="label_num"):
        SeedBank(CVAEGAN, seeds=[0, 1], settings=_settings(), device="cpu").fit(
            [_fixture(0), fewer])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SeedBank(CVAEGAN, seeds=[0])
