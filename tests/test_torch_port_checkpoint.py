"""The port's checkpoints, profiling and `compat` shim against the JAX
package's `utils/checkpoint.py`, `utils/profiling.py` and `compat.py`.

Checkpoints: a save and a restore into a fresh trainer of another seed
give back every network tensor (buffers included), every optimizer
tensor (the device step counts too; TMG-GAN's one Adam per generator),
the generator's state and the loss history, bitwise, for all 11 trainers;
a restored trainer's further fit equals the unbroken trainer's, bitwise;
`fit` and `fit_streamed` write a checkpoint after every `epoch_chunk`
epochs; a dataset of other widths raises JAX's "shape mismatch"; a
generator state from another device type is not restored (one line
says so) and the trainer keeps its seed's stream; a second save replaces
the first and leaves no temporary directory. Profiling: `Throughput`
reports what JAX's reports for the same elapsed time, `nan_debug()`
raises `FloatingPointError` on a NaN and a fit inside it completes on the
plain path, `trace()` writes a trace file. `compat`: the JAX package's
reference-workflow test, on the port.
"""

import json

import numpy as np
import pytest
import torch

import cvaegan_tpu_torch as tp
from cvaegan_tpu.utils import profiling as jprofiling
from cvaegan_tpu_torch.core import config as tconfig
from cvaegan_tpu_torch.utils import profiling
from cvaegan_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

TRAINERS = ("CVAEGAN", "CGAN", "CVAE", "GAN", "VAE", "VAEGAN", "RAIN_GAN", "SNGAN", "CTGAN",
            "QG_SMOTE", "TMGGAN")
FEATURES, CLASSES = 6, 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _settings(tmp_path, epochs=1):
    s = tconfig.Settings()
    s.gan.batch_size = 16
    s.gan.epochs = epochs
    s.gan.d_loop_num = s.gan.c_loop_num = s.gan.g_loop_num = 1
    s.classifier.epochs = 1
    s.paths = tconfig.Paths(root=tmp_path / "data")
    return s


def _data(seed=0, rows=60, features=FEATURES):
    rng = np.random.default_rng(seed)
    y = (np.arange(rows) % CLASSES).astype(np.int32)
    return rng.random((rows, features), dtype=np.float32) * 0.5 + y[:, None] * 0.2, y


def _trainer(name, tmp_path, seed=0, epochs=1):
    m = getattr(tp, name)(seed=seed, device="cpu", settings=_settings(tmp_path, epochs))
    m.verbose = False
    return m


def _tensors(m):
    return [*m.state.state_dict().values(),
            *[t for opt in m.optimizers.values() for t in opt.tensors()]]


def _assert_same(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert a.loss_history == b.loss_history


@pytest.mark.parametrize("name", TRAINERS)
def test_round_trip_is_bitwise(name, tmp_path):
    data = _data()
    a = _trainer(name, tmp_path)
    a.fit(data)
    assert save_checkpoint(a, tmp_path / "ck") == (tmp_path / "ck").resolve()
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    assert meta["name"] == a.name and meta["device_type"] == "cpu"
    assert (meta["feature_num"], meta["label_num"]) == (FEATURES, CLASSES)
    b = _trainer(name, tmp_path, seed=5)
    restore_checkpoint(b, tmp_path / "ck", data)
    _assert_same(a, b)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    if "gens" in a.state:  # TMG-GAN: one Adam, with its own count, per generator
        assert sorted(a.optimizers) == sorted(b.optimizers)
        assert all(k in a.optimizers for k in ("gens.0", "gens.1", "gens.2"))


@pytest.mark.parametrize("name", ["CVAEGAN", "SNGAN", "CTGAN", "TMGGAN"])
def test_resumed_fit_equals_unbroken(name, tmp_path):
    data = _data()
    unbroken = _trainer(name, tmp_path, epochs=2)
    unbroken.fit(data)
    save_checkpoint(unbroken, tmp_path / "ck")
    resumed = _trainer(name, tmp_path, seed=9, epochs=2)
    restore_checkpoint(resumed, tmp_path / "ck", data)
    for m in (unbroken, resumed):
        m.fit(data)
    _assert_same(unbroken, resumed)
    assert all(len(v) == 4 for v in resumed.loss_history.values())


def test_checkpoints_written_during_fit_and_fit_streamed(tmp_path):
    data = _data()
    m = _trainer("VAE", tmp_path, epochs=3)
    m.epoch_chunk = 1
    m.checkpoint_dir = tmp_path / "auto"
    m.fit(data)
    meta = json.loads((tmp_path / "auto" / "meta.json").read_text())
    assert len(meta["loss_history"]["recon_loss"]) == 3
    restored = _trainer("VAE", tmp_path)
    restore_checkpoint(restored, tmp_path / "auto", data)
    assert restored.generate_samples(4).shape == (4, FEATURES)

    x, y = _data(rows=100)
    np.savetxt(tmp_path / "x.csv", x, delimiter=",", fmt="%.9g")
    np.savetxt(tmp_path / "y.csv", np.eye(CLASSES)[y], delimiter=",", fmt="%d")
    s = _trainer("CVAEGAN", tmp_path)
    s.epoch_chunk = 2
    s.checkpoint_dir = tmp_path / "streamed"
    s.fit_streamed(tmp_path / "x.csv", tmp_path / "y.csv", window_rows=40, epochs_per_window=3)
    meta = json.loads((tmp_path / "streamed" / "meta.json").read_text())
    assert len(meta["loss_history"]["recon_loss"]) == 3 * 3


def test_shape_mismatch_raises(tmp_path):
    m = _trainer("VAE", tmp_path)
    m.fit(_data())
    save_checkpoint(m, tmp_path / "ck")
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(_trainer("VAE", tmp_path), tmp_path / "ck", _data(features=7))


def test_generator_state_only_on_its_device_type(tmp_path, capsys):
    data = _data()
    m = _trainer("CVAEGAN", tmp_path)
    m.fit(data)
    save_checkpoint(m, tmp_path / "ck")
    meta_path = tmp_path / "ck" / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta["device_type"] = "cuda"
    meta_path.write_text(json.dumps(meta))
    fresh = _trainer("CVAEGAN", tmp_path, seed=3)
    seed_state = fresh.generator.get_state()
    restore_checkpoint(fresh, tmp_path / "ck", data)
    assert "keeps its seed's stream" in capsys.readouterr().out
    assert torch.equal(fresh.generator.get_state(), seed_state)
    assert all(torch.equal(a, b) for a, b in zip(_tensors(m), _tensors(fresh)))


def test_a_second_save_replaces_the_first(tmp_path):
    data = _data()
    m = _trainer("CGAN", tmp_path)
    m.fit(data)
    save_checkpoint(m, tmp_path / "ck")
    m.fit(data)
    save_checkpoint(m, tmp_path / "ck")
    assert not [p.name for p in tmp_path.iterdir() if p.name.startswith(".")]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["meta.json", "state.pt"]
    restored = _trainer("CGAN", tmp_path)
    restore_checkpoint(restored, tmp_path / "ck", data)
    _assert_same(m, restored)
    with pytest.raises(RuntimeError, match="nothing to checkpoint"):
        save_checkpoint(_trainer("CGAN", tmp_path), tmp_path / "none")


# ---------------------------------------------------------------- profiling
def test_throughput_reports_equal_jax():
    for batch in (None, 128):
        port, jax_ = profiling.Throughput(65, batch), jprofiling.Throughput(65, batch)
        for t in (port, jax_):
            t._t0, t.elapsed = 0.0, 1.7
        assert port.report(epochs=10) == jax_.report(epochs=10)
        assert port.report_json(3) == jax_.report_json(3)
    t = profiling.Throughput(65, 128, device="cpu")
    t.start()
    assert t.stop() > 0 and t.report(1)["steps"] == 65
    with pytest.raises(RuntimeError, match="before start"):
        profiling.Throughput(1).stop()


def test_nan_debug_raises_and_fits_on_the_plain_path(tmp_path):
    with profiling.nan_debug():
        assert profiling.nan_debug_active()
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(torch.tensor([-1.0]))
        torch.empty(8)  # uninitialized memory is not a NaN an op made
        m = _trainer("CVAEGAN", tmp_path)
        m.fit(_data())
        assert m._graph is None
    assert not profiling.nan_debug_active()
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()


def test_trace_writes_a_trace_file(tmp_path):
    with profiling.trace(tmp_path / "trace") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert files and files[0].stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())


# ------------------------------------------------------------------- compat
def test_compat_reference_workflow(tmp_path):
    """`tests/test_compat.py::test_compat_reference_workflow`, on the port."""
    from cvaegan_tpu_torch import compat

    settings = tconfig.settings
    old = (settings.seed, settings.gan.epochs, settings.classifier.epochs, settings.paths)
    settings.gan.epochs = settings.classifier.epochs = 2
    settings.paths = tconfig.Paths(root=tmp_path / "data")
    try:
        compat.set_random_state(0)
        compat.prepare_datasets()  # blobs fixture, reference style
        assert compat.feature_num == 30 and compat.label_num == 5
        assert len(compat.tr_samples) == 900

        m = tp.CVAEGAN(device="cpu")
        m.verbose = False
        m.fit(compat.TrDataset())
        g = m.generate_samples(0, 8)
        assert g.shape == (8, 30)

        compat.tr_samples = np.concatenate([compat.tr_samples, g])
        compat.tr_labels = np.concatenate([compat.tr_labels, np.zeros(8, np.int32)])
        compat.set_dataset_values()
        assert len(compat.TrDataset()) == 908

        clf = tp.Classifier("compat", device="cpu")
        clf.fit(compat.TrDataset())
        clf.test((compat.te_samples, compat.te_labels))
        assert set(clf.metrics) == {"Precision", "Recall", "F1"}
        clf.test(compat.TeDataset())

        compat.transfer_to_binary()
        assert set(np.unique(compat.tr_labels)) <= {0, 1}
        compat.turn_on_test_mode()
        assert (settings.gan.epochs, settings.classifier.epochs) == (1, 1)
    finally:
        settings.seed, settings.gan.epochs, settings.classifier.epochs, settings.paths = old
