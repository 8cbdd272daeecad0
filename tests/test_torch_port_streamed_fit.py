"""The port's out-of-core trainer fit (`fit_streamed`) against the JAX
package's.

Windows: on the same CSV pair, each window the port trains on (padded
samples, labels, class-index table and device counts) equals, exactly,
the `self._data` the JAX trainer trains on, recorded by replacing
`_fit_prepared` (and `_build_state`) on the JAX instance, so no JAX epoch
compiles and the JAX package runs unedited. Covered: a ragged last
window, a window lacking a class, one-hot and integer y, `normalize` on
and off, and the four errors (misaligned x/y, a feature mismatch, a late
class id, an empty corpus) with JAX's messages. Then: every optimizer's
step count after a corpus with an absent class is the closed form of
JAX's masked rounds (present rounds x loops x epochs); a captured epoch
is keyed by the present classes alone, the data tensors are refilled in
place, and a class draw reads its bound from the refilled device counts;
`--streamed` on a tiny corpus with `--device cpu` returns the JAX
pipeline's record keys.
"""

import numpy as np
import pytest
import torch

from cvaegan_tpu import CVAEGAN as JaxCVAEGAN
from cvaegan_tpu.core import config as jconfig
from cvaegan_tpu_torch import CVAEGAN
from cvaegan_tpu_torch.core import config as tconfig
from cvaegan_tpu_torch.data import sampler
from cvaegan_tpu_torch.pipelines import balance as tbalance

FEATURES, CLASSES, ROWS, WINDOW = 6, 3, 300, 128
# `cvaegan_tpu/pipelines/balance.py:238-300`: the keys of the record
# `run_streamed_pipeline` returns.
JAX_STREAMED_KEYS = {"model", "classifier", "multiclass_metrics", "binary_metrics", "mode",
                     "window_rows", "minmax_seconds", "gan_windows", "gan_fit_seconds",
                     "clf_windows", "clf_fit_seconds", "test_seconds", "total_seconds"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _labels():
    """Every class in the first 128-row window, none of class 2 in the
    second, a ragged third window of 44 rows."""
    first = np.arange(WINDOW) % CLASSES
    second = np.arange(WINDOW) % 2
    third = np.full(ROWS - 2 * WINDOW, 2)
    return np.concatenate([first, second, third])


def _corpus(path, onehot=True, y=None, features=FEATURES, rows=ROWS):
    y = _labels() if y is None else y
    x = np.random.default_rng(0).normal(y[:, None] * 3.0, 1.0, (rows, features))
    path.mkdir(parents=True, exist_ok=True)
    np.savetxt(path / "x.csv", x.astype(np.float32), delimiter=",", fmt="%.9g")
    np.savetxt(path / "y.csv", np.eye(CLASSES)[y] if onehot else y[:, None],
               delimiter=",", fmt="%d")
    return path / "x.csv", path / "y.csv"


def _settings(tmp_path, epochs=1):
    s = tconfig.Settings()
    s.gan.batch_size = 16
    s.gan.epochs = epochs
    s.paths = tconfig.Paths(root=tmp_path / "port")
    return s


def _jax_trainer(monkeypatch, tmp_path, windows):
    js = jconfig.Settings()
    js.paths = jconfig.Paths(root=tmp_path / "jax")
    jm = JaxCVAEGAN(seed=0, settings=js)
    jm.verbose = False
    monkeypatch.setattr(jm, "_build_state", lambda key: {})

    def record(epochs):
        d = jm._data
        windows.append({"samples": np.asarray(d["samples"]), "labels": np.asarray(d["labels"]),
                        "table": np.asarray(d["index"].table),
                        "counts": np.asarray(d["index"].counts), "epochs": epochs})

    monkeypatch.setattr(jm, "_fit_prepared", record)
    return jm


def _port_trainer(monkeypatch, tmp_path, windows):
    m = CVAEGAN(seed=0, device="cpu", settings=_settings(tmp_path))
    m.verbose = False

    def record(epochs, eager=False):
        d = m._data
        windows.append({"samples": d["samples"].numpy().copy(),
                        "labels": d["labels"].numpy().copy(),
                        "table": d["index"].table.numpy().copy(),
                        "counts": d["index"].counts.numpy().copy(), "epochs": epochs})

    monkeypatch.setattr(m, "_fit_prepared", record)
    return m


@pytest.mark.parametrize("onehot,normalize", [(True, True), (True, False), (False, True),
                                              (False, False)])
def test_windows_equal_jax(monkeypatch, tmp_path, onehot, normalize):
    x_csv, y_csv = _corpus(tmp_path / "corpus", onehot=onehot)
    got, want = [], []
    port = _port_trainer(monkeypatch, tmp_path, got)
    jax_ = _jax_trainer(monkeypatch, tmp_path, want)
    for trainer in (port, jax_):
        assert trainer.fit_streamed(x_csv, y_csv, window_rows=WINDOW, epochs_per_window=2,
                                    normalize=normalize) == 3
        assert (trainer.feature_num, trainer.label_num) == (FEATURES, CLASSES)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        assert g["samples"].dtype == np.float32 and g["samples"].shape == (WINDOW, FEATURES)
    assert (got[1]["counts"][2], got[2]["counts"].tolist()) == (0, [0, 0, ROWS - 2 * WINDOW])


def _misaligned(tmp_path):
    x_csv, y_csv = _corpus(tmp_path)
    y_csv.write_text("".join(y_csv.read_text().splitlines(keepends=True)[:-10]))
    return x_csv, y_csv, {}


def _feature_mismatch(tmp_path):
    x_csv, y_csv = _corpus(tmp_path)
    return x_csv, y_csv, {"built_for": 5}


def _late_class(tmp_path):
    y = np.concatenate([np.arange(WINDOW) % 2, np.full(ROWS - WINDOW, 2)])
    x_csv, y_csv = _corpus(tmp_path, onehot=False, y=y)
    return x_csv, y_csv, {}


def _empty(tmp_path):
    x_csv, y_csv = _corpus(tmp_path)
    x_csv.write_text("")
    return x_csv, y_csv, {}


@pytest.mark.parametrize("case", [_misaligned, _feature_mismatch, _late_class, _empty],
                         ids=lambda f: f.__name__[1:])
def test_errors_equal_jax(monkeypatch, tmp_path, case):
    x_csv, y_csv, opts = case(tmp_path / "corpus")
    port = _port_trainer(monkeypatch, tmp_path, [])
    jax_ = _jax_trainer(monkeypatch, tmp_path, [])
    if "built_for" in opts:
        n = opts["built_for"]
        port._prepare((np.zeros((6, n), np.float32), np.arange(6) % CLASSES))
        jax_.state, jax_.feature_num, jax_.label_num = {}, n, CLASSES
    messages = []
    for trainer in (port, jax_):
        with pytest.raises(ValueError) as e:
            trainer.fit_streamed(x_csv, y_csv, window_rows=WINDOW, epochs_per_window=1)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("balanced", [False, True])
def test_adam_counts_after_an_absent_class(tmp_path, balanced):
    """JAX masks an absent class's round (`_guard_class_round`), leaving
    the optimizer states, counts included, as they were; the port leaves
    the round out. Either way each count is the present rounds times the
    loops times the epochs."""
    x_csv, y_csv = _corpus(tmp_path / "corpus")
    s = _settings(tmp_path)
    m = CVAEGAN(seed=0, device="cpu", settings=s, balanced_mode=balanced)
    m.verbose = False
    epochs = 2
    assert m.fit_streamed(x_csv, y_csv, window_rows=WINDOW, epochs_per_window=epochs) == 3
    y = _labels()
    present = [len(np.unique(y[i:i + WINDOW])) for i in range(0, ROWS, WINDOW)]
    rounds = epochs * (len(present) if balanced else sum(present))
    cfg = s.gan
    want = {"encoder": rounds * cfg.g_loop_num, "generator": rounds * cfg.g_loop_num,
            "discriminator": rounds * cfg.d_loop_num, "classifier": rounds * cfg.c_loop_num}
    assert {k: int(opt.count) for k, opt in m.optimizers.items()} == want
    for k in m.loss_keys:
        assert len(m.loss_history[k]) == 3 * epochs and np.isfinite(m.loss_history[k]).all()
    assert m.generate_samples(1, 8).shape == (8, FEATURES)


def test_one_capture_key_per_present_class_pattern(tmp_path):
    """What a captured epoch reads on the host is which classes are
    present: windows of the same shapes refill the data tensors in place,
    the capture key changes only with the pattern, and a class draw's
    bound comes from the refilled device counts."""
    m = CVAEGAN(seed=0, device="cpu", settings=_settings(tmp_path))
    x = np.random.default_rng(0).random((60, FEATURES), dtype=np.float32)
    y_a = (np.arange(60) % CLASSES).astype(np.int32)
    m._prepare((x, y_a))

    def window(x, y):  # as `fit_streamed` gives a window of 60 rows
        m._set_data(x, y, sampler.ClassIndex.build(y, CLASSES, pad_to=60))

    window(x, y_a)
    samples, key = m._data["samples"], m._capture_key()
    y_b = np.concatenate([np.zeros(50), np.arange(10) % CLASSES]).astype(np.int32)
    window(np.arange(60 * FEATURES, dtype=np.float32).reshape(60, FEATURES), y_b)
    assert m._data["samples"] is samples and m._capture_key() == key
    assert m._data["index"].counts.tolist() == np.bincount(y_b).tolist()
    rows = sampler.sample_class_batch(m.generator, m._data["index"], m._data["samples"], 1,
                                      2000)[:, 0].long().numpy() // FEATURES
    assert set(rows) == set(np.nonzero(y_b == 1)[0])
    y_c = np.concatenate([np.zeros(30), np.ones(30)]).astype(np.int32)
    window(x, y_c)
    assert m._data["samples"] is samples and m._capture_key() != key
    assert m._class_rounds() == [0, 1]


def test_streamed_cli_returns_jax_keys(tmp_path):
    root = tmp_path / "corpus"
    _corpus(root)
    for split, name in (("train", "x.csv"), ("test", "x.csv")):
        (root / f"x_{split}.csv").write_bytes((root / name).read_bytes())
        (root / f"y_{split}.csv").write_bytes((root / "y.csv").read_bytes())
    settings, seed = tconfig.settings, tconfig.settings.seed
    paths = settings.paths
    settings.paths = tconfig.Paths(root=tmp_path / "data")
    try:
        with pytest.warns(UserWarning, match="--ema-filter"):
            result = tbalance.main(["--streamed", "--dataset", str(root), "--device", "cpu",
                                    "--window-rows", "100", "--epochs-per-window", "1",
                                    "--clf-epochs-per-window", "1", "--balanced-mode",
                                    "--ema-filter"])
    finally:
        settings.paths, settings.seed = paths, seed
    assert set(result) == JAX_STREAMED_KEYS
    assert (result["gan_windows"], result["clf_windows"], result["mode"]) == (3, 3, "out-of-core")
    assert result["model"].balanced_mode and "classifier" in result["model"].state
    assert 0.0 <= result["multiclass_metrics"]["F1"] <= 1.0
