"""The port's streaming ingestion and streamed evaluation against the JAX
package's.

Readers: the port's `StreamingCSV`, native (its own copy of
`stream_reader.cpp`, built into `cvaegan_tpu_torch/_build/`) and plain
(Python, where no C++ compiler exists), give chunks equal to the JAX
package's `StreamingCSV`, exactly, on garbage cells, ragged rows, a blank
first line, a chunk size that divides the row count and random floats;
an empty file raises `ValueError` and a missing one `FileNotFoundError`
in both; two iterators of one reader are independent; `stream_minmax`
and the native whole-file loader equal JAX's. Streamed evaluation: with
the JAX `Classifier`'s weights carried across, `test_streamed` gives
JAX's confusion matrix and metrics on the same CSVs (logits at rtol 1e-5,
atol 1e-6, the tolerance of two float32 forwards; every row's top two
logits lie farther apart than that, so the predictions must be equal),
`predict_stream` equals `predict`, and `Classifier.fit_streamed` hands
each window to training padded and weighted as JAX's `_fit_arrays`
receives it. No JAX epoch compiles: the JAX side stops at the reader,
an eval forward or the window handed to `_fit_arrays`.
"""

import jax
import numpy as np
import pytest
import torch

from cvaegan_tpu.core import config as jconfig
from cvaegan_tpu.data import native_csv as jnative
from cvaegan_tpu.data import streaming as jstreaming
from cvaegan_tpu.eval.classifier import Classifier as JaxClassifier
from cvaegan_tpu_torch import Classifier
from cvaegan_tpu_torch.convert import load_net
from cvaegan_tpu_torch.core import config as tconfig
from cvaegan_tpu_torch.data import _native_build, native_csv, streaming

TOL = dict(rtol=1e-5, atol=1e-6)
FEATURES, CLASSES = 7, 4

CASES = {
    "garbage": ("1.5,abc,3\nnan,2.5,\n7,8,9", (1, 2, 10)),
    "ragged": ("1,2\n3,4,5\n6\n", (1, 2)),
    "blank_first_line": ("\n1,2,3\n4,5,6\n", (1, 10)),
    "divides": ("".join(f"{2 * i},{2 * i + 1}\n" for i in range(6)), (3,)),
    "cells": ("\r\n 1 ,\t2\r\n\r\n0x1p3,1e50\n+5,1_0,\"9\"\n-nan,.5\ninfinity,1e-50\n", (2, 3)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(params=["native", "plain"])
def backend(request, monkeypatch):
    if request.param == "plain":
        monkeypatch.setattr(streaming, "_get_lib", lambda: None)
    return request.param


def _random_csv(path, rows=300, cols=FEATURES, seed=0):
    data = np.random.default_rng(seed).normal(size=(rows, cols)).astype(np.float32)
    np.savetxt(path, data, delimiter=",", fmt="%.9g")
    return data


def _same_chunks(got, want):
    assert [c.shape for c in got] == [c.shape for c in want]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunks_equal_jax(case, backend, tmp_path):
    text, chunk_sizes = CASES[case]
    path = tmp_path / f"{case}.csv"
    path.write_text(text)
    for rows in chunk_sizes:
        reader = streaming.StreamingCSV(path, rows)
        assert reader.backend == backend
        _same_chunks(list(reader), list(jstreaming.StreamingCSV(path, rows)))


def test_random_floats_equal_jax(backend, tmp_path):
    path = tmp_path / "x.csv"
    data = _random_csv(path)
    got = list(streaming.StreamingCSV(path, 128))
    assert [len(c) for c in got] == [128, 128, 44]
    _same_chunks(got, list(jstreaming.StreamingCSV(path, 128)))
    np.testing.assert_array_equal(np.concatenate(got), data)


def test_empty_and_missing_files_raise(backend, tmp_path):
    for text in ("", "\n\n", "\r\n"):
        path = tmp_path / "empty.csv"
        path.write_text(text)
        for reader in (streaming.StreamingCSV, jstreaming.StreamingCSV):
            with pytest.raises(ValueError, match="empty csv"):
                list(reader(path, 10))
    with pytest.raises(FileNotFoundError):
        list(streaming.StreamingCSV(tmp_path / "nope.csv", 10))


def test_two_iterators_are_independent(backend, tmp_path):
    path = tmp_path / "x.csv"
    data = _random_csv(path)
    with streaming.StreamingCSV(path, 64) as reader:
        it1, it2 = iter(reader), iter(reader)
        first1, first2 = next(it1), next(it2)
        np.testing.assert_array_equal(first1, first2)
        np.testing.assert_array_equal(np.concatenate([first1, *it1]), data)
        np.testing.assert_array_equal(np.concatenate([first2, *it2]), data)
    reader.close()


def test_stream_minmax_and_loaders_equal_jax(tmp_path):
    path = tmp_path / "x.csv"
    data = _random_csv(path)
    for got, want in zip(streaming.stream_minmax(path, 77), jstreaming.stream_minmax(path, 77)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(streaming.stream_minmax(path, 77)[0], data.min(axis=0))
    loaded = streaming.load_csv_streamed(path, 100, device="cpu")
    assert isinstance(loaded, torch.Tensor) and loaded.device.type == "cpu"
    np.testing.assert_array_equal(loaded.numpy(), data)
    chunks = list(streaming.prefetch_to_device(streaming.StreamingCSV(path, 64), size=2,
                                               device="cpu"))
    np.testing.assert_array_equal(torch.cat(chunks).numpy(), data)
    garbage = tmp_path / "garbage.csv"
    garbage.write_text(CASES["garbage"][0] + "\n\n1,2,3,4\n")
    np.testing.assert_array_equal(native_csv.load_csv_native(garbage),
                                  jnative.load_csv_native(garbage))


def test_native_libraries_are_built_beside_the_kernels():
    for source in (streaming.SOURCE, native_csv.SOURCE):
        path = _native_build.library_path(source)
        assert path.parent.name == "_build" and path.parent.parent.name == "cvaegan_tpu_torch"
        assert path.exists() and path.stem.startswith(source.split(".")[0] + "-")


def test_no_compiler_says_so_once(monkeypatch, capsys):
    def no_compiler(*args, **kwargs):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(_native_build, "_CACHE", {})
    monkeypatch.setattr(_native_build, "library_path",
                        lambda source: _native_build.BUILD_DIR / "absent" / "none.so")
    monkeypatch.setattr(_native_build.subprocess, "run", no_compiler)
    assert streaming.StreamingCSV("x.csv").backend == "plain"
    assert streaming.StreamingCSV("x.csv").backend == "plain"
    assert capsys.readouterr().out.count("no C++ compiler") == 1


# ------------------------------------------------------- streamed evaluation
def _pair(tmp_path):
    """A JAX classifier and the port's with its weights; CSVs of 150 rows,
    y as one integer column (classes 0-3) or one-hot."""
    settings = tconfig.Settings()
    settings.paths = tconfig.Paths(root=tmp_path / "port")
    jsettings = jconfig.Settings()
    jsettings.paths = jconfig.Paths(root=tmp_path / "jax")
    jc = JaxClassifier("j", seed=0, settings=jsettings)
    jc._ensure_built(FEATURES, CLASSES)
    tc = Classifier("t", seed=0, settings=settings, device="cpu")
    tc._ensure_built(FEATURES, CLASSES)
    load_net(tc.module, jax.device_get({"params": jc.params}))
    rng = np.random.default_rng(1)
    x = (rng.random((150, FEATURES)) * 20 - 5).astype(np.float32)
    y = rng.integers(0, CLASSES, 150)
    np.savetxt(tmp_path / "x.csv", x, delimiter=",", fmt="%.9g")
    np.savetxt(tmp_path / "y.csv", y[:, None], delimiter=",", fmt="%d")
    np.savetxt(tmp_path / "y1h.csv", np.eye(CLASSES)[y], delimiter=",", fmt="%d")
    return jc, tc, x, y


@pytest.mark.parametrize("binary", [False, True])
def test_test_streamed_equals_jax(binary, tmp_path):
    jc, tc, x, _ = _pair(tmp_path)
    lo, hi = x.min(axis=0), x.max(axis=0)

    def tf(chunk):
        return (chunk - lo) / (hi - lo)

    want_logits = jc.predict(tf(x), use_prob=True)
    got_logits = tc.predict(tf(x), use_prob=True)
    np.testing.assert_allclose(got_logits, want_logits, **TOL)
    top2 = np.sort(want_logits, axis=1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > TOL["atol"] + TOL["rtol"] * np.abs(top2[:, 1]))
    for y_csv in ("y.csv", "y1h.csv"):
        jc.test_streamed(tmp_path / "x.csv", tmp_path / y_csv, chunk_rows=32,
                         binary=binary, transform=tf)
        tc.test_streamed(tmp_path / "x.csv", tmp_path / y_csv, chunk_rows=32,
                         binary=binary, transform=tf)
        np.testing.assert_array_equal(tc.confusion_matrix, jc.confusion_matrix)
        assert tc.metrics == pytest.approx(jc.metrics, abs=1e-12)


def test_predict_stream_equals_predict(tmp_path):
    _, tc, x, _ = _pair(tmp_path)
    whole = tc.predict(x, use_prob=True)
    chunked = tc.predict_stream((x[i:i + 32] for i in range(0, len(x), 32)), use_prob=True)
    np.testing.assert_array_equal(chunked, whole)
    np.testing.assert_array_equal(
        tc.predict_stream(streaming.StreamingCSV(tmp_path / "x.csv", 50)), tc.predict(x))
    with pytest.raises(ValueError, match="empty chunk iterable"):
        tc.predict_stream([])
    (tmp_path / "y_short.csv").write_text("1\n2\n")
    for run in (tc.fit_streamed, tc.test_streamed):
        with pytest.raises(ValueError, match="misaligned"):
            run(tmp_path / "x.csv", tmp_path / "y_short.csv", 64)


def test_fit_streamed_windows_equal_jax(monkeypatch, tmp_path):
    """Each window reaches training as JAX's `_fit_arrays` receives it:
    rows (scaled by `transform`), labels and weights, the short last
    window padded with its own rows at weight 0; the plain loop runs
    ceil(rows / batch) steps per epoch, every padded row at weight 0."""
    jc, tc, x, y = _pair(tmp_path)
    window = 64

    def tf(chunk):
        return chunk * 0.5

    recorded = {"jax": [], "port": []}

    def record(side):
        def fit_arrays(x, y, epochs, opt_state, weights=None, **kwargs):
            recorded[side].append((np.array(x), np.array(y), epochs, np.array(weights)))
            return opt_state
        return fit_arrays

    monkeypatch.setattr(jc, "_fit_arrays", record("jax"))
    assert jc.fit_streamed(tmp_path / "x.csv", tmp_path / "y1h.csv", window_rows=window,
                           epochs_per_window=2, transform=tf) == 3
    steps = []
    step = tc._step

    def count(opt, bx, by, bw):
        steps.append(bw.clone())
        return step(opt, bx, by, bw)

    monkeypatch.setattr(tc, "_step", count)
    fit_arrays = tc._fit_arrays

    def port_fit_arrays(x, y, epochs, opt, weights=None, eager=False):
        recorded["port"].append((np.array(x), np.array(y), epochs, np.array(weights)))
        return fit_arrays(x, y, epochs, opt, weights=weights, eager=eager)

    monkeypatch.setattr(tc, "_fit_arrays", port_fit_arrays)
    assert tc.fit_streamed(tmp_path / "x.csv", tmp_path / "y1h.csv", window_rows=window,
                           epochs_per_window=2, transform=tf) == 3
    assert len(recorded["port"]) == len(recorded["jax"]) == 3
    for (px, py, pe, pw), (jx, jy, je, jw) in zip(recorded["port"], recorded["jax"]):
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(py, jy)
        np.testing.assert_array_equal(pw, jw)
        assert pe == je == 2
    assert recorded["port"][-1][3][150 - 2 * window:].sum() == 0
    bs = tc.cfg.batch_size
    assert len(steps) == 3 * 2 * -(-window // bs)
    last = torch.cat(steps[-(-(-window // bs)):])
    assert float(last.sum()) == 150 - 2 * window
