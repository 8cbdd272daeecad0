"""The port's balance pipeline and CLI against the JAX package's.

A 2-epoch pipeline on the blob fixture (plot=False, on the CPU) must write
the JAX pipeline's artifact: a pickle of (tr_samples, tr_labels,
te_samples, te_labels), float32 samples and int32 labels, whose test
split and leading train rows are the JAX fixture's renormalised arrays
and whose counts add the generated rows. The port's CLI parses every
flag of the JAX CLI to the same values. Importing the new modules loads
nothing of JAX.
"""

import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import cvaegan_tpu_torch
from cvaegan_tpu.pipelines import balance as jbalance
from cvaegan_tpu_torch import CVAEGAN
from cvaegan_tpu_torch.core import config as tconfig
from cvaegan_tpu_torch.data.tabular import TabularDataset
from cvaegan_tpu_torch.pipelines import balance as tbalance

RESULT_KEYS = {"model", "classifier", "augmented", "multiclass_metrics",
               "binary_metrics", "pickle_path", "gen_stats", "seconds"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_pipeline_writes_the_jax_artifact(tmp_path, blob_dataset):
    settings = tconfig.Settings()
    settings.gan.epochs = 2
    settings.classifier.epochs = 2
    settings.paths = tconfig.Paths(root=tmp_path / "data")
    ds = TabularDataset.synthetic_blobs(seed=0)
    result = tbalance.run_balance_pipeline(
        CVAEGAN, "CVAE_GAN", ds, out_dir=tmp_path, settings=settings, plot=False,
        device="cpu")
    assert set(result) == RESULT_KEYS
    assert result["pickle_path"] == tmp_path / "data_cvae_gan.pkl"
    with open(result["pickle_path"], "rb") as f:
        arrays = pickle.load(f)
    assert isinstance(arrays, tuple) and len(arrays) == 4
    tr_x, tr_y, te_x, te_y = arrays
    assert (tr_x.dtype, tr_y.dtype, te_x.dtype, te_y.dtype) == (
        np.float32, np.int32, np.float32, np.int32)
    want = blob_dataset.renormalized()
    np.testing.assert_array_equal(te_x, want.te_samples)
    np.testing.assert_array_equal(te_y, want.te_labels)
    n = len(want.tr_samples)
    np.testing.assert_array_equal(tr_x[:n], want.tr_samples)
    np.testing.assert_array_equal(tr_y[:n], want.tr_labels)
    counts = np.bincount(want.tr_labels)
    added = np.bincount(tr_y[n:], minlength=len(counts))
    assert (counts + added <= counts.max()).all()
    np.testing.assert_array_equal(np.bincount(tr_y, minlength=len(counts)), counts + added)
    assert set(result["gen_stats"]) == set(range(5))
    for metrics in (result["multiclass_metrics"], result["binary_metrics"]):
        assert set(metrics) == {"Precision", "Recall", "F1"}
    # the downstream fit trained a copy: the trainer's filter is untouched
    assert result["classifier"].module is not result["model"].state["classifier"]


ARGV = [
    [],
    ["--dataset", "imbalanced", "--epochs", "7", "--clf-epochs", "3", "--seed", "4",
     "--out-dir", "out", "--test-mode", "--confidence-threshold", "0.7",
     "--balanced-mode", "--no-warm-start", "--ema-filter", "--window-rows", "10",
     "--epochs-per-window", "2", "--clf-epochs-per-window", "1"],
    ["--streamed"],
]


@pytest.mark.parametrize("argv", ARGV)
def test_cli_parses_the_jax_flags(argv):
    want = vars(jbalance.make_cli("jax").parse_args(argv))
    got = vars(tbalance.make_cli("port").parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got.pop("model") == "cvae_gan"
    assert got == want


def test_cli_device_and_unported_streamed(tmp_path):
    """`--streamed` is ported: over a directory without the corpus's CSVs
    it raises the JAX pipeline's `FileNotFoundError`."""
    args = tbalance.make_cli("port").parse_args(
        ["--device", "cpu", "--streamed", "--dataset", str(tmp_path)])
    assert args.device == "cpu" and args.streamed
    with pytest.raises(FileNotFoundError, match="corpus layout"):
        tbalance.run_from_cli(CVAEGAN, "CVAE_GAN", args)
    with pytest.raises(FileNotFoundError, match="corpus layout"):
        jbalance.run_streamed_pipeline(None, "CVAE_GAN", tmp_path)


def test_new_modules_load_no_jax():
    code = ("import sys\n"
            "import cvaegan_tpu_torch.pipelines.balance, cvaegan_tpu_torch.eval.classifier\n"
            "import cvaegan_tpu_torch.data.sampler, cvaegan_tpu_torch.core.schedules\n"
            "import cvaegan_tpu_torch.utils.introspection, cvaegan_tpu_torch.utils.logger\n"
            "print('\\n'.join(sorted(sys.modules)))")
    root = pathlib.Path(cvaegan_tpu_torch.__file__).parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=root, timeout=120)
    loaded = [m for m in out.stdout.split()
              if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cvaegan_tpu")]
    assert not loaded, loaded


def _csv_dir(path, rows=300, features=12, classes=5, seed=0):
    """A dataset directory of headerless `{x,y}_{train,test}.csv`, y one-hot."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-5.0, 5.0, (classes, features))
    y = np.arange(rows) % classes
    x = centres[y] + rng.standard_normal((rows, features))
    path.mkdir()
    for split, idx in (("train", slice(0, rows - 50)), ("test", slice(rows - 50, rows))):
        np.savetxt(path / f"x_{split}.csv", x[idx], delimiter=",")
        np.savetxt(path / f"y_{split}.csv", np.eye(classes)[y[idx]], delimiter=",", fmt="%d")
    return path


@pytest.mark.parametrize("model", ["qg_smote", "tmg_gan"])
def test_cli_runs_without_pandas_matplotlib_or_sklearn(monkeypatch, capsys, tmp_path, model):
    """The CLI as the GPU machine runs it (no pandas, matplotlib or sklearn):
    a csv dir loads through the standard `csv` module, and the pipeline
    writes its artifact and says once that it writes no plot."""
    from cvaegan_tpu_torch.algorithms.tmg_gan import TMGGAN

    data = _csv_dir(tmp_path / "data")
    settings = tconfig.Settings()
    settings.paths = tconfig.Paths(root=tmp_path / "paths")
    monkeypatch.setattr(tconfig, "settings", settings)
    monkeypatch.setattr(TMGGAN, "_said_no_plot", False)
    for name in ("pandas", "matplotlib", "sklearn"):
        monkeypatch.setitem(sys.modules, name, None)
    result = tbalance.main(["--model", model, "--dataset", str(data), "--epochs", "1",
                            "--clf-epochs", "1", "--device", "cpu",
                            "--out-dir", str(tmp_path / "out")])
    assert type(result["model"]).__name__ == tbalance.TRAINERS[model][0]
    assert result["pickle_path"].exists()
    assert len(result["augmented"].tr_labels) >= 250
    out = capsys.readouterr().out
    assert out.count("no plots are written: matplotlib is not installed") == 1


@pytest.mark.slow
def test_full_pipeline_reaches_macro_f1_one(tmp_path):
    """The reference budget (500 GAN epochs, 100 classifier epochs) on the
    blob fixture, on the CPU: the downstream classifier separates the
    blobs (`.claude/skills/verify/SKILL.md`: macro-F1 ~1.0)."""
    settings = tconfig.Settings()
    settings.paths = tconfig.Paths(root=tmp_path / "data")
    result = tbalance.run_balance_pipeline(
        CVAEGAN, "CVAE_GAN", TabularDataset.synthetic_blobs(seed=0), out_dir=tmp_path,
        settings=settings, plot=False, device="cpu")
    assert result["multiclass_metrics"]["F1"] >= 0.99
