"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, keeps the JAX package's configuration defaults and fixtures in
its own copies, and never falls back quietly to the CPU."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import cvaegan_tpu_torch
from cvaegan_tpu.core import config as jconfig
from cvaegan_tpu.data import tabular as jtabular
from cvaegan_tpu_torch import CVAEGAN
from cvaegan_tpu_torch.core import config as tconfig
from cvaegan_tpu_torch.data import tabular as ttabular
from cvaegan_tpu_torch.kernels import fused_mlp

PACKAGE = pathlib.Path(cvaegan_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cvaegan_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax():
    code = ("import sys, cvaegan_tpu_torch, cvaegan_tpu_torch.convert\n"
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=PACKAGE.parent, timeout=120)
    loaded = [m for m in out.stdout.split() if _forbidden(m)]
    assert not loaded, loaded


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PACKAGE)))
def test_sources_import_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not [n for n in names if _forbidden(n)], (path, node.lineno)


def test_config_defaults_equal_jax():
    for cls in ("GanConfig", "ClassifierConfig", "Settings"):
        assert (dataclasses.asdict(getattr(tconfig, cls)())
                == dataclasses.asdict(getattr(jconfig, cls)())), cls
    assert tconfig.MODEL_CONFIGS == jconfig.MODEL_CONFIGS
    assert tconfig.Paths().root == jconfig.Paths().root


def test_turn_on_test_mode():
    old = (tconfig.settings.gan.epochs, tconfig.settings.classifier.epochs)
    try:
        tconfig.turn_on_test_mode()
        assert (tconfig.settings.gan.epochs, tconfig.settings.classifier.epochs) == (1, 1)
    finally:
        tconfig.settings.gan.epochs, tconfig.settings.classifier.epochs = old


def _same_dataset(a, b):
    for field in ("tr_samples", "tr_labels", "te_samples", "te_labels"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        assert getattr(a, field).dtype == getattr(b, field).dtype
    assert a.name == b.name


def test_tabular_copy_matches_jax():
    for fixture in ("synthetic_blobs", "imbalanced_classification"):
        t = getattr(ttabular.TabularDataset, fixture)(n_samples=200, seed=0)
        j = getattr(jtabular.TabularDataset, fixture)(n_samples=200, seed=0)
        _same_dataset(t, j)
        _same_dataset(t.renormalized(), j.renormalized())
        _same_dataset(t.to_binary(), j.to_binary())
        extra = np.random.default_rng(0).random((5, t.feature_num), dtype=np.float32)
        _same_dataset(t.append(extra, np.ones(5)), j.append(extra, np.ones(5)))
        assert t.label_num == j.label_num
        np.testing.assert_array_equal(t.class_counts(), j.class_counts())


def test_load_csv_matches_jax(tmp_path):
    path = tmp_path / "x.csv"
    path.write_text("1,2.5,abc\n,4,5\n7,8,9\n")
    np.testing.assert_array_equal(ttabular.load_csv(path), jtabular.load_csv(path))


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CVAEGAN()
    with pytest.raises(RuntimeError):
        CVAEGAN(device="cuda")
    assert CVAEGAN(device="cpu").device == torch.device("cpu")


def test_kernel_wrapper_rejects_other_devices():
    x = torch.zeros(2, 4, device="meta")
    ws = [torch.zeros(4, 4, device="meta") for _ in range(4)]
    bs = [torch.zeros(4, device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_mlp.fused_mlp4(x, ws, bs)
