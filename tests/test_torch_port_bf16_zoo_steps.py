"""The bf16 policy on CTGAN's, TMG-GAN's and QG-SMOTE's steps, against the
JAX package's: the gate and the method of `tests/test_torch_port_bf16_zoo.py`
(which holds six trainers' steps and the eval forwards), in a module of its
own so that neither takes long alone."""

import pytest
import torch
from test_torch_port_bf16 import bf16  # noqa: F401  (a fixture)
from test_torch_port_bf16_zoo import CASES, check_step

NAMES = ("CTGAN", "TMGGAN", "QG_SMOTE")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("name,kind", [c for c in CASES if c[0] in NAMES])
def test_step_as_exact_as_jax(name, kind, blob_dataset, bf16, monkeypatch):  # noqa: F811
    """One step under the policy, held as `test_torch_port_bf16_zoo.py`'s
    steps are (`check_step`)."""
    check_step(name, kind, blob_dataset, monkeypatch)
