"""The bf16 policy on RAIN-GAN's D, C and E+G steps and eval forwards,
against the JAX package's: the gate and the method of
`tests/test_torch_port_bf16_zoo.py`, in a module of its own (RAIN-GAN is
the slowest trainer to trace and step).

Its D step is held on the float64 generator's fake rows (`SAME_ROWS`):
the generator ends in a bf16 sigmoid, which torch rounds correctly and
XLA does not (`test_bf16_sigmoid_is_correctly_rounded`), and on each
package's own rows the loss gap between the two is that of their rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_bf16 import bf16  # noqa: F401  (a fixture)
from test_torch_port_bf16_zoo import KINDS, check_eval_forwards, check_step


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("kind", KINDS["RAIN_GAN"])
def test_step_as_exact_as_jax(kind, blob_dataset, bf16, monkeypatch):  # noqa: F811
    check_step("RAIN_GAN", kind, blob_dataset, monkeypatch)


def test_eval_forwards_as_exact_as_jax(blob_dataset, bf16):  # noqa: F811
    check_eval_forwards("RAIN_GAN", blob_dataset)


def test_bf16_sigmoid_is_correctly_rounded():
    """At the generator head's scale (pre-activations of a few hundredths,
    outputs near 0.5, where the bf16 ulp doubles), torch's bf16 sigmoid is
    the float64 sigmoid rounded to bf16 on every element; XLA's differs on
    about a third, biased upwards (~3e-4 on the mean). So the two packages'
    fake rows carry rounding of another pattern, the port's the smaller."""
    rng = np.random.default_rng(0)
    h = torch.from_numpy((0.02 * rng.standard_normal(20000)).astype(np.float32)).bfloat16()
    exact = torch.sigmoid(h.double())
    rounded = exact.bfloat16()
    port = torch.sigmoid(h)
    xla = torch.from_numpy(np.asarray(jax.jit(jax.nn.sigmoid)(
        jnp.asarray(h.float().numpy(), jnp.bfloat16)), np.float32)).bfloat16()
    assert torch.equal(port, rounded)
    assert float((xla != rounded).float().mean()) > 0.2
    half_ulp = (exact.abs().log2().floor() - 7).exp2() / 2  # 8 significant bits
    assert bool(((port.double() - exact).abs() <= half_ulp).all())
    assert float((xla.double() - exact).abs().max()) > float(half_ulp.max())
    assert float((xla.double() - exact).mean()) > 4 * abs(float((port.double() - exact).mean()))
