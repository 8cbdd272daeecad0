"""The controls on the card (`control.py`), at the cells' widths, batch
and schedule on 100k frames. Marked `cuda`: they skip without a card.

Every planted fault, and the precision control (every product in
TF32), fails at least one of its cell's compared numbers."""

import pytest
import torch

from bench_port import control
from bench_port.harness import spec

SEEDS = (2**31 + 101, 2**31 + 141, 2**31 + 181)


def _readings(workload, seed, device):
    c = spec.cell(workload)
    traffic = {**c["traffic"], "frames": 100_000, "frames_per_replica": 20_000}
    module = spec.load_module(c["driver_path"], "control_driver")
    driver = module.Driver({"cfg": c["cfg"], "traffic": traffic, "seed": seed,
                            "device": device, "cell": workload, "limits": c["limits"]})
    if c["traffic"]["driver"] == "generate_fast":
        return c, control.generate_controls(driver, window_calls=40)
    return c, control.fit_controls(driver)


def _fails(limits, numbers):
    return any(numbers[name] > limit for name, limit in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["cvaegan.fit.strict", "cvaegan.bank20.strict",
                                      "cvaegan.gen.fast"])
@pytest.mark.parametrize("seed", SEEDS)
def test_the_controls(card, workload, seed):
    torch.backends.cuda.matmul.allow_tf32 = False
    c, readings = _readings(workload, seed, card)
    limits = c["limits"]["limits"]
    for stand_in, numbers in readings.items():
        assert _fails(limits, numbers), (stand_in, numbers)
    print(workload, seed, readings)
