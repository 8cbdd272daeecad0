"""`SeedBank(mesh=...)` (`cvaegan_tpu_torch/algorithms/seed_bank.py`), the
counterpart of the JAX package's replica axis sharded over 'data'
(`cvaegan_tpu/algorithms/seed_bank.py:80-86,155-170`): on a 2-rank gloo
world, a bank of K = 4 CVAE-GANs trains 2 replicas on each data rank, with
no collective inside the epoch, and every rank ends holding all 4. Each
replica's loss history and state equal the unmeshed bank's, and every
rank holds the same replica k; seeds the data axis does not divide raise
`ValueError`. The world is spawned once for the module
(`torch_port_parallel_worker.start_world`)."""

import pathlib
import sys

import numpy as np
import pytest
import torch

from cvaegan_tpu_torch import CVAEGAN, SeedBank

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import torch_port_parallel_worker as worker  # noqa: E402
from torch_port_parallel_worker import job, start_world  # noqa: E402

SEEDS = [0, 1, 2, 3]
BATCH, EPOCHS = 16, 2


def _data():
    rng = np.random.default_rng(0)
    x = rng.random((200, 12), dtype=np.float32)
    return x, (np.arange(200) % 5).astype(np.int32)


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    x, y = _data()
    wait = start_world(tmp_path_factory.mktemp("bank"), 2, [
        ("seed_bank", dict(x=x, y=y, batch_size=BATCH, seeds=SEEDS, epochs=EPOCHS))])
    torch.set_num_threads(1)
    plain = SeedBank(CVAEGAN, seeds=SEEDS, settings=worker.settings(BATCH, EPOCHS),
                     device="cpu")
    trainers = plain.fit([(x, y)] * len(SEEDS))
    return job(wait(), "seed_bank"), trainers


@pytest.mark.parametrize("k", range(len(SEEDS)))
def test_meshed_bank_replica_matches_unmeshed(banks, k):
    out, trainers = banks
    assert [res["held"] for res in out] == [SEEDS[:2], SEEDS[2:]]
    plain = trainers[k]
    for res in out:
        assert res["digests"][k] == worker.digest(plain._static_tensors()[:-1])
        assert res["rng"][k] == worker.digest([plain.generator.get_state()])
        for key, values in res["histories"][k].items():
            assert len(values) == EPOCHS
            np.testing.assert_array_equal(values, plain.loss_history[key], err_msg=key)
        assert res["steps_per_sec_positive"]


def test_meshed_bank_refuses_seeds_the_axis_does_not_divide(banks):
    out, _ = banks
    for res in out:
        assert res["uneven"] == "3 seeds do not divide the mesh's 'data' axis (2)"
