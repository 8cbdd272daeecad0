"""Ring (context-parallel) attention over a gloo ring
(`cvaegan_tpu_torch/kernels/ring_attention.py`) against the JAX package's
(`cvaegan_tpu/kernels/ring_attention.py`, its `shard_map` + `ppermute`
ring on conftest's virtual CPU devices) and against the port's dense
plain versions (`kernels/block_attention.py::reference_attention`,
`reference_attention_entropy`), at `tests/test_kernels.py:187-230`'s
shapes and tolerance (2e-5), on rings of 2 and 4 ranks; a sequence the
ring does not divide raises. Inputs are drawn by numpy from a seed. The
worlds are spawned once for the module
(`torch_port_parallel_worker.start_world`)."""

import pathlib
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from cvaegan_tpu.kernels import ring_attention as jring

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from torch_port_parallel_worker import job, start_world  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
#: name -> [bh, seq, d]: `test_ring_attention_matches_reference`'s and
#: `test_ring_attention_entropy_parity`'s shapes
SHAPES = {"t256": (4, 256, 32), "t64": (2, 64, 16)}
RINGS = (2, 4)


def _cases():
    rng = np.random.default_rng(0)
    return {name: tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3))
            for name, shape in SHAPES.items()}


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    cases = _cases()
    root = tmp_path_factory.mktemp("rings")
    waits = {n: start_world(root / f"w{n}", n, [("ring", dict(cases=cases))])
             for n in RINGS}
    jax_out = {}
    for n in RINGS:
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(n,), ("data",))
        for name, (q, k, v) in cases.items():
            out, ent = jring.ring_attention(q, k, v, mesh=mesh, axis="data",
                                            with_entropy=True)
            jax_out[n, name] = (np.asarray(out), np.asarray(ent))
    return {n: job(waits[n](), "ring") for n in RINGS}, jax_out


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("n", RINGS)
def test_ring_attention_matches_jax_and_plain(rings, n, name):
    results, jax_out = rings
    jax_att, jax_ent = jax_out[n, name]
    for res in results[n]:  # every rank returns the global result
        got = res[name]
        np.testing.assert_allclose(got["out"], jax_att, **TOL)
        np.testing.assert_allclose(got["ent"], jax_ent, **TOL)
        np.testing.assert_allclose(got["out"], got["ref"], **TOL)
        np.testing.assert_allclose(got["ent"], got["ref_ent"], **TOL)
        np.testing.assert_allclose(got["plain_out"], got["ref"], **TOL)
        np.testing.assert_array_equal(got["plain_out"], got["out"])


@pytest.mark.parametrize("n", RINGS)
def test_ring_attention_uneven_seq_raises(rings, n):
    results, _ = rings
    for res in results[n]:
        for name in SHAPES:
            assert "must divide seq" in res[name]["uneven"]
