"""The port's class sampler against the JAX package's `data/sampler.py`.

Index tables must be identical. Draws come from different generators in
the two packages, so they are held to what they must be: only rows of
the asked class, no absent class ever drawn, and frequencies within a
chi-square bound (p = 1e-4) of uniform.
"""

import numpy as np
import pytest
import torch
from scipy import stats

from cvaegan_tpu.data.sampler import ClassIndex as JaxClassIndex
from cvaegan_tpu_torch.data import sampler as ts

DRAWS = 20_000


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _labels():
    """Five classes of 50, 20, 15, 10 and 5 rows, class 5 absent, shuffled."""
    labels = np.repeat(np.arange(5), [50, 20, 15, 10, 5]).astype(np.int32)
    return np.random.default_rng(0).permutation(labels), 6


def _uniform(counts, p=1e-4):
    counts = np.asarray(counts)
    _, pval = stats.chisquare(counts)
    assert pval > p, (counts, pval)


@pytest.mark.parametrize("pad_to", [None, 50, 64])
def test_class_index_tables_match_jax(pad_to):
    labels, label_num = _labels()
    got = ts.ClassIndex.build(labels, label_num, pad_to=pad_to)
    want = JaxClassIndex.build(labels, label_num, pad_to=pad_to)
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(want.table))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.host_counts, np.asarray(want.counts))
    assert got.table.dtype == torch.int32 and got.label_num == label_num
    np.testing.assert_array_equal(got.present(), [0, 1, 2, 3, 4])


def test_pad_to_below_largest_class_raises():
    labels, label_num = _labels()
    for build in (ts.ClassIndex.build, JaxClassIndex.build):
        with pytest.raises(ValueError, match="pad_to 49 < largest class 50"):
            build(labels, label_num, pad_to=49)


def test_class_batch_is_uniform_over_the_class():
    labels, label_num = _labels()
    index = ts.ClassIndex.build(labels, label_num)
    samples = torch.arange(len(labels), dtype=torch.float32)[:, None]
    g = torch.Generator().manual_seed(0)
    for c in (0, 4):
        rows = ts.sample_class_batch(g, index, samples, c, DRAWS)[:, 0].long().numpy()
        assert (labels[rows] == c).all()
        _uniform(np.bincount(rows, minlength=len(labels))[labels == c])


def test_present_labels_skip_absent_classes():
    labels, label_num = _labels()
    index = ts.ClassIndex.build(labels, label_num)
    g = torch.Generator().manual_seed(1)
    drawn = ts.present_labels(g, (DRAWS,), index).numpy()
    counts = np.bincount(drawn, minlength=label_num)
    assert counts[5] == 0
    _uniform(counts[:5])
    full = ts.ClassIndex.build(np.arange(DRAWS) % 3, 3)
    _uniform(np.bincount(ts.present_labels(g, (DRAWS,), full).numpy(), minlength=3))


def test_balanced_batch_labels_and_rows():
    labels, label_num = _labels()
    index = ts.ClassIndex.build(labels, label_num)
    samples = torch.arange(len(labels), dtype=torch.float32)[:, None]
    g = torch.Generator().manual_seed(2)
    x, y = ts.sample_balanced_batch(g, index, samples, DRAWS)
    rows, y = x[:, 0].long().numpy(), y.numpy()
    np.testing.assert_array_equal(labels[rows], y)
    counts = np.bincount(y, minlength=label_num)
    assert counts[5] == 0
    _uniform(counts[:5])
    _uniform(np.bincount(rows[y == 1], minlength=len(labels))[labels == 1])


def test_random_batch_is_uniform_over_rows():
    labels, _ = _labels()
    samples = torch.arange(len(labels), dtype=torch.float32)[:, None]
    g = torch.Generator().manual_seed(3)
    x, y = ts.sample_random_batch(g, samples, torch.from_numpy(labels), DRAWS)
    rows = x[:, 0].long().numpy()
    np.testing.assert_array_equal(labels[rows], y.numpy())
    _uniform(np.bincount(rows, minlength=len(labels)))
