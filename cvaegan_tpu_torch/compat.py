"""Reference-workflow compatibility shim, the counterpart of
`cvaegan_tpu/compat.py`, over the port's `TabularDataset`.

The reference exposes its data as mutable module-level globals that
scripts re-assign and re-wrap (`src/datasets/__init__.py:19-44`,
`src/utils.py:18-92`). This module reproduces that surface so reference
users can migrate with minimal edits:

    from cvaegan_tpu_torch import compat as utils_and_datasets
    utils_and_datasets.set_random_state(0)
    utils_and_datasets.prepare_datasets()        # blobs fixture
    model = cvaegan_tpu_torch.CVAEGAN()
    model.fit(utils_and_datasets.TrDataset())    # wraps the globals
    ...
    utils_and_datasets.tr_samples = np.concatenate([...])  # augment
    model2.fit(utils_and_datasets.TrDataset())   # picks up mutations

Every trainer's `fit` and the `Classifier` take a `TrDataset`/`TeDataset`
through its `as_tuple()`. The rest of the port uses the explicit
`TabularDataset` API; this shim exists for drop-in migration.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from cvaegan_tpu_torch.core import config as config_lib
from cvaegan_tpu_torch.data.tabular import TabularDataset

# --- the reference's module-level globals (`src/datasets/__init__.py`) ---
tr_samples: np.ndarray = np.zeros((0, 0), np.float32)
tr_labels: np.ndarray = np.zeros((0,), np.int32)
te_samples: np.ndarray = np.zeros((0, 0), np.float32)
te_labels: np.ndarray = np.zeros((0,), np.int32)
feature_num: int = 0
label_num: int = 0


def set_random_state(seed: Optional[int] = None) -> None:
    """Reference `utils.set_random_state` (`src/utils.py:18-27`): here it
    sets the global settings seed that every trainer/classifier reads."""
    config_lib.settings.seed = config_lib.settings.seed if seed is None else seed
    np.random.seed(config_lib.settings.seed)


def set_dataset_values() -> None:
    """Recompute feature_num/label_num from the globals
    (`src/utils.py:30-32`)."""
    global feature_num, label_num
    feature_num = int(tr_samples.shape[1]) if tr_samples.size else 0
    label_num = int(tr_labels.max()) + 1 if tr_labels.size else 0


def prepare_datasets(name: Optional[str] = None) -> None:
    """Load a named CSV dataset or the synthetic blobs fixture into the
    globals (`src/utils.py:35-74`)."""
    global tr_samples, tr_labels, te_samples, te_labels
    if name is not None:
        from cvaegan_tpu_torch.pipelines.balance import load_dataset

        ds = load_dataset(name, seed=config_lib.settings.seed)
    else:
        ds = TabularDataset.synthetic_blobs(seed=config_lib.settings.seed)
    tr_samples, tr_labels = ds.tr_samples, ds.tr_labels
    te_samples, te_labels = ds.te_samples, ds.te_labels
    set_dataset_values()


def transfer_to_binary() -> None:
    """Squash labels > 0 to 1 in place (`src/utils.py:77-83`)."""
    global tr_labels, te_labels
    tr_labels = (tr_labels > 0).astype(np.int32)
    te_labels = (te_labels > 0).astype(np.int32)
    set_dataset_values()


def turn_on_test_mode() -> None:
    """Drop all epoch counts to 1 (`src/utils.py:86-92`)."""
    config_lib.turn_on_test_mode()


class TrDataset:
    """Snapshot view over the train globals, accepted by every trainer's
    fit() and by Classifier.fit() (reference `TrDataset`)."""

    split = "train"

    def __init__(self):
        self.samples = np.asarray(tr_samples, np.float32)
        self.labels = np.asarray(tr_labels, np.int32)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        return self.samples[idx], self.labels[idx]

    def as_tuple(self):
        return self.samples, self.labels


class TeDataset(TrDataset):
    """Snapshot view over the test globals (reference `TeDataset`)."""

    split = "test"

    def __init__(self):
        self.samples = np.asarray(te_samples, np.float32)
        self.labels = np.asarray(te_labels, np.int32)
