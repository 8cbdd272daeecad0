"""Tabular dataset ingestion and fixtures.

A copy of `cvaegan_tpu/data/tabular.py`: an explicit `TabularDataset`
value object in place of the reference's import-time module-global
tensors (`src/datasets/__init__.py:11-44`). Arrays stay numpy on the
host; trainers move them to their device.

`load_csv` takes the pandas route only (the native C++ loader is ROADMAP
item A18). pandas and sklearn are imported lazily, inside the functions
that need them.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Optional, Tuple

import numpy as np


def load_csv(file_path) -> np.ndarray:
    """Headerless CSV -> float32 array, non-numeric coerced, NaN -> 0."""
    import pandas as pd

    data = pd.read_csv(file_path, header=None, low_memory=False)
    for col in data.columns:
        data[col] = pd.to_numeric(data[col], errors="coerce")
    data = data.fillna(0)
    return np.asarray(data.values, dtype=np.float32)


def minmax_scale(x: np.ndarray) -> np.ndarray:
    """Column-wise min-max to [0, 1]; constant columns map to 0."""
    lo = x.min(axis=0, keepdims=True)
    hi = x.max(axis=0, keepdims=True)
    span = np.where(hi - lo == 0.0, 1.0, hi - lo)
    return ((x - lo) / span).astype(np.float32)


@dataclasses.dataclass
class TabularDataset:
    """A train/test split of a labelled tabular dataset."""

    tr_samples: np.ndarray  # [n_train, feature_num] float32
    tr_labels: np.ndarray   # [n_train] int32
    te_samples: np.ndarray  # [n_test, feature_num] float32
    te_labels: np.ndarray   # [n_test] int32
    name: str = "unnamed"

    def __post_init__(self):
        self.tr_samples = np.asarray(self.tr_samples, np.float32)
        self.te_samples = np.asarray(self.te_samples, np.float32)
        self.tr_labels = np.asarray(self.tr_labels, np.int32)
        self.te_labels = np.asarray(self.te_labels, np.int32)

    @property
    def feature_num(self) -> int:
        return int(self.tr_samples.shape[1])

    @property
    def label_num(self) -> int:
        labels = self.tr_labels
        return int(labels.max()) + 1 if labels.size else 0

    def class_counts(self) -> np.ndarray:
        return np.bincount(self.tr_labels, minlength=self.label_num)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_csv_dir(cls, dataset_dir, name: Optional[str] = None) -> "TabularDataset":
        """Load `{x,y}_{train,test}.csv` from a directory (reference
        `src/datasets/__init__.py:19-27`). y files are one-hot; argmax'd."""
        dataset_dir = pathlib.Path(dataset_dir)
        tr_x = load_csv(dataset_dir / "x_train.csv")
        tr_y = load_csv(dataset_dir / "y_train.csv").argmax(axis=1)
        te_x = load_csv(dataset_dir / "x_test.csv")
        te_y = load_csv(dataset_dir / "y_test.csv").argmax(axis=1)
        return cls(tr_x, tr_y, te_x, te_y, name=name or dataset_dir.name)

    @classmethod
    def synthetic_blobs(
        cls,
        n_samples: int = 1000,
        n_features: int = 30,
        centers: int = 5,
        test_size: float = 0.1,
        seed: Optional[int] = None,
    ) -> "TabularDataset":
        """The reference's test fixture (`src/utils.py:54-74`): gaussian
        blobs, minmax-scaled, 90/10 split."""
        from sklearn.datasets import make_blobs
        from sklearn.model_selection import train_test_split

        samples, labels = make_blobs(
            n_samples, n_features=n_features, centers=centers, random_state=seed
        )
        samples = minmax_scale(samples.astype(np.float32))
        tr_x, te_x, tr_y, te_y = train_test_split(
            samples, labels, test_size=test_size, random_state=seed
        )
        return cls(tr_x, tr_y, te_x, te_y, name="blobs")

    @classmethod
    def imbalanced_classification(
        cls,
        n_samples: int = 1000,
        n_features: int = 30,
        n_classes: int = 5,
        weights: Tuple[float, ...] = (0.5, 0.3, 0.1, 0.05, 0.05),
        test_size: float = 0.1,
        seed: Optional[int] = None,
    ) -> "TabularDataset":
        """The reference's intended imbalance fixture (commented-out
        `make_classification` variant, `src/utils.py:57-65`)."""
        from sklearn.datasets import make_classification
        from sklearn.model_selection import train_test_split

        samples, labels = make_classification(
            n_samples=n_samples,
            n_features=n_features,
            n_informative=n_features - 2,
            n_redundant=0,
            n_classes=n_classes,
            n_clusters_per_class=2,
            weights=list(weights),
            random_state=seed,
        )
        samples = minmax_scale(samples.astype(np.float32))
        tr_x, te_x, tr_y, te_y = train_test_split(
            samples, labels, test_size=test_size, random_state=seed,
            stratify=labels,
        )
        return cls(tr_x, tr_y, te_x, te_y, name="imbalanced")

    # -- transforms ---------------------------------------------------------
    def renormalized(self) -> "TabularDataset":
        """Concat train+test, minmax over the union, re-split at the same
        boundary (`scripts/train_cvae_gan.py:17-43`)."""
        n_tr = len(self.tr_samples)
        allx = np.concatenate([self.tr_samples, self.te_samples], axis=0)
        allx = minmax_scale(allx)
        return TabularDataset(
            allx[:n_tr], self.tr_labels, allx[n_tr:], self.te_labels, self.name
        )

    def to_binary(self) -> "TabularDataset":
        """Squash labels > 0 to 1 (`src/utils.py:77-83`)."""
        return TabularDataset(
            self.tr_samples,
            (self.tr_labels > 0).astype(np.int32),
            self.te_samples,
            (self.te_labels > 0).astype(np.int32),
            self.name,
        )

    def append(self, samples: np.ndarray, labels: np.ndarray) -> "TabularDataset":
        """Return a dataset with generated samples appended to the train
        split (`scripts/train_cvae_gan.py:91-92`)."""
        samples = np.asarray(samples, np.float32)
        labels = np.asarray(labels, np.int32)
        if samples.size == 0:
            return self
        return TabularDataset(
            np.concatenate([self.tr_samples, samples], axis=0),
            np.concatenate([self.tr_labels, labels], axis=0),
            self.te_samples,
            self.te_labels,
            self.name,
        )
