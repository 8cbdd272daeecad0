"""On-device class-conditional batch sampling, the counterpart of
`cvaegan_tpu/data/sampler.py`.

The whole train set lives in device memory, and a padded `[label_num,
max_count]` index table lets a training step gather a class-conditional
batch with two indexing ops. Every draw comes from an explicit
`torch.Generator`, reads no value on the host and has a fixed shape, so
the sampling can run inside a captured CUDA graph: the class sizes a draw
needs as a bound (`torch.randint` takes a Python int) are known on the
host once the table is built.

Divergence note (as in the JAX package): rows are drawn with replacement
in all cases, where the reference samples without replacement when a
class has more rows than the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class ClassIndex:
    """Padded per-class row-index table for class-conditional gathers."""

    table: torch.Tensor        # [label_num, width] int32, rows padded with idx 0
    counts: torch.Tensor       # [label_num] int32 true class sizes, on the device
    host_counts: np.ndarray    # the same counts on the host

    @classmethod
    def build(cls, labels: np.ndarray, label_num: int, pad_to: Optional[int] = None,
              device="cpu") -> "ClassIndex":
        """`pad_to` fixes the table width (>= the largest class)."""
        labels = np.asarray(labels)
        counts = np.bincount(labels, minlength=label_num).astype(np.int32)
        max_count = max(int(counts.max()), 1)
        width = max_count if pad_to is None else int(pad_to)
        if width < max_count:
            raise ValueError(f"pad_to {width} < largest class {max_count}")
        table = np.zeros((label_num, width), dtype=np.int32)
        for c in range(label_num):
            idx = np.nonzero(labels == c)[0].astype(np.int32)
            table[c, : len(idx)] = idx
        return cls(table=torch.as_tensor(table, device=device),
                   counts=torch.as_tensor(counts, device=device), host_counts=counts)

    @property
    def label_num(self) -> int:
        return self.table.shape[0]

    def present(self) -> np.ndarray:
        """Ids of the classes with at least one row, in order."""
        return np.nonzero(self.host_counts > 0)[0]


def sample_class_batch(generator: torch.Generator, index: ClassIndex,
                       samples: torch.Tensor, class_id: int,
                       batch_size: int) -> torch.Tensor:
    """`batch_size` rows of `samples` of class `class_id`, uniform with
    replacement over the class's rows."""
    count = max(int(index.host_counts[class_id]), 1)
    r = torch.randint(0, count, (batch_size,), generator=generator,
                      device=samples.device)
    return samples[index.table[class_id][r]]


def present_labels(generator: torch.Generator, shape: Tuple[int, ...],
                   index: ClassIndex) -> torch.Tensor:
    """Uniform int64 label draws over the classes PRESENT in `index`: over
    [0, label_num) when every class is present, else over the present
    classes in order (an unbiased draw for any present count)."""
    present = index.present()
    device = index.table.device
    if len(present) in (0, index.label_num):
        return torch.randint(0, index.label_num, shape, generator=generator,
                             device=device)
    order = torch.as_tensor(present, dtype=torch.int64, device=device)
    return order[torch.randint(0, len(present), shape, generator=generator,
                               device=device)]


def sample_balanced_batch(generator: torch.Generator, index: ClassIndex,
                          samples: torch.Tensor, batch_size: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-balanced mixed batch: labels uniform over the present classes,
    rows uniform within each label's pool (`r % count`)."""
    labels = present_labels(generator, (batch_size,), index)
    counts = torch.clamp_min(index.counts[labels], 1)
    r = torch.randint(0, INT32_MAX, (batch_size,), generator=generator,
                      device=samples.device)
    return samples[index.table[labels, r % counts]], labels


def sample_random_batch(generator: torch.Generator, samples: torch.Tensor,
                        labels: torch.Tensor, batch_size: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform batch over the whole train set (reference `src/gan.py:149-185`)."""
    r = torch.randint(0, samples.shape[0], (batch_size,), generator=generator,
                      device=samples.device)
    return samples[r], labels[r]
