"""Datasets as host arrays, and host-side batch iteration.

Counterpart of ctdd_tpu/data/loaders.py. A dataset is an in-memory integer
array; the training loop moves it to the device whole, or batch by batch
when it is larger than `training.device_data_bytes`.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from ctdd_tpu_torch import registry


class ArrayDataset:
    """An in-memory (N, ...) integer dataset with optional labels."""

    def __init__(self, data: np.ndarray, labels: Optional[np.ndarray] = None):
        self.data = data
        self.labels = labels

    def __len__(self):
        return self.data.shape[0]


def iterate_batches(dataset, batch_size: int, *, shuffle: bool = True,
                    seed: int = 0) -> Iterator:
    """Epoch-looping iterator of (batch, labels or None), numpy arrays; the
    last partial batch of an epoch is dropped."""
    rng = np.random.RandomState(seed)
    n = len(dataset)
    while True:
        idx = rng.permutation(n) if shuffle else np.arange(n)
        for s in range(0, n - n % batch_size, batch_size):
            batch_idx = idx[s : s + batch_size]
            labels = None if dataset.labels is None else dataset.labels[batch_idx]
            yield dataset.data[batch_idx], labels


def get_dataset(cfg, root: Optional[str] = None):
    """Resolve cfg.data.name through the dataset registry."""
    from ctdd_tpu_torch.data import images  # noqa: F401  (registers)

    return registry.datasets.get(cfg.data.name)(cfg, root)
