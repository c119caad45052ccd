"""Datasets as host arrays, and host-side batch iteration.

Counterpart of ctdd_tpu/data/loaders.py. A dataset is an in-memory integer
array; the training loop moves it to the device whole, or batch by batch
when it is larger than `training.device_data_bytes`. Registered here:
`SyntheticData` (the binarized 2D toy sets of data/synthetic.py); the maze,
sudoku and protein sets register in their own modules, which `get_dataset`
imports.
"""

from __future__ import annotations

import os
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


def mix_pool_seed(base_seed: int, epoch: int) -> int:
    """Generator seed of a `data.stream_fresh` pool keyed by (data.seed,
    epoch), well mixed: a plain gen(epoch) key would replay pool k of base
    seed 0 as pool 0 of base seed k."""
    ss = np.random.SeedSequence([int(base_seed), int(epoch)])
    return int(ss.generate_state(1, np.uint64)[0] & 0x7FFFFFFF)


def iterate_batches(dataset, batch_size: int, *, shuffle: bool = True,
                    seed: int = 0, drop_last: bool = True) -> Iterator:
    """Epoch-looping iterator of (batch, labels or None), numpy arrays; the
    last partial batch of an epoch is dropped unless `drop_last` is off."""
    rng = np.random.RandomState(seed)
    n = len(dataset)
    while True:
        idx = rng.permutation(n) if shuffle else np.arange(n)
        end = n - n % batch_size if drop_last else n
        for s in range(0, end, batch_size):
            batch_idx = idx[s : s + batch_size]
            labels = None if dataset.labels is None else dataset.labels[batch_idx]
            yield dataset.data[batch_idx], labels


@registry.datasets.register(name="SyntheticData")
def synthetic_data(cfg, root: Optional[str] = None) -> ArrayDataset:
    """Binarized 2D synthetic data, (N, D) int32 bits: the .npy at
    cfg.data.location where it exists, else generated from seed 0
    (`data.num_samples` rows, 100000 by default)."""
    from ctdd_tpu_torch.data.synthetic import generate_dataset

    path = root or cfg.data.get("location", "")
    if path and os.path.exists(path):
        data = np.load(path)
    else:
        data, _ = generate_dataset(
            cfg.data.type, int(cfg.data.get("num_samples", 100000)),
            discrete_dim=cfg.data.shape[0], binmode=cfg.data.get("binmode", "gray"),
            seed=0)
    return ArrayDataset(data.astype(np.int32))


def get_dataset(cfg, root: Optional[str] = None):
    """Resolve cfg.data.name through the dataset registry."""
    from ctdd_tpu_torch.data import images, maze, protein, sudoku  # noqa: F401  (register)

    return registry.datasets.get(cfg.data.name)(cfg, root)
