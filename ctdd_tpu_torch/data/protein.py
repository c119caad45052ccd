"""Protein (GRAMPA) sequence datasets.

The port's copy of ctdd_tpu/data/protein.py: the CHAR2IDX/IDX2CHAR maps,
the padding helpers and the ProteinGrampa/ProteinStream loaders of the
(N, L) residue-index `.npy` at `data.location`. Where that file is absent
(it is not in the repository), a seeded stand-in pool of padded random
sequences, the JAX package's own, keeps the pipeline runnable.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ctdd_tpu_torch import registry
from ctdd_tpu_torch.data.loaders import ArrayDataset

CHAR2IDX = {
    "A": 0, "R": 1, "N": 2, "D": 3, "C": 4, "Q": 5, "E": 6, "G": 7, "H": 8,
    "I": 9, "L": 10, "K": 11, "M": 12, "F": 13, "P": 14, "S": 15, "T": 16,
    "W": 17, "Y": 18, "V": 19, "-": 20,
}
IDX2CHAR = {v: k for k, v in CHAR2IDX.items()}


def pad_sequence(seq: str, max_length: int = 48, pad_char: str = "-") -> str:
    return seq.ljust(max_length, pad_char)


def sequence_to_numbers(seq: str):
    return [CHAR2IDX[c] for c in seq]


def numbers_to_sequence(numbers):
    return "".join(IDX2CHAR[int(n)] for n in numbers)


def _synthetic_pool(n: int, length: int, S: int, seed: int = 0) -> np.ndarray:
    """(n, length) int32: lengths uniform in [length // 3, length], residues
    uniform below min(20, S), the rest padding."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(length // 3, length + 1, size=n)
    out = np.full((n, length), CHAR2IDX["-"], np.int32)
    for i, l in enumerate(lens):
        out[i, :l] = rng.randint(0, min(20, S), size=l)
    return out


def _load_or_synth(cfg, root: Optional[str]) -> ArrayDataset:
    path = root or cfg.data.get("location", "")
    if path and os.path.isfile(path):
        return ArrayDataset(np.load(path).astype(np.int32))
    length = int(cfg.data.get("shape", [48])[0])
    n = int(cfg.data.get("num_samples", 8192))
    return ArrayDataset(_synthetic_pool(n, length, cfg.data.S))


@registry.datasets.register(name="ProteinGrampa")
def protein_grampa(cfg, root=None) -> ArrayDataset:
    return _load_or_synth(cfg, root)


@registry.datasets.register(name="ProteinStream")
def protein_stream(cfg, root=None) -> ArrayDataset:
    return _load_or_synth(cfg, root)
