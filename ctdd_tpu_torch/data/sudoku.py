"""Sudoku data: the board generator, the relative constraint encoding, the
SudokuDataset and the share of valid solved boards.

The port's copy of ctdd_tpu/data/sudoku.py (numpy, and the C++ generator of
data/native.py). `gen_sudoku` takes the C++ generator unless
`use_native=False`; the two give different boards from one seed, and a
failed build of the C++ one raises (no quiet fallback).
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np

from ctdd_tpu_torch import registry
from ctdd_tpu_torch.data.loaders import ArrayDataset, mix_pool_seed


def define_relative_encoding() -> np.ndarray:
    """(81, 81, 27) float mask: cells sharing column/row/block (ref :11-61)."""
    grid = np.indices((9, 9))
    rowind = grid[0]
    colind = grid[1]
    blockind = (rowind // 3) * 3 + colind // 3
    colenc = np.zeros((81, 9))
    rowenc = np.zeros((81, 9))
    blockenc = np.zeros((81, 9))
    colenc[np.arange(81), colind.flatten()] = 1
    rowenc[np.arange(81), rowind.flatten()] = 1
    blockenc[np.arange(81), blockind.flatten()] = 1
    allenc = np.concatenate([colenc, rowenc, blockenc], axis=1)  # (81, 27)
    return (allenc[:, None, :] == allenc[None, :, :]).astype(np.float32)


def construct_puzzle_solution(rng: random.Random):
    """Greedy fill with restart on dead ends (ref :64-94)."""
    while True:
        try:
            puzzle = [[0] * 9 for _ in range(9)]
            rows = [set(range(1, 10)) for _ in range(9)]
            columns = [set(range(1, 10)) for _ in range(9)]
            squares = [set(range(1, 10)) for _ in range(9)]
            for i in range(9):
                for j in range(9):
                    choices = (
                        rows[i] & columns[j] & squares[(i // 3) * 3 + j // 3]
                    )
                    choice = rng.choice(sorted(choices))
                    puzzle[i][j] = choice
                    rows[i].discard(choice)
                    columns[j].discard(choice)
                    squares[(i // 3) * 3 + j // 3].discard(choice)
            return puzzle
        except IndexError:
            pass


def gen_sudoku(num: int, seed: Optional[int] = None, use_native: bool = True) -> np.ndarray:
    """`num` solved boards (num, 9, 9) in 1..9 (ref :97-105).

    The C++ generator (csrc/datagen.cpp) seeded with `seed or 0`; with
    `use_native=False` the python generator, seeded with `random.Random(seed)`.
    """
    if use_native:
        from ctdd_tpu_torch.data.native import sudoku_gen_native

        return sudoku_gen_native(num, seed=seed or 0).reshape(num, 9, 9) + 1
    rng = random.Random(seed)
    out = np.zeros((num, 9, 9), np.int32)
    for i in range(num):
        out[i] = construct_puzzle_solution(rng)
    return out


class SudokuPoolDataset(ArrayDataset):
    """Sudoku pool that can regenerate itself per epoch (stream_fresh).

    The reference's SudokuDataset builds a brand-new solved board on every
    __getitem__ (sudoku.py:108-119), an infinite fresh stream; training
    instead holds a pool of cfg.data.num_samples boards on the device and,
    with `data.stream_fresh` on, swaps in a freshly generated pool every
    `data.stream_refresh_period` epochs via `regenerate` (training/loop.py;
    C++ generator csrc/datagen.cpp)."""

    def __init__(self, n: int, seed: int):
        self._n = n
        self._base_seed = int(seed)
        super().__init__(self._gen(mix_pool_seed(seed, 0)))

    def _gen(self, seed: int) -> np.ndarray:
        boards = gen_sudoku(self._n, seed=seed)
        return boards.reshape(self._n, 81).astype(np.int32) - 1

    def regenerate(self, epoch: int) -> np.ndarray:
        """Fresh pool, deterministically keyed by (data.seed, epoch)."""
        self.data = self._gen(mix_pool_seed(self._base_seed, epoch))
        return self.data


@registry.datasets.register(name="SudokuDataset")
def sudoku_dataset(cfg, root=None) -> ArrayDataset:
    """Solved boards as (N, 81) cell values in 0..8 (states for S=9).

    The reference emits one-hot (81, 9) floats per item (sudoku.py:116-119);
    we emit the equivalent integer cells — the score-net wrapper one-hot
    encodes on device.
    """
    n = int(cfg.data.get("num_samples", cfg.data.batch_size * 100))
    return SudokuPoolDataset(n, seed=int(cfg.data.get("seed", 0)))


def sudoku_acc(sample: np.ndarray, return_array: bool = False):
    """Fraction of valid solved boards (ref :122-147).

    Accepts (N, 81, 9) one-hot/logits or (N, 81) integer cells in 0..8.
    Checks rows, columns, AND blocks (the reference re-checks the transpose
    where it means to check blocks — sudoku.py:136 — fixed here).
    """
    if sample.ndim == 3:
        ans = sample.argmax(-1) + 1
    else:
        ans = sample.reshape(sample.shape[0], 9, 9) + 1
    ans = ans.reshape(-1, 9, 9)
    numbers = np.arange(1, 10)
    corrects = []
    for board in ans:
        ok = np.all(np.sort(board, axis=1) == numbers) and np.all(
            np.sort(board.T, axis=1) == numbers
        )
        if ok:
            blocks = board.reshape(3, 3, 3, 3).transpose(0, 2, 1, 3).reshape(9, 9)
            ok = bool(np.all(np.sort(blocks, axis=1) == numbers))
        corrects.append(bool(ok))
    if return_array:
        return corrects
    return float(np.mean(corrects))
