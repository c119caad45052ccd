"""Sudoku scoring: the share of valid solved boards.

The scoring half of ctdd_tpu/data/sudoku.py, copied (numpy only). The
puzzle generator and the SudokuDataset are ported in a later slice.
"""

from __future__ import annotations

import numpy as np


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
