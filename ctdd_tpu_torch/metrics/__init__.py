"""Metrics of the port: MMD on synthetic data, FID (metrics/fid.py) and the
maze and sudoku accuracies; the same names as ctdd_tpu/metrics."""

from ctdd_tpu_torch.data.maze import maze_acc  # noqa: F401
from ctdd_tpu_torch.data.sudoku import sudoku_acc  # noqa: F401
from ctdd_tpu_torch.metrics.mmd import (  # noqa: F401
    binary_exp_hamming_mmd,
    binary_hamming_mmd,
    eval_mmd,
    exp_hamming_mmd,
    mmd_rbf,
)
