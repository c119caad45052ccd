"""MMD metrics for synthetic binary data.

Counterpart of ctdd_tpu/metrics/mmd.py: the binary, exp-Hamming and RBF MMD
family and the `eval_mmd` loop, as torch ops on the samples' device. The
JAX package forms the pairwise distances as (N, N, D) broadcasts, 2.1 GB in
float32 at the reference protocol (N=4096, D=32); here the distance of 0/1
data is a product, d = x (1 - y)^T + (1 - x) y^T, exact in float32 (also
under TF32, which holds 0 and 1) for D < 2^24, and every other distance is
summed over blocks of rows.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ctdd_tpu_torch.data.synthetic import bin2float
from ctdd_tpu_torch.utils.device import resolve_device

_BLOCK_ELEMS = 1 << 24  # entries of one (rows, N, D) block of a broadcast


def _as_float(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float32)


def _is_binary(x: torch.Tensor) -> bool:
    return bool(((x == 0) | (x == 1)).all())


def _blockwise(x, y, pair_fn) -> torch.Tensor:
    """(N, M) of pair_fn(x rows (n, 1, D), y (1, M, D)).sum(-1), a block of
    x's rows at a time."""
    rows = max(1, _BLOCK_ELEMS // max(1, y.shape[0] * y.shape[1]))
    return torch.cat([pair_fn(x[i:i + rows, None, :], y[None, :, :]).sum(-1)
                      for i in range(0, x.shape[0], rows)])


def _l1(x, y) -> torch.Tensor:
    """sum |x - y| over the last axis, (N, M) float32."""
    if _is_binary(x) and _is_binary(y):
        return x @ (1.0 - y).T + (1.0 - x) @ y.T
    return _blockwise(x, y, lambda a, b: (a - b).abs())


def _binary_mmd(x, y, sim_fn: Callable) -> torch.Tensor:
    """Unbiased MMD estimate with the diagonals removed (ref metrics.py:24-47);
    the kernel sums in float64."""
    x = _as_float(x)
    y = _as_float(y, x.device)
    n, m = x.shape[0], y.shape[0]

    def off_diagonal_mean(k):
        return (k.sum(dtype=torch.float64) - k.diagonal().sum(dtype=torch.float64)) \
            / (k.shape[0] * (k.shape[0] - 1))

    kxx = off_diagonal_mean(sim_fn(x, x))
    kyy = off_diagonal_mean(sim_fn(y, y))
    kxy = sim_fn(x, y).sum(dtype=torch.float64) / (n * m)
    return kxx + kyy - 2.0 * kxy


def _hamming_sim(x, y):
    return x.shape[-1] - _l1(x, y)


def _exp_hamming_sim(x, y, bd):
    return torch.exp(-bd * _l1(x, y))


def binary_hamming_mmd(x, y) -> torch.Tensor:
    """(ref metrics.py:55-56)."""
    return _binary_mmd(x, y, _hamming_sim)


def binary_exp_hamming_mmd(x, y, bandwidth: float = 0.1) -> torch.Tensor:
    """The reference's headline synthetic metric (ref metrics.py:50-52)."""
    return _binary_mmd(x, y, lambda a, b: _exp_hamming_sim(a, b, bandwidth))


def _categorical_exp_hamming_sim(x, y, bd):
    return torch.exp(-bd * _blockwise(x, y, lambda a, b: (a != b).float()))


def categorical_exp_hamming_mmd(x, y, bandwidth: float = 0.1) -> torch.Tensor:
    """Exp-Hamming MMD on integer token sequences (S > 2): the count of
    entries that differ, where the reference's kernel takes |x - y| (the same
    for binary data only)."""
    return _binary_mmd(
        x, y, lambda a, b: _categorical_exp_hamming_sim(a, b, bandwidth))


def _decoded(x, cfg, device) -> torch.Tensor:
    bits = np.asarray(x.cpu() if torch.is_tensor(x) else x, np.int32)
    return torch.from_numpy(bin2float(bits, cfg.model.concat_dim, cfg.data.int_scale,
                                      cfg.data.binmode)).to(device, torch.float32)


def exp_hamming_mmd(x, y, cfg, bandwidth: float = 0.1) -> torch.Tensor:
    """Float-space exp-Hamming MMD after Gray decode (ref metrics.py:142-166)."""
    device = x.device if torch.is_tensor(x) else None
    return binary_exp_hamming_mmd(_decoded(x, cfg, device), _decoded(y, cfg, device),
                                  bandwidth)


def mmd_rbf(x, y, cfg, gamma: float = 0.2) -> float:
    """RBF-kernel MMD in float space, biased (ref metrics.py:113-133)."""
    device = x.device if torch.is_tensor(x) else None
    xf, yf = _decoded(x, cfg, device), _decoded(y, cfg, device)

    def rbf(a, b):
        return torch.exp(-gamma * _blockwise(a, b, lambda p, q: (p - q) ** 2))

    return float(rbf(xf, xf).mean() + rbf(yf, yf).mean() - 2 * rbf(xf, yf).mean())


def _round_generator(seed: int, round_idx: int, device) -> torch.Generator:
    """The generator of one `eval_mmd` round, seeded by (seed, round)."""
    state = np.random.SeedSequence([int(seed), int(round_idx)]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0] & 0x7FFFFFFFFFFFFFFF))


def eval_mmd(
    cfg,
    sample_fn: Callable[[torch.Generator, int], np.ndarray],
    dataset,
    n_rounds: int = 10,
    n_samples: int = 1024,
    seed: int = 0,
    device=None,
) -> float:
    """Binary exp-Hamming MMD averaged over rounds (ref metrics.py:168-223).

    Each round draws `n_samples` ground-truth rows with JAX's
    `RandomState(seed)` indices and calls `sample_fn(generator, n)` -> (n, D)
    int samples (numpy or a tensor), with a generator on `device` (the GPU
    unless the caller passes another) seeded by (seed, round)."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    total = 0.0
    for r in range(n_rounds):
        idx = rng.randint(0, len(dataset), size=n_samples)
        gt = torch.from_numpy(np.asarray(dataset.data[idx]).reshape(n_samples, -1)).to(device)
        x0 = sample_fn(_round_generator(seed, r, device), n_samples)
        x0 = x0.to(device) if torch.is_tensor(x0) else torch.from_numpy(np.asarray(x0)).to(device)
        total += float(binary_exp_hamming_mmd(gt, x0))
    return total / n_rounds
