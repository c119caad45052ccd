"""Batched gathers over (B, S, S) transition/rate tensors.

Counterpart of ctdd_tpu/ops/indexing.py. `mat` is (B, S, S); `idx` is
integer (B, D) with values in [0, S).
"""

from __future__ import annotations

import torch


def rows(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, d, :] = mat[b, idx[b, d], :]  -> (B, D, S)."""
    S = mat.shape[-1]
    index = idx.long()[:, :, None].expand(-1, -1, S)
    return torch.gather(mat, 1, index)


def cols(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, d, :] = mat[b, :, idx[b, d]]  -> (B, D, S)."""
    return rows(mat.transpose(1, 2), idx)


def elems(mat: torch.Tensor, ridx: torch.Tensor, cidx: torch.Tensor) -> torch.Tensor:
    """out[b, d] = mat[b, ridx[b, d], cidx[b, d]]  -> (B, D)."""
    return torch.gather(rows(mat, ridx), 2, cidx.long()[:, :, None])[..., 0]


def diag(mat: torch.Tensor) -> torch.Tensor:
    """out[b, s] = mat[b, s, s]  -> (B, S)."""
    return torch.diagonal(mat, dim1=1, dim2=2)


def zero_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x with x[b, d, idx[b, d]] = 0 (the diagonal-mask pattern)."""
    S = x.shape[-1]
    mask = torch.arange(S, device=x.device)[None, None, :] == idx[:, :, None]
    return torch.where(mask, torch.zeros((), dtype=x.dtype, device=x.device), x)


def onehot_mask(idx: torch.Tensor, S: int) -> torch.Tensor:
    """(B, D, S) float mask that is 0 at idx and 1 elsewhere (1 - one_hot)."""
    iota = torch.arange(S, device=idx.device)[None, None, :]
    return 1.0 - (iota == idx[:, :, None]).float()
