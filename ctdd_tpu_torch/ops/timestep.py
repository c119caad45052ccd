"""Sinusoidal timestep embeddings and data centering.

Counterpart of ctdd_tpu/ops/timestep.py.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def timestep_embedding(
    timesteps: torch.Tensor, dim: int, max_positions: int = 10000
) -> torch.Tensor:
    """(B,) -> (B, dim) sinusoidal embedding, [sin, cos] concat order."""
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=timesteps.device)
        * (-math.log(max_positions) / (half - 1))
    )
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def center_data(x: torch.Tensor, x_min_max) -> torch.Tensor:
    """Map integer states in [min, max] to [-1, 1]."""
    lo, hi = x_min_max
    out = (x.float() - lo) / (hi - lo)
    return 2.0 * out - 1.0
