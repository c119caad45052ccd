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
    """(B,) -> (B, dim) sinusoidal embedding, [sin, cos] concat order, in
    float32 as JAX computes it; float64 times give a float64 embedding (a
    float64 reference).

    At the time scale of 1000 (the MLP and the hollow family) the arguments
    reach ~1000 rad, so one ulp of a frequency moves the embedding by ~1e-4.
    The float32 frequencies are therefore the correctly rounded exp of the
    float32 exponents (exp taken in float64), the same table on every
    device; a device's float32 exp (and JAX's) may sit an ulp away."""
    half = dim // 2
    c = -math.log(max_positions) / (half - 1)
    if timesteps.dtype == torch.float64:
        dtype = torch.float64
        freqs = torch.exp(torch.arange(half, dtype=dtype, device=timesteps.device) * c)
    else:
        dtype = torch.float32
        exponents = torch.arange(half, dtype=dtype, device=timesteps.device) * c
        freqs = torch.exp(exponents.double()).float()
    args = timesteps.to(dtype)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def center_data(x: torch.Tensor, x_min_max) -> torch.Tensor:
    """Map integer states in [min, max] to [-1, 1]."""
    lo, hi = x_min_max
    out = (x.float() - lo) / (hi - lo)
    return 2.0 * out - 1.0
