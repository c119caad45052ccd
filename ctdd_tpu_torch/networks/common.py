"""Shared network building blocks: the time-embedding MLP and state scaling.

Counterpart of the pieces of ctdd_tpu/networks/common.py that the residual
MLP uses.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ctdd_tpu_torch.ops.timestep import timestep_embedding


class TimeEmbedMLP(nn.Module):
    """sinusoid(t * scale) -> Linear -> ReLU -> Linear."""

    def __init__(self, temb_dim: int, hidden: int, out_dim: int,
                 time_scale_factor: float = 1.0):
        super().__init__()
        self.temb_dim = temb_dim
        self.time_scale_factor = time_scale_factor
        self.dense_0 = nn.Linear(temb_dim, hidden)
        self.dense_1 = nn.Linear(hidden, out_dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(t * self.time_scale_factor, self.temb_dim)
        return self.dense_1(F.relu(self.dense_0(emb)))


def normalize_states(x: torch.Tensor, S: int) -> torch.Tensor:
    """states [0, S-1] -> [-1, 1]."""
    return (x.float() / (S - 1)) * 2.0 - 1.0
