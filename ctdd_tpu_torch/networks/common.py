"""Shared network building blocks: the time-embedding MLP and state scaling.

Counterpart of the pieces of ctdd_tpu/networks/common.py that the residual
MLP uses, and flax's default initializers (`lecun_normal_`, `flax_init_`).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ctdd_tpu_torch.ops.timestep import timestep_embedding


# flax's truncated normal keeps draws within 2 standard deviations and scales
# them back to unit variance by this factor (the std of N(0, 1) cut at +-2)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's `lecun_normal` (variance scaling 1, fan_in, truncated normal),
    drawn on the CPU from `generator` whatever `w`'s device. fan_in is the
    input size times the kernel's window: `w[0].numel()` for a Linear
    (out, in) or Conv2d (out, in, kh, kw) weight."""
    std = math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD
    draw = torch.empty(w.shape, dtype=torch.float32)
    nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return w.copy_(draw)


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's defaults for every Linear and Conv2d (a `lecun_normal` kernel,
    a zero bias) and LayerNorm, GroupNorm and BatchNorm (scale 1, bias 0;
    running mean 0 and variance 1), in the order of `module.modules()`."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
    return module


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
