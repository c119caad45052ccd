"""Shared network building blocks: the time-embedding MLP, FiLM, the
positional table and state scaling.

Counterpart of ctdd_tpu/networks/common.py, and flax's default initializers
(`lecun_normal_`, `xavier_uniform_`, `flax_init_`).
"""

from __future__ import annotations

import math

import numpy as np
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
def xavier_uniform_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's `xavier_uniform` of a Linear weight (out, in), drawn on the CPU
    from `generator` whatever `w`'s device."""
    limit = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    return w.copy_((torch.rand(w.shape, generator=generator) * 2.0 - 1.0) * limit)


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's defaults for every Linear, Conv1d and Conv2d (a `lecun_normal`
    kernel, a zero bias) and LayerNorm, GroupNorm and BatchNorm (scale 1,
    bias 0; running mean 0 and variance 1), in the order of
    `module.modules()`."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
    return module


def numbered_children(module: nn.Module, kind: str, n: int, start: int = 0) -> list:
    """The submodules `<kind>_<start>` ... `<kind>_<start + n - 1>`, named as
    flax numbers a module's children of one class."""
    return [getattr(module, f"{kind}_{i}") for i in range(start, start + n)]


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
        return self.dense_1(F.relu(self.dense_0(emb.to(self.dense_0.weight.dtype))))


def normalize_states(x: torch.Tensor, S: int) -> torch.Tensor:
    """states [0, S-1] -> [-1, 1]."""
    return (x.float() / (S - 1)) * 2.0 - 1.0


def film(x: torch.Tensor, params: torch.Tensor, d: int) -> torch.Tensor:
    """FiLM: scale/shift a (B, ..., d) tensor with (B, 2d) params, broadcast
    over the middle axes."""
    shape = (params.shape[0],) + (1,) * (x.dim() - 2) + (d,)
    return params[:, :d].reshape(shape) * x + params[:, d:].reshape(shape)


def positional_table(max_len: int, d_model: int) -> torch.Tensor:
    """The fixed sin/cos positional table (max_len, d_model), interleaved:
    even columns sin, odd columns cos (numpy float64, cast to float32 as
    the JAX module does)."""
    position = np.arange(max_len)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.from_numpy(pe)


class PositionalEncoding(nn.Module):
    """x + the positional table's first x.shape[1] rows. The table is a
    buffer (moved with the module, not in the state dict)."""

    def __init__(self, d_model: int, max_len: int):
        super().__init__()
        self.register_buffer("pe", positional_table(max_len, d_model), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        L = x.shape[1]
        if L > self.pe.shape[0]:
            raise ValueError(f"{L} positions, table of {self.pe.shape[0]}")
        return x + self.pe[None, :L, :].to(x.dtype)
