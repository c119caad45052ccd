"""DDSM-style score networks: the sudoku constraint-attention network and the
protein dilated-convolution network.

Counterpart of ctdd_tpu/networks/ddsm.py:

- `SudokuScoreNet`: 20 pre-LN blocks of width 128 with 8 heads, whose
  attention logits get a learned per-head projection of the (81, 81, 27)
  sudoku relation encoding (`BiasedSelfAttention`); the encoding is a
  buffer, not a weight. `SudokuScoreNetWrapper` one-hot-encodes (B, 81)
  cell values.
- `ProteinScoreNet`: one-hot residues, a width-9 convolution, then 20
  dilated width-9 convolutions (dilations 1, 1, 4, 16, 64, four times) with
  GroupNorm(1) and residual adds, swish activations and a GELU head.
- `GaussianFourierProjection`: random Fourier features of t. Its weight `W`
  is a parameter, as in flax, so it sits in the optimizer state, the EMA and
  the checkpoints; the forward detaches it, so its gradient is 0 and Adam
  leaves it where it was drawn.

Every submodule carries the name flax gives its counterpart (`Dense_0`,
`SudokuBlock_3`, `Conv_7`, `GroupNorm_2`, ...), so a flax param path is a
state-dict key of the port (`convert.ddsm_params_from_flax`). flax's
defaults are kept: LayerNorm and GroupNorm epsilon 1e-6, `nn.gelu` is the
tanh approximation, `nn.swish` is SiLU. The protein network computes in
PyTorch's (N, C, L) layout; a convolution with padding 4d and dilation d
keeps the length L, also where the padding exceeds L. Attention is a plain
product (`torch.matmul`), as the JAX package computes it in flax. The
networks compute in their weights' dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ctdd_tpu_torch.networks.common import flax_init_, numbered_children

NORM_EPS = 1e-6  # flax's LayerNorm and GroupNorm epsilon (PyTorch's is 1e-5)
SUDOKU_WIDTH, SUDOKU_HEADS, SUDOKU_BLOCKS = 128, 8, 20
PROTEIN_DILATIONS = [1, 1, 4, 16, 64] * 4


def new_gelu(x: torch.Tensor) -> torch.Tensor:
    """Google-BERT GELU, written out (ddsm_networks.py:22-27)."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


class GaussianFourierProjection(nn.Module):
    """[sin, cos](2 pi t W) with W ~ N(0, scale^2), (embed_dim // 2,) frozen."""

    def __init__(self, embed_dim: int, scale: float = 30.0):
        super().__init__()
        self.scale = scale
        self.W = nn.Parameter(torch.zeros(embed_dim // 2))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        proj = t[:, None] * self.W.detach()[None, :] * 2.0 * math.pi
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class BiasedSelfAttention(nn.Module):
    """Attention whose logits get a learned head projection of a (T, T, R)
    relation encoding (ddsm_networks.py:31-70). Dense_0 qkv, Dense_1 the
    bias projection, Dense_2 the output."""

    def __init__(self, n_embd: int, n_head: int, n_rel: int):
        super().__init__()
        self.n_head = n_head
        self.Dense_0 = nn.Linear(n_embd, 3 * n_embd)
        self.Dense_1 = nn.Linear(n_rel, n_head)
        self.Dense_2 = nn.Linear(n_embd, n_embd)

    def forward(self, x: torch.Tensor, bias_encoding: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        hs = C // self.n_head
        q, k, v = (a.reshape(B, T, self.n_head, hs).transpose(1, 2)
                   for a in self.Dense_0(x).split(C, dim=-1))
        att = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hs)
        bias = self.Dense_1(bias_encoding).permute(2, 0, 1)  # (n_head, T, T)
        att = torch.softmax(att + bias[None], dim=-1)
        y = torch.matmul(att, v).transpose(1, 2).reshape(B, T, C)
        return self.Dense_2(y)


class SudokuBlock(nn.Module):
    """Pre-LN block: x + attn(LN(x)), then x + MLP(LN(x)) with `new_gelu`."""

    def __init__(self, n_embd: int, n_head: int, n_rel: int):
        super().__init__()
        self.BiasedSelfAttention_0 = BiasedSelfAttention(n_embd, n_head, n_rel)
        self.LayerNorm_0 = nn.LayerNorm(n_embd, eps=NORM_EPS)
        self.LayerNorm_1 = nn.LayerNorm(n_embd, eps=NORM_EPS)
        self.Dense_0 = nn.Linear(n_embd, 4 * n_embd)
        self.Dense_1 = nn.Linear(4 * n_embd, n_embd)

    def forward(self, x, bias_encoding):
        x = x + self.BiasedSelfAttention_0(self.LayerNorm_0(x), bias_encoding)
        return x + self.Dense_1(new_gelu(self.Dense_0(self.LayerNorm_1(x))))


class SudokuScoreNet(nn.Module):
    """(B, 81, 9) one-hot cells -> (B, 81, 9) centered logits. Dense_0 the
    time MLP, Dense_1 the input, Dense_{2+i} block i's time projection,
    Dense_22 the head."""

    def __init__(self, embed_dim: int, encoding: np.ndarray):
        super().__init__()
        self.register_buffer("encoding", torch.as_tensor(encoding, dtype=torch.float32),
                             persistent=False)
        n_rel = self.encoding.shape[-1]
        self.GaussianFourierProjection_0 = GaussianFourierProjection(embed_dim)
        self.Dense_0 = nn.Linear(embed_dim, embed_dim)
        self.Dense_1 = nn.Linear(9, SUDOKU_WIDTH)
        for i in range(SUDOKU_BLOCKS):
            self.add_module(f"Dense_{i + 2}", nn.Linear(embed_dim, SUDOKU_WIDTH))
            self.add_module(f"SudokuBlock_{i}",
                            SudokuBlock(SUDOKU_WIDTH, SUDOKU_HEADS, n_rel))
        self.add_module(f"Dense_{SUDOKU_BLOCKS + 2}", nn.Linear(SUDOKU_WIDTH, 9))

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        dtype = self.Dense_1.weight.dtype
        temb = new_gelu(self.Dense_0(self.GaussianFourierProjection_0(t.to(dtype))))
        h = self.Dense_1(x.to(dtype))
        encoding = self.encoding.to(dtype)
        projections = numbered_children(self, "Dense", SUDOKU_BLOCKS, start=2)
        for proj, block in zip(projections, numbered_children(self, "SudokuBlock", SUDOKU_BLOCKS)):
            h = block(h + proj(temb)[:, None, :], encoding)
        h = getattr(self, f"Dense_{SUDOKU_BLOCKS + 2}")(h)
        return h - h.mean(dim=-1, keepdim=True)


class ProteinScoreNet(nn.Module):
    """(B, L) residues -> (B, L, S) centered logits. Conv_0 the input
    convolution, then per dilated block i Dense_{1+i} (time), GroupNorm_i
    and Conv_{1+i}; Conv_21 and Conv_22 the 1x1 head, Dense_0 the time MLP."""

    def __init__(self, S: int, embed_dim: int):
        super().__init__()
        self.S = S
        n = embed_dim
        self.GaussianFourierProjection_0 = GaussianFourierProjection(n)
        self.Dense_0 = nn.Linear(n, n)
        self.Conv_0 = nn.Conv1d(S, n, 9, padding=4)
        for i, d in enumerate(PROTEIN_DILATIONS):
            self.add_module(f"Dense_{i + 1}", nn.Linear(n, n))
            self.add_module(f"GroupNorm_{i}", nn.GroupNorm(1, n, eps=NORM_EPS))
            self.add_module(f"Conv_{i + 1}", nn.Conv1d(n, n, 9, padding=4 * d, dilation=d))
        k = len(PROTEIN_DILATIONS)
        self.add_module(f"Conv_{k + 1}", nn.Conv1d(n, n, 1))
        self.add_module(f"Conv_{k + 2}", nn.Conv1d(n, S, 1))

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        k = len(PROTEIN_DILATIONS)
        dtype = self.Conv_0.weight.dtype
        temb = F.silu(self.Dense_0(self.GaussianFourierProjection_0(t.to(dtype) / 2.0)))
        h = F.one_hot(x.long(), self.S).to(dtype).transpose(1, 2)  # (B, S, L)
        h = F.silu(self.Conv_0(h))
        for dense, norm, conv in zip(numbered_children(self, "Dense", k, start=1),
                                     numbered_children(self, "GroupNorm", k),
                                     numbered_children(self, "Conv", k, start=1)):
            z = norm(h + dense(temb)[:, :, None])
            h = F.silu(conv(z)) + h
        h = getattr(self, f"Conv_{k + 1}")(h)
        h = getattr(self, f"Conv_{k + 2}")(F.gelu(h, approximate="tanh"))
        h = h.transpose(1, 2)  # (B, L, S)
        return h - h.mean(dim=-1, keepdim=True)


class _FlaxInit(nn.Module):
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Draw the weights as the JAX package initializes them: flax's
        defaults (`flax_init_`: Dense and Conv lecun-normal, zero biases,
        LayerNorm and GroupNorm scale 1), then the Fourier weights normal
        times their scale; from `generator`."""
        flax_init_(self, generator)
        for mod in self.modules():
            if isinstance(mod, GaussianFourierProjection):
                mod.W.copy_(torch.randn(mod.W.shape, generator=generator) * mod.scale)


class SudokuScoreNetWrapper(_FlaxInit):
    """(B, 81) cell values (or (B, 729) one-hot) -> (B, 81, 9) logits."""

    def __init__(self, cfg):
        super().__init__()
        from ctdd_tpu_torch.data.sudoku import define_relative_encoding

        self.net = SudokuScoreNet(cfg.model.embed_dim, define_relative_encoding())

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        if x.dim() == 2 and x.shape[1] == 81:
            h = F.one_hot(x.long(), 9).float()
        else:
            h = x.reshape(B, 81, 9).float()
        return self.net(h, t).reshape(B, 81, 9)


class ProteinScoreNetWrapper(_FlaxInit):
    """(B, ...) states, flattened to (B, L) -> (B, L, S) logits."""

    def __init__(self, cfg):
        super().__init__()
        self.ProteinScoreNet_0 = ProteinScoreNet(cfg.data.S, cfg.model.embed_dim)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.ProteinScoreNet_0(x.reshape(x.shape[0], -1), t)
