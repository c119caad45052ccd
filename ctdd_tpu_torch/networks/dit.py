"""DiT (Diffusion Transformer), num_states-aware, NCHW inside.

Counterpart of ctdd_tpu/networks/dit.py: a p x p patch embedding, the fixed
2D sin-cos positional table, `TimestepEmbedder` ([cos, sin] order),
`LabelEmbedder` with its classifier-free-guidance drop row at index
`num_classes`, adaLN-Zero `DiTBlock`s, `FinalLayer`, the unpatchify and a
3x3 conv head giving C·S logits or 2·C logistic parameters;
`forward_with_cfg`, the reference's half-batch guidance, as a plain
function; and `DiTWrapper`, (B, D) states -> (B, D, S) logits.

Every submodule carries the name flax gives its counterpart (`DiT_0`,
`DiTBlock_3`, `Attention_0`, `Dense_1`, ...), so a flax param path is a
state-dict key of the port (`convert.dit_params_from_flax`).

`model.compute_dtype="bfloat16"` mirrors flax's per-module dtype: the
attention's projections and the blocks' MLP cast inputs and weights to bf16
(the weights stay float32); the attention runs on bf16 q, k, v
(`F.scaled_dot_product_attention`: float32 scores and softmax, bf16 weights
into the value product, as JAX's einsums with float32 accumulation); the
patch embedding, the embedders, the adaLN modulations, the LayerNorms, the
final layer and the head stay in the weights' dtype.

The label drop mask of training (`class_dropout_prob`) is drawn from the
generator the caller passes (the loss's step generator), where JAX draws it
from the "dropout" rng.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ctdd_tpu_torch.networks.unet import _linear
from ctdd_tpu_torch.ops.logistic import logistic_bin_logits
from ctdd_tpu_torch.ops.timestep import center_data

LN_EPS = 1e-6  # the reference's LayerNorm(epsilon=1e-6)


def bf16_compute(cfg) -> bool:
    """Whether `model.compute_dtype` asks for bf16; refuses another value."""
    name = cfg.model.get("compute_dtype", "float32")
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"unknown model.compute_dtype {name!r}")
    return name == "bfloat16"


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """(grid², D) fixed table, float64 as numpy computes it."""

    def emb_1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)
    emb_h = emb_1d(embed_dim // 2, grid[0])
    emb_w = emb_1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def _no_norm(x: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm(use_bias=False, use_scale=False, epsilon=1e-6)."""
    return F.layer_norm(x, x.shape[-1:], eps=LN_EPS)


@torch.no_grad()
def xavier_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's `xavier_uniform` of a Linear (out, in) or Conv2d (out, in, kh,
    kw) weight, drawn on the CPU from `generator`."""
    field = w[0, 0].numel() if w.dim() > 2 else 1
    limit = math.sqrt(6.0 / ((w.shape[0] + w.shape[1]) * field))
    return w.copy_((torch.rand(w.shape, generator=generator) * 2.0 - 1.0) * limit)


@torch.no_grad()
def normal_(w: torch.Tensor, generator: torch.Generator, std: float) -> torch.Tensor:
    return w.copy_(torch.randn(w.shape, generator=generator) * std)


def _wdt(module: nn.Module) -> torch.dtype:
    return next(module.parameters()).dtype


class TimestepEmbedder(nn.Module):
    """[cos, sin] frequency embedding of t -> Linear -> SiLU -> Linear."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.Dense_0 = nn.Linear(frequency_embedding_size, hidden_size)
        self.Dense_1 = nn.Linear(hidden_size, hidden_size)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.frequency_embedding_size // 2
        dtype = torch.float64 if t.dtype == torch.float64 else torch.float32
        freqs = torch.exp(-math.log(10000.0)
                          * torch.arange(half, dtype=dtype, device=t.device) / half)
        args = t.to(dtype)[:, None] * freqs[None, :]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1).to(_wdt(self))
        return self.Dense_1(F.silu(self.Dense_0(emb)))


class LabelEmbedder(nn.Module):
    """Class embedding; with `dropout_prob` > 0 its table has the extra row
    `num_classes` that training drops labels to, and that unconditional
    (guided) forwards use."""

    def __init__(self, num_classes: int, hidden_size: int, dropout_prob: float):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_prob = dropout_prob
        self.Embed_0 = nn.Embedding(num_classes + int(dropout_prob > 0), hidden_size)

    def forward(self, labels: torch.Tensor, train: bool = False, force_drop_ids=None,
                generator=None) -> torch.Tensor:
        labels = labels.long()
        if (train and self.dropout_prob > 0) or force_drop_ids is not None:
            if force_drop_ids is None:
                drop = torch.rand(labels.shape, generator=generator,
                                  device=labels.device) < self.dropout_prob
            else:
                drop = torch.as_tensor(force_drop_ids, device=labels.device) == 1
            labels = torch.where(drop, self.num_classes, labels)
        return self.Embed_0(labels)


class Attention(nn.Module):
    """timm-style ViT attention, qkv laid out (3, heads, head_dim)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.Dense_0 = nn.Linear(dim, 3 * dim)
        self.Dense_1 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        B, N, C = x.shape
        qkv = _linear(self.Dense_0, x, dt).reshape(B, N, 3, self.num_heads, C // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B, N, C)
        return _linear(self.Dense_1, out, dt).to(x.dtype)


class DiTBlock(nn.Module):
    """adaLN-Zero block: shift, scale and gate of the attention and the MLP
    from the conditioning vector."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.Dense_0 = nn.Linear(hidden_size, 6 * hidden_size)
        self.Attention_0 = Attention(hidden_size, num_heads)
        self.Dense_1 = nn.Linear(hidden_size, int(hidden_size * mlp_ratio))
        self.Dense_2 = nn.Linear(int(hidden_size * mlp_ratio), hidden_size)

    def forward(self, x: torch.Tensor, c: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = self.Dense_0(F.silu(c)).chunk(6, dim=-1)
        x = x + g_msa[:, None, :] * self.Attention_0(modulate(_no_norm(x), s_msa, sc_msa), dt)
        h = _linear(self.Dense_1, modulate(_no_norm(x), s_mlp, sc_mlp), dt)
        h = _linear(self.Dense_2, F.gelu(h, approximate="tanh"), dt).to(x.dtype)
        return x + g_mlp[:, None, :] * h


class FinalLayer(nn.Module):
    """Zero-initialised adaLN and linear projection to p·p·C per token."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int):
        super().__init__()
        self.Dense_0 = nn.Linear(hidden_size, 2 * hidden_size)
        self.Dense_1 = nn.Linear(hidden_size, patch_size * patch_size * out_channels)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.Dense_0(F.silu(c)).chunk(2, dim=-1)
        return self.Dense_1(modulate(_no_norm(x), shift, scale))


class DiT(nn.Module):
    """(B, C, H, W) centred image + t [+ labels] -> (B, C·S or 2·C, H, W)."""

    def __init__(self, input_size: int, num_states: int, patch_size: int,
                 in_channels: int, hidden_size: int, depth: int, num_heads: int,
                 mlp_ratio: float, class_dropout_prob: float, num_classes: int,
                 model_output: str, bf16: bool = False):
        super().__init__()
        if model_output not in ("logits", "logistic_pars"):
            raise ValueError(f"unknown model_output {model_output!r}")
        self.patch_size = patch_size
        self.depth = depth
        self.bf16 = bf16
        grid = input_size // patch_size
        self.Conv_0 = nn.Conv2d(in_channels, hidden_size, patch_size, stride=patch_size)
        self.register_buffer(
            "pos_embed", torch.from_numpy(
                get_2d_sincos_pos_embed(hidden_size, grid).astype(np.float32)),
            persistent=False)
        self.TimestepEmbedder_0 = TimestepEmbedder(hidden_size)
        self.LabelEmbedder_0 = LabelEmbedder(num_classes, hidden_size, class_dropout_prob)
        for i in range(depth):
            setattr(self, f"DiTBlock_{i}", DiTBlock(hidden_size, num_heads, mlp_ratio))
        self.FinalLayer_0 = FinalLayer(hidden_size, patch_size, in_channels)
        out_ch = in_channels * (num_states if model_output == "logits" else 2)
        self.Conv_1 = nn.Conv2d(in_channels, out_ch, 3, padding=1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """The JAX module's initializers: the patch embedding, the attention,
        the MLPs and the head xavier-uniform; the embedders normal(0.02);
        the adaLN modulations and the final layer zero; biases zero."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                xavier_(m.weight, generator)
                m.bias.zero_()
        for dense in (self.TimestepEmbedder_0.Dense_0, self.TimestepEmbedder_0.Dense_1):
            normal_(dense.weight, generator, 0.02)
        normal_(self.LabelEmbedder_0.Embed_0.weight, generator, 0.02)
        for i in range(self.depth):
            getattr(self, f"DiTBlock_{i}").Dense_0.weight.zero_()
        for dense in (self.FinalLayer_0.Dense_0, self.FinalLayer_0.Dense_1):
            dense.weight.zero_()

    def forward(self, x: torch.Tensor, t: torch.Tensor, y=None, generator=None):
        wdt = self.Conv_0.weight.dtype
        dt = torch.bfloat16 if self.bf16 else wdt
        B, C, H, W = x.shape
        p = self.patch_size
        g = H // p
        h = self.Conv_0(x).flatten(2).transpose(1, 2)  # (B, g·g, hidden), row-major
        h = h + self.pos_embed.to(wdt)[None]
        c = self.TimestepEmbedder_0(t)
        if y is not None:
            c = c + self.LabelEmbedder_0(y, train=self.training, generator=generator)
        for i in range(self.depth):
            h = getattr(self, f"DiTBlock_{i}")(h, c, dt)
        h = self.FinalLayer_0(h, c)
        # unpatchify: token (i, j), entry (pi, qi, c) -> pixel (c, i·p + pi, j·p + qi)
        h = h.reshape(B, g, g, p, p, C).permute(0, 5, 1, 3, 2, 4).reshape(B, C, H, W)
        return self.Conv_1(h)


def forward_with_cfg(apply_fn, params, x, t, y, cfg_scale: float, guided_channels: int = 3):
    """Classifier-free guidance forward of the reference: the first half of
    the batch is scored twice (`apply_fn(params, x, t, y)` on [half | half]
    with the caller's labels, conditional then dropped), and u + s·(c − u)
    is applied to the first `guided_channels` entries of axis 1 only (its
    "exact reproducibility" convention), both halves alike."""
    half = x[: len(x) // 2]
    combined = torch.cat([half, half], dim=0)
    out = apply_fn(params, combined, t, y)
    eps, rest = out[:, :guided_channels], out[:, guided_channels:]
    cond_eps, uncond_eps = eps.chunk(2, dim=0)
    half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
    eps = torch.cat([half_eps, half_eps], dim=0)
    return torch.cat([eps, rest], dim=1)


class DiTWrapper(nn.Module):
    """(B, D) states [+ labels] -> (B, D, S) logits; the logits head or the
    logistic head over tanh(loc + x)."""

    def __init__(self, cfg):
        super().__init__()
        m = cfg.model
        self.S = cfg.data.S
        self.shape = tuple(cfg.data.shape)
        self.model_output = m.model_output
        self.fix_logistic = bool(m.get("fix_logistic", False))
        self.DiT_0 = DiT(
            input_size=cfg.data.image_size, num_states=self.S, patch_size=m.patch_size,
            in_channels=m.input_channel, hidden_size=m.hidden_dim, depth=m.depth,
            num_heads=m.num_heads, mlp_ratio=m.mlp_ratio, class_dropout_prob=m.dropout,
            num_classes=self.S, model_output=m.model_output, bf16=bf16_compute(cfg),
        )

    def init_weights(self, generator: torch.Generator):
        """Draw the weights as the JAX package initializes them."""
        self.DiT_0.init_weights(generator)

    def forward(self, x: torch.Tensor, t: torch.Tensor, label=None, generator=None):
        C, H, W = self.shape
        B = x.shape[0]
        wdt = self.DiT_0.Conv_0.weight.dtype
        img = center_data(x.reshape(B, C, H, W), (0, self.S - 1)).to(wdt)
        out = self.DiT_0(img, t, y=label, generator=generator)
        if self.model_output == "logits":
            # channel c·S + s -> (B, C, S, H, W) -> (B, C, H, W, S)
            logits = out.reshape(B, C, self.S, H, W).permute(0, 1, 3, 4, 2)
        else:
            loc, log_scale = out.chunk(2, dim=1)
            logits = logistic_bin_logits(torch.tanh(loc + img), log_scale, self.S,
                                         self.fix_logistic)
        return logits.reshape(B, C * H * W, self.S).contiguous()
