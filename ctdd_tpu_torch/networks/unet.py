"""U-Net score network (the MNIST flagship), NCHW inside.

Counterpart of ctdd_tpu/networks/unet.py: GroupNorm ResBlocks with additive
time injection, QKV self-attention at configured resolutions, nearest-2x
upsampling, and a logits or truncated-logistic head. The public interface is
the JAX package's: (B, D) int states -> (B, D, S) logits.

`model.compute_dtype="bfloat16"` mirrors flax's per-module dtype: every
convolution, Dense layer and the attention's projections cast their inputs
and weights to bf16 (the weights stay float32, so gradients and Adam do);
GroupNorm upcasts to float32, the attention's products and softmax run in
float32, and the head casts to float32 before its GroupNorm. Otherwise the
network computes in its weights' dtype (float32, or float64 for a
reference).

Submodules are kept in flat lists in the order the JAX module creates them
(`res_blocks[i]` is flax's `ResBlock_i`, `attns[j]` is `SelfAttention_j`, and
so on), so the weight conversion in `ctdd_tpu_torch/convert.py` is a
renaming.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ctdd_tpu_torch.ops.logistic import logistic_bin_logits
from ctdd_tpu_torch.ops.timestep import center_data

GN_EPS = 1e-6  # flax.linen.GroupNorm's epsilon (PyTorch's default is 1e-5)


def _group_norm(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(ch // 4, 32), ch, eps=GN_EPS)


@torch.no_grad()
def _vs_uniform_(w: torch.Tensor, generator: torch.Generator, scale: float = 1.0):
    """flax's variance_scaling(scale, "fan_avg", "uniform"), drawn on the CPU
    from `generator` whatever `w`'s device."""
    field = w[0, 0].numel() if w.dim() > 2 else 1
    fan_avg = (w.shape[0] + w.shape[1]) * field / 2
    limit = math.sqrt(3.0 * scale / fan_avg)
    w.copy_((torch.rand(w.shape, generator=generator) * 2.0 - 1.0) * limit)


def _linear(m: nn.Linear, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """flax Dense(dtype=dt): input and weights cast to dt."""
    return F.linear(x.to(dt), m.weight.to(dt), m.bias.to(dt))


def _conv(m: nn.Conv2d, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """flax Conv(dtype=dt): input and weights cast to dt."""
    return m._conv_forward(x.to(dt), m.weight.to(dt), m.bias.to(dt))


def _norm(m: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """flax GroupNorm without a dtype: the result in the weights' dtype."""
    return m(x.to(m.weight.dtype))


def _conv3x3(in_ch: int, out_ch: int, stride: int = 1) -> nn.Conv2d:
    # stride 1: SAME padding; stride 2: VALID after the caller's (0, 1) pad
    return nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1 if stride == 1 else 0)


class TimeEmbedding(nn.Module):
    """Sinusoidal t embedding, [sin, cos] concat, frequencies over half - 1."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        inv_freq = torch.exp(
            torch.arange(half, dtype=torch.float32, device=t.device)
            * (-math.log(10000.0) / (half - 1))
        )
        args = t.float()[:, None] * inv_freq[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class ResBlock(nn.Module):
    """GN -> swish -> conv, + temb, GN -> swish -> dropout -> conv, + skip."""

    def __init__(self, in_ch: int, out_ch: int, time_dim: int, dropout: float):
        super().__init__()
        self.norm_0 = _group_norm(in_ch)
        self.conv_0 = _conv3x3(in_ch, out_ch)
        self.dense_0 = nn.Linear(time_dim, out_ch)
        self.norm_1 = _group_norm(out_ch)
        self.dropout = nn.Dropout(dropout)
        self.conv_1 = _conv3x3(out_ch, out_ch)
        # flax's Dense over channels: a 1x1 conv in NCHW
        self.skip = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        h = _conv(self.conv_0, F.silu(_norm(self.norm_0, x)), dt)
        h = h + _linear(self.dense_0, F.silu(temb), dt)[:, :, None, None]
        h = self.dropout(F.silu(_norm(self.norm_1, h)))
        h = _conv(self.conv_1, h, dt)
        if self.skip is not None:
            x = _conv(self.skip, x, dt)
        return h + x


class SelfAttention(nn.Module):
    """Spatial QKV attention with an output projection.

    The qkv projection is split per head as [q_h | k_h | v_h] (the JAX
    layout), and both q and k are scaled by ch**-0.25. The products and the
    softmax run in the GroupNorm's dtype (float32 under bf16 compute: the
    products of bf16 values are exact there, as in JAX's
    preferred_element_type=float32)."""

    def __init__(self, ch: int, n_head: int = 1):
        super().__init__()
        self.n_head = n_head
        self.norm = _group_norm(ch)
        self.qkv = nn.Linear(ch, 3 * ch)
        self.proj = nn.Linear(ch, ch)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        B, C, H, W = x.shape
        h = _norm(self.norm, x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        acc = h.dtype
        qkv = _linear(self.qkv, h, dt).reshape(B, H * W, self.n_head, 3 * (C // self.n_head))
        q, k, v = qkv.chunk(3, dim=-1)
        scale = 1.0 / math.sqrt(math.sqrt(C // self.n_head))
        w = torch.einsum("bthc,bshc->bhts", (q * scale).to(acc), (k * scale).to(acc))
        w = torch.softmax(w, dim=-1)
        out = torch.einsum("bhts,bshc->bthc", w, v.to(acc)).reshape(B, H * W, C)
        out = _linear(self.proj, out, dt)
        return x + out.reshape(B, H, W, C).permute(0, 3, 1, 2).to(x.dtype)


class Downsample(nn.Module):
    """Pad bottom/right by 1, then a VALID stride-2 3x3 conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = _conv3x3(ch, ch, stride=2)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        return _conv(self.conv, F.pad(x, (0, 1, 0, 1)), dt)


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = _conv3x3(ch, ch)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        return _conv(self.conv, F.interpolate(x, scale_factor=2, mode="nearest"), dt)


class UNet(nn.Module):
    """(B, C_in, H, W) image + (B,) t -> logits (B, C, H, W, S), or the
    logistic head's (loc, log_scale), each (B, C, H, W)."""

    def __init__(
        self, in_channel: int, out_channel: int, channel: int,
        channel_multiplier: Sequence[int], n_res_blocks: int,
        attn_resolutions: Sequence[int], num_heads: int, dropout: float,
        model_output: str, num_classes: int, x_min_max: Sequence[float],
        img_size: int, bf16: bool = False,
    ):
        super().__init__()
        if model_output not in ("logits", "logistic_pars"):
            raise ValueError(f"unknown model_output {model_output!r}")
        self.model_output = model_output
        self.bf16 = bf16
        self.out_channel = out_channel
        self.num_classes = num_classes
        self.x_min_max = tuple(x_min_max)
        self.channel_multiplier = tuple(channel_multiplier)
        self.n_res_blocks = n_res_blocks
        attn_strides = [img_size // int(r) for r in attn_resolutions]
        # which levels carry attention after each ResBlock (port of the
        # condition `2**i in attn_strides`, not of the flagship's outcome)
        self.level_attn = [2**i in attn_strides for i in range(len(channel_multiplier))]
        time_dim = channel * 4

        self.temb = TimeEmbedding(channel)
        self.dense_0 = nn.Linear(channel, time_dim)
        self.dense_1 = nn.Linear(time_dim, time_dim)
        self.conv_0 = _conv3x3(in_channel, channel)

        res, attns, downs, ups = [], [], [], []
        chans = [channel]
        ch = channel
        n_block = len(channel_multiplier)
        for i in range(n_block):
            for _ in range(n_res_blocks):
                out = channel * channel_multiplier[i]
                res.append(ResBlock(ch, out, time_dim, dropout))
                ch = out
                if self.level_attn[i]:
                    attns.append(SelfAttention(ch, num_heads))
                chans.append(ch)
            if i != n_block - 1:
                downs.append(Downsample(ch))
                chans.append(ch)
        res.append(ResBlock(ch, ch, time_dim, dropout))
        attns.append(SelfAttention(ch, num_heads))
        res.append(ResBlock(ch, ch, time_dim, dropout))
        for i in reversed(range(n_block)):
            for _ in range(n_res_blocks + 1):
                out = channel * channel_multiplier[i]
                res.append(ResBlock(ch + chans.pop(), out, time_dim, dropout))
                ch = out
                if self.level_attn[i]:
                    attns.append(SelfAttention(ch, num_heads))
            if i != 0:
                ups.append(Upsample(ch))
        self.res_blocks = nn.ModuleList(res)
        self.attns = nn.ModuleList(attns)
        self.downs = nn.ModuleList(downs)
        self.ups = nn.ModuleList(ups)
        self.norm_out = _group_norm(ch)
        head = 2 if model_output == "logistic_pars" else num_classes
        self.conv_1 = _conv3x3(ch, out_channel * head)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """The JAX UNet's initializers: every conv and dense kernel
        variance-scaling fan_avg/uniform, biases 0; each ResBlock's second
        conv and the output head at scale 1e-10; the attention output
        projection 0; GroupNorm scale 1, bias 0."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                _vs_uniform_(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for block in self.res_blocks:
            _vs_uniform_(block.conv_1.weight, generator, scale=1e-10)
        _vs_uniform_(self.conv_1.weight, generator, scale=1e-10)
        for attn in self.attns:
            attn.proj.weight.zero_()

    def forward(self, x: torch.Tensor, t: torch.Tensor):
        # the weights' dtype (float64 for a reference), and the compute dtype
        wdt = self.conv_0.weight.dtype
        dt = torch.bfloat16 if self.bf16 else wdt
        temb = _linear(self.dense_0, self.temb(t).to(wdt), dt)
        temb = _linear(self.dense_1, F.silu(temb), dt)
        res, attns = iter(self.res_blocks), iter(self.attns)
        downs, ups = iter(self.downs), iter(self.ups)

        inp = center_data(x, self.x_min_max).to(wdt)
        hid = _conv(self.conv_0, inp, dt)
        feats = [hid]
        n_block = len(self.channel_multiplier)
        for i in range(n_block):
            for _ in range(self.n_res_blocks):
                hid = next(res)(hid, temb, dt)
                if self.level_attn[i]:
                    hid = next(attns)(hid, dt)
                feats.append(hid)
            if i != n_block - 1:
                hid = next(downs)(hid, dt)
                feats.append(hid)

        hid = next(res)(hid, temb, dt)
        hid = next(attns)(hid, dt)
        hid = next(res)(hid, temb, dt)

        for i in reversed(range(n_block)):
            for _ in range(self.n_res_blocks + 1):
                hid = next(res)(torch.cat([hid, feats.pop()], dim=1), temb, dt)
                if self.level_attn[i]:
                    hid = next(attns)(hid, dt)
            if i != 0:
                hid = next(ups)(hid, dt)

        # the head in the weights' dtype, as JAX casts to float32 before it
        out = self.conv_1(F.silu(self.norm_out(hid.to(wdt))))  # (B, C*S, H, W)
        if self.model_output == "logistic_pars":
            loc, log_scale = out.chunk(2, dim=1)
            return torch.tanh(loc + inp), log_scale
        B, _, H, W = out.shape
        # channel index c*S + s -> (B, C, S, H, W) -> (B, C, H, W, S)
        out = out.reshape(B, self.out_channel, self.num_classes, H, W)
        return out.permute(0, 1, 3, 4, 2)


class UNetWrapper(nn.Module):
    """(B, D) states -> (B, D, S) logits, with optional replication padding."""

    def __init__(self, cfg):
        super().__init__()
        compute_dtype = cfg.model.get("compute_dtype", "float32")
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown model.compute_dtype {compute_dtype!r}")
        self.S = cfg.data.S
        self.model_output = cfg.model.model_output
        self.fix_logistic = bool(cfg.model.get("fix_logistic", False))
        self.shape = tuple(cfg.data.shape)
        self.padding = bool(cfg.model.get("padding", False))
        img_size = cfg.data.image_size + (1 if self.padding else 0)
        self.unet = UNet(
            in_channel=cfg.model.input_channels,
            out_channel=cfg.model.input_channels,
            channel=cfg.model.ch,
            channel_multiplier=tuple(cfg.model.ch_mult),
            n_res_blocks=cfg.model.num_res_blocks,
            attn_resolutions=tuple(cfg.model.attn_resolutions),
            num_heads=cfg.model.num_heads,
            dropout=cfg.model.dropout,
            model_output=cfg.model.model_output,
            num_classes=self.S,
            x_min_max=tuple(cfg.model.data_min_max),
            img_size=img_size,
            bf16=compute_dtype == "bfloat16",
        )

    def init_weights(self, generator: torch.Generator):
        """Draw the weights as the JAX package initializes them."""
        self.unet.init_weights(generator)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        C, H, W = self.shape
        B = x.shape[0]
        D = C * H * W
        img = x.reshape(B, C, H, W).float()
        if self.padding:
            img = F.pad(img, (0, 1, 0, 1), mode="replicate")
        out = self.unet(img, t)
        if self.model_output == "logits":
            logits = out  # (B, C, H', W', S)
        else:
            logits = logistic_bin_logits(*out, self.S, self.fix_logistic)
        if self.padding:
            logits = logits[:, :, :-1, :-1, :]
        # the head's permute leaves a strided view; the fused kernel takes
        # row-major (B, D, S) logits
        return logits.reshape(B, D, self.S).contiguous()
