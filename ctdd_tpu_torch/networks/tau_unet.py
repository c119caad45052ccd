"""The original tauLDR U-Net (logistic-parameter output), NCHW inside.

Counterpart of ctdd_tpu/networks/tau_unet.py: GroupNorm ResBlocks with the
1/√2 skip rescale, NiN-projected spatial attention at one scale
(`scale_count_to_put_attn`) and in the middle, a sinusoidal time embedding
of time_scale_factor·t through a 2-layer MLP, pad-(0, 1) stride-2 convs
down and nearest-2x convs up, and a 2C-channel head whose first C channels
get the tanh(x + μ') residual; `TauUNetWrapper` integrates the truncated
logistic over the S bins into (B, D, S) logits. The zoo reaches it through
`GaussianTargetRateImageX0PredEMA`; no preset uses that name
(`tauUnet_cifar10` runs networks/unet.py).

Submodules carry the names flax gives them in the order `TauUNet.__call__`
creates them (`TauUNet_0`, `TauResBlock_i`, `AttnBlock_j`, `Conv_k`,
`NiN_0`, ...), and a NiN keeps flax's (in, out) `W` and `b`, so a flax
param path is a state-dict key of the port
(`convert.tau_unet_params_from_flax`).

`model.compute_dtype="bfloat16"` mirrors flax's per-module dtype: convs and
Dense layers cast inputs and weights to bf16; the NiN and attention
products take bf16-rounded operands and sum in the weights' dtype (JAX's
float32 accumulation); GroupNorm, softmax and the head stay in the
weights' dtype.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ctdd_tpu_torch.networks.common import lecun_normal_
from ctdd_tpu_torch.networks.dit import bf16_compute
from ctdd_tpu_torch.networks.unet import (
    _conv, _conv3x3, _group_norm, _linear, _norm, _vs_uniform_,
)
from ctdd_tpu_torch.ops.logistic import logistic_bin_logits
from ctdd_tpu_torch.ops.timestep import center_data, timestep_embedding


class NiN(nn.Module):
    """1x1 channel mix with flax's (in, out) kernel `W` and bias `b`."""

    def __init__(self, in_ch: int, out_ch: int, init_scale: float = 0.1):
        super().__init__()
        self.init_scale = init_scale
        self.W = nn.Parameter(torch.zeros(in_ch, out_ch))
        self.b = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        acc = self.W.dtype
        h = torch.einsum("bihw,io->bohw", x.to(dt).to(acc), self.W.to(dt).to(acc))
        return h + self.b[None, :, None, None]


def _rescale(out: torch.Tensor, skip_rescale: bool) -> torch.Tensor:
    return out / math.sqrt(2.0) if skip_rescale else out


class AttnBlock(nn.Module):
    """Spatial self-attention over H·W with NiN q, k, v and output."""

    def __init__(self, ch: int, skip_rescale: bool = True):
        super().__init__()
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = _group_norm(ch)
        for i in range(3):
            setattr(self, f"NiN_{i}", NiN(ch, ch))
        self.NiN_3 = NiN(ch, ch, init_scale=0.0)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        B, C, H, W = x.shape
        acc = x.dtype
        h = _norm(self.GroupNorm_0, x)
        q, k, v = (getattr(self, f"NiN_{i}")(h, dt).to(dt).to(acc) for i in range(3))
        w = torch.einsum("bchw,bcij->bhwij", q, k) * (C ** -0.5)
        w = torch.softmax(w.reshape(B, H, W, H * W), dim=-1).reshape(B, H, W, H, W)
        h = torch.einsum("bhwij,bcij->bchw", w.to(dt).to(acc), v)
        return _rescale(x + self.NiN_3(h, dt), self.skip_rescale)


class TauResBlock(nn.Module):
    """GN -> SiLU -> conv, + Dense(SiLU(temb)), GN -> SiLU -> dropout ->
    conv, + the input (through a NiN where the width changes), rescaled."""

    def __init__(self, in_ch: int, out_ch: int, temb_dim: int, dropout: float,
                 skip_rescale: bool = True):
        super().__init__()
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = _group_norm(in_ch)
        self.Conv_0 = _conv3x3(in_ch, out_ch)
        self.Dense_0 = nn.Linear(temb_dim, out_ch)
        self.GroupNorm_1 = _group_norm(out_ch)
        self.dropout = nn.Dropout(dropout)
        self.Conv_1 = _conv3x3(out_ch, out_ch)
        if in_ch != out_ch:
            self.NiN_0 = NiN(in_ch, out_ch)

    def forward(self, x: torch.Tensor, temb: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        h = _conv(self.Conv_0, F.silu(_norm(self.GroupNorm_0, x)), dt)
        h = h + _linear(self.Dense_0, F.silu(temb), dt)[:, :, None, None]
        h = self.dropout(F.silu(_norm(self.GroupNorm_1, h.to(x.dtype))))
        h = _conv(self.Conv_1, h, dt)
        if hasattr(self, "NiN_0"):
            x = self.NiN_0(x, dt)
        return _rescale(x + h.to(x.dtype), self.skip_rescale)


class TauUNet(nn.Module):
    """(B, C, H, W) integer image + t -> (B, 2C, H, W): tanh(x + μ') and
    log s."""

    def __init__(self, ch: int, num_res_blocks: int, num_scales: int,
                 ch_mult: Sequence[int], input_channels: int, scale_count_to_put_attn: int,
                 data_min_max: Sequence[float], dropout: float, skip_rescale: bool,
                 time_scale_factor: float, time_embed_dim: int, bf16: bool = False):
        super().__init__()
        self.data_min_max = tuple(data_min_max)
        self.time_scale_factor = time_scale_factor
        self.time_embed_dim = time_embed_dim
        self.input_channels = input_channels
        self.bf16 = bf16
        counts = {}

        def add(kind: str, module: nn.Module) -> str:
            name = f"{kind}_{counts.get(kind, 0)}"
            counts[kind] = counts.get(kind, 0) + 1
            setattr(self, name, module)
            return name

        temb_dim = 4 * time_embed_dim
        add("Dense", nn.Linear(time_embed_dim, temb_dim))
        add("Dense", nn.Linear(temb_dim, temb_dim))
        add("Conv", _conv3x3(input_channels, ch))
        # the forward pass walks `self.plan`: (op, module name) in flax's order
        plan = []
        chans = [ch]
        h_ch = ch

        def res(out_ch: int, in_ch: int):
            plan.append(("res", add("TauResBlock", TauResBlock(
                in_ch, out_ch, temb_dim, dropout, skip_rescale))))

        def attn(c: int):
            plan.append(("attn", add("AttnBlock", AttnBlock(c, skip_rescale))))

        for scale in range(num_scales):
            for _ in range(num_res_blocks):
                out_ch = ch * ch_mult[scale]
                res(out_ch, h_ch)
                h_ch = out_ch
                if scale == scale_count_to_put_attn:
                    attn(h_ch)
                plan.append(("push", None))
                chans.append(h_ch)
            if scale != num_scales - 1:
                plan.append(("down", add("Conv", _conv3x3(h_ch, h_ch, stride=2))))
                plan.append(("push", None))
                chans.append(h_ch)
        res(h_ch, h_ch)
        attn(h_ch)
        res(h_ch, h_ch)
        for scale in reversed(range(num_scales)):
            for _ in range(num_res_blocks + 1):
                out_ch = ch * ch_mult[scale]
                plan.append(("pop", None))
                res(out_ch, h_ch + chans.pop())
                h_ch = out_ch
                if scale == scale_count_to_put_attn:
                    attn(h_ch)
            if scale != 0:
                plan.append(("up", add("Conv", _conv3x3(h_ch, h_ch))))
        self.plan = plan
        add("GroupNorm", _group_norm(h_ch))
        self.head = add("Conv", _conv3x3(h_ch, 2 * input_channels))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's defaults (Dense and Conv lecun-normal, GroupNorm 1 and 0,
        biases 0) and each NiN's variance-scaling fan_avg/uniform at its
        scale (0.1; the attention output's 0 taken as 1e-10); from
        `generator`, in the order of `modules()`."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                lecun_normal_(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, NiN):
                _vs_uniform_(m.W, generator, scale=m.init_scale or 1e-10)
                m.b.zero_()

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        wdt = self.Conv_0.weight.dtype
        dt = torch.bfloat16 if self.bf16 else wdt
        h = center_data(x, self.data_min_max).to(wdt)
        centered = h
        emb = timestep_embedding(t * self.time_scale_factor, self.time_embed_dim).to(wdt)
        temb = _linear(self.Dense_0, emb, dt)
        temb = _linear(self.Dense_1, F.silu(temb), dt)
        h = _conv(self.Conv_0, h, dt).to(wdt)
        hs = [h]
        for op, name in self.plan:
            if op == "push":
                hs.append(h)
            elif op == "pop":
                h = torch.cat([h, hs.pop()], dim=1)
            elif op == "res":
                h = getattr(self, name)(h, temb, dt)
            elif op == "attn":
                h = getattr(self, name)(h, dt)
            elif op == "down":
                h = _conv(getattr(self, name), F.pad(h, (0, 1, 0, 1)), dt).to(wdt)
            else:  # up
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = _conv(getattr(self, name), h, dt).to(wdt)
        h = getattr(self, self.head)(F.silu(self.GroupNorm_0(h)))
        C = self.input_channels
        return torch.cat([torch.tanh(centered + h[:, :C]), h[:, C:]], dim=1)


class TauUNetWrapper(nn.Module):
    """(B, D) states -> (B, D, S) logits of the truncated discretized
    logistic."""

    def __init__(self, cfg):
        super().__init__()
        m = cfg.model
        self.S = cfg.data.S
        self.shape = tuple(cfg.data.shape)
        self.fix_logistic = bool(m.get("fix_logistic", False))
        self.TauUNet_0 = TauUNet(
            ch=m.ch, num_res_blocks=m.num_res_blocks, num_scales=m.num_scales,
            ch_mult=tuple(m.ch_mult), input_channels=m.input_channels,
            scale_count_to_put_attn=m.scale_count_to_put_attn,
            data_min_max=tuple(m.data_min_max), dropout=m.dropout,
            skip_rescale=m.skip_rescale, time_scale_factor=m.time_scale_factor,
            time_embed_dim=m.time_embed_dim, bf16=bf16_compute(cfg),
        )

    def init_weights(self, generator: torch.Generator):
        """Draw the weights as the JAX package initializes them."""
        self.TauUNet_0.init_weights(generator)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        C, H, W = self.shape
        B = x.shape[0]
        out = self.TauUNet_0(x.reshape(B, C, H, W), t)
        logits = logistic_bin_logits(out[:, :C], out[:, C:], self.S, self.fix_logistic)
        return logits.reshape(B, C * H * W, self.S).contiguous()
