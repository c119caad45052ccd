"""The tauLDR UNet in plain float32 PyTorch: the benchmark's frozen reference.

A copy of the published network (GroupNorm ResBlocks with additive time
injection, QKV self-attention at the configured resolutions, nearest-2x
upsampling, a logits or truncated-logistic head), written for this
benchmark and never imported from the program. Its parameters carry the
names and shapes of the program's `UNetWrapper`, so one set of seeded
weights loads into both. It runs in its weights' dtype only: the reference
is float32 with TF32 off.

`(B, D)` integer states and `(B,)` times in, `(B, D, S)` logits out.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

GN_EPS = 1e-6  # flax's GroupNorm epsilon


def group_norm(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(ch // 4, 32), ch, eps=GN_EPS)


def conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    # stride 1: SAME padding; stride 2: VALID after a (0, 1) pad
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1 if stride == 1 else 0)


def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[sin, cos] of t at frequencies 10000^(-k / (dim/2 - 1)); the table is
    the float64 exp of the float32 exponents, rounded to float32."""
    half = dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=t.device) * (
        -math.log(10000.0) / (half - 1))
    freqs = torch.exp(exps.double()).float()
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, tdim: int, dropout: float):
        super().__init__()
        self.norm_0 = group_norm(cin)
        self.conv_0 = conv3x3(cin, cout)
        self.dense_0 = nn.Linear(tdim, cout)
        self.norm_1 = group_norm(cout)
        self.dropout = nn.Dropout(dropout)
        self.conv_1 = conv3x3(cout, cout)
        self.skip = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        h = self.conv_0(F.silu(self.norm_0(x)))
        h = h + self.dense_0(F.silu(temb))[:, :, None, None]
        h = self.conv_1(self.dropout(F.silu(self.norm_1(h))))
        return h + (self.skip(x) if self.skip is not None else x)


class SelfAttention(nn.Module):
    """Per head the qkv projection is laid out [q_h | k_h | v_h]; q and k
    are each scaled by head_dim ** -0.25."""

    def __init__(self, ch: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.norm = group_norm(ch)
        self.qkv = nn.Linear(ch, 3 * ch)
        self.proj = nn.Linear(ch, ch)

    def forward(self, x):
        B, C, H, W = x.shape
        hd = C // self.n_head
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.qkv(h).reshape(B, H * W, self.n_head, 3 * hd).chunk(3, dim=-1)
        scale = hd ** -0.25
        w = torch.softmax(torch.einsum("bthc,bshc->bhts", q * scale, k * scale), dim=-1)
        out = torch.einsum("bhts,bshc->bthc", w, v).reshape(B, H * W, C)
        return x + self.proj(out).reshape(B, H, W, C).permute(0, 3, 1, 2)


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = conv3x3(ch, ch, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = conv3x3(ch, ch)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNet(nn.Module):
    def __init__(self, m: dict, S: int, img_size: int):
        super().__init__()
        ch, mult, nres = m["ch"], list(m["ch_mult"]), m["num_res_blocks"]
        self.model_output = m["model_output"]
        self.out_channel = m["input_channels"]
        self.S = S
        self.x_min_max = tuple(m["data_min_max"])
        self.mult, self.nres = mult, nres
        strides = [img_size // int(r) for r in m["attn_resolutions"]]
        self.level_attn = [2 ** i in strides for i in range(len(mult))]
        tdim = ch * 4
        self.ch = ch
        self.dense_0 = nn.Linear(ch, tdim)
        self.dense_1 = nn.Linear(tdim, tdim)
        self.conv_0 = conv3x3(m["input_channels"], ch)
        res, attns, downs, ups = [], [], [], []
        chans, cur = [ch], ch
        for i, k in enumerate(mult):
            for _ in range(nres):
                res.append(ResBlock(cur, ch * k, tdim, m["dropout"]))
                cur = ch * k
                if self.level_attn[i]:
                    attns.append(SelfAttention(cur, m["num_heads"]))
                chans.append(cur)
            if i != len(mult) - 1:
                downs.append(Downsample(cur))
                chans.append(cur)
        res.append(ResBlock(cur, cur, tdim, m["dropout"]))
        attns.append(SelfAttention(cur, m["num_heads"]))
        res.append(ResBlock(cur, cur, tdim, m["dropout"]))
        for i in reversed(range(len(mult))):
            for _ in range(nres + 1):
                res.append(ResBlock(cur + chans.pop(), ch * mult[i], tdim, m["dropout"]))
                cur = ch * mult[i]
                if self.level_attn[i]:
                    attns.append(SelfAttention(cur, m["num_heads"]))
            if i != 0:
                ups.append(Upsample(cur))
        self.res_blocks = nn.ModuleList(res)
        self.attns = nn.ModuleList(attns)
        self.downs = nn.ModuleList(downs)
        self.ups = nn.ModuleList(ups)
        self.norm_out = group_norm(cur)
        head = 2 if self.model_output == "logistic_pars" else S
        self.conv_1 = conv3x3(cur, self.out_channel * head)

    def forward(self, img, t):
        temb = self.dense_1(F.silu(self.dense_0(time_embedding(t, self.ch))))
        lo, hi = self.x_min_max
        inp = 2.0 * ((img - lo) / (hi - lo)) - 1.0
        res, attns = iter(self.res_blocks), iter(self.attns)
        downs, ups = iter(self.downs), iter(self.ups)
        h = self.conv_0(inp)
        feats = [h]
        for i in range(len(self.mult)):
            for _ in range(self.nres):
                h = next(res)(h, temb)
                if self.level_attn[i]:
                    h = next(attns)(h)
                feats.append(h)
            if i != len(self.mult) - 1:
                h = next(downs)(h)
                feats.append(h)
        h = next(attns)(next(res)(h, temb))
        h = next(res)(h, temb)
        for i in reversed(range(len(self.mult))):
            for _ in range(self.nres + 1):
                h = next(res)(torch.cat([h, feats.pop()], dim=1), temb)
                if self.level_attn[i]:
                    h = next(attns)(h)
            if i != 0:
                h = next(ups)(h)
        out = self.conv_1(F.silu(self.norm_out(h)))
        if self.model_output == "logistic_pars":
            loc, log_scale = out.chunk(2, dim=1)
            return torch.tanh(loc + inp), log_scale
        B, _, H, W = out.shape
        return out.reshape(B, self.out_channel, self.S, H, W).permute(0, 1, 3, 4, 2)


def logistic_logits(mu, log_scale, S: int, fix_logistic: bool):
    """Truncated discretized-logistic logits over S equal bins of [-1, 1]."""
    mu, log_scale = mu[..., None], log_scale[..., None]
    inv_scale = torch.exp(-(log_scale - 2.0))
    width = 2.0 / S
    centers = torch.linspace(-1.0 + width / 2.0, 1.0 - width / 2.0, S,
                             dtype=mu.dtype, device=mu.device)
    left = (centers - width / 2.0 - mu) * inv_scale
    right = (centers + width / 2.0 - mu) * inv_scale
    lcdf_l, lcdf_r = F.logsigmoid(left), F.logsigmoid(right)

    def log_minus_exp(a, b):
        return a + torch.log1p(-torch.exp(b - a) + 1e-6)

    out = log_minus_exp(lcdf_r, lcdf_l)
    if fix_logistic:
        out = torch.minimum(out, log_minus_exp(-left + lcdf_l, -right + lcdf_r))
    return out


class Net(nn.Module):
    """(B, D) states, (B,) times -> (B, D, S) logits."""

    def __init__(self, cfg: dict):
        super().__init__()
        m, d = cfg["model"], cfg["data"]
        self.S = d["S"]
        self.shape = tuple(d["shape"])
        self.model_output = m["model_output"]
        self.fix_logistic = bool(m.get("fix_logistic", False))
        if m.get("padding", False):
            raise ValueError("the reference UNet has no padded variant")
        self.unet = UNet(m, self.S, d["image_size"])

    def forward(self, x, t):
        C, H, W = self.shape
        B = x.shape[0]
        out = self.unet(x.reshape(B, C, H, W).to(self.unet.conv_0.weight.dtype), t)
        if self.model_output == "logistic_pars":
            out = logistic_logits(*out, self.S, self.fix_logistic)
        return out.reshape(B, C * H * W, self.S)
