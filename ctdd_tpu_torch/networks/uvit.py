"""U-ViT: every token a patch, with long skips between the halves.

Counterpart of ctdd_tpu/networks/uvit.py: patch embedding, a time token
(an MLP over the sinusoid) and, when `num_classes` > 0, a label token
before it; a learned positional table initialised to
zero; depth/2 blocks that keep their outputs, a middle block, depth/2
blocks that take them back through Linear(2d -> d); LayerNorm, a per-token
patch decoder, the unpatchify and a 3x3 conv head (C·S logits, or the 2·C
logistic parameters that the reference's wrapper reshapes as they are).
NCHW inside.

Submodules carry flax's names (`UViT_0`, `UViTBlock_i`, `Dense_2`,
`LayerNorm_0`, `pos_embed`), so a flax param path is a state-dict key of
the port; flax names a checkpointed block `CheckpointUViTBlock_i`
(`convert.uvit_params_from_flax` renames it). `model.use_checkpoint`
recomputes each block in the backward pass (`torch.utils.checkpoint`), as
flax's `nn.checkpoint` does. `model.compute_dtype="bfloat16"` casts the
blocks' Linear layers and attention to bf16 as networks/dit.py does; the
embeddings, LayerNorms, decoder and head stay in the weights' dtype.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ctdd_tpu_torch.networks.common import lecun_normal_
from ctdd_tpu_torch.networks.dit import LN_EPS, Attention, bf16_compute, xavier_
from ctdd_tpu_torch.networks.unet import _linear
from ctdd_tpu_torch.ops.timestep import center_data, timestep_embedding


def _layer_norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=LN_EPS)  # flax's default epsilon


class UViTBlock(nn.Module):
    """Pre-LN ViT block; a skip block first fuses [x | skip] through
    Linear(2d -> d)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, skip: bool = False):
        super().__init__()
        self.skip = skip
        dense = iter(range(3))
        if skip:
            setattr(self, f"Dense_{next(dense)}", nn.Linear(2 * dim, dim))
        self.LayerNorm_0 = _layer_norm(dim)
        self.Attention_0 = Attention(dim, num_heads)
        self.LayerNorm_1 = _layer_norm(dim)
        self.mlp_in = f"Dense_{next(dense)}"
        self.mlp_out = f"Dense_{next(dense)}"
        setattr(self, self.mlp_in, nn.Linear(dim, int(dim * mlp_ratio)))
        setattr(self, self.mlp_out, nn.Linear(int(dim * mlp_ratio), dim))

    def forward(self, x: torch.Tensor, skip, dt: torch.dtype) -> torch.Tensor:
        if self.skip:
            x = _linear(self.Dense_0, torch.cat([x, skip], dim=-1), dt).to(skip.dtype)
        x = x + self.Attention_0(self.LayerNorm_0(x), dt)
        h = _linear(getattr(self, self.mlp_in), self.LayerNorm_1(x), dt)
        h = _linear(getattr(self, self.mlp_out), F.gelu(h, approximate="tanh"), dt)
        return x + h.to(x.dtype)


class UViT(nn.Module):
    """(B, C, H, W) image + t [+ y] -> (B, C, H, W, S) logits, or the head's
    (B, H, W, 2·C) logistic parameters channel-last, as JAX returns them."""

    def __init__(self, img_size: int, num_states: int, patch_size: int, in_chans: int,
                 embed_dim: int, depth: int, num_heads: int, mlp_ratio: float,
                 mlp_time_embed: bool = True, num_classes: int = -1,
                 model_output: str = "logits", use_checkpoint: bool = False,
                 bf16: bool = False):
        super().__init__()
        if model_output not in ("logits", "logistic_pars"):
            raise ValueError(f"unknown model_output {model_output!r}")
        self.S = num_states
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.depth = depth
        self.mlp_time_embed = mlp_time_embed
        self.num_classes = num_classes
        self.model_output = model_output
        self.use_checkpoint = use_checkpoint
        self.bf16 = bf16
        dense = iter(range(3))
        self.Conv_0 = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)
        self.time_dense = []
        if mlp_time_embed:
            self.time_dense = [f"Dense_{next(dense)}", f"Dense_{next(dense)}"]
            setattr(self, self.time_dense[0], nn.Linear(embed_dim, 4 * embed_dim))
            setattr(self, self.time_dense[1], nn.Linear(4 * embed_dim, embed_dim))
        if num_classes > 0:
            self.Embed_0 = nn.Embedding(num_classes, embed_dim)
        n_tokens = (img_size // patch_size) ** 2
        # the time token, and the label token of a labelled net
        self.extras = 2 if num_classes > 0 else 1
        self.pos_embed = nn.Parameter(torch.zeros(1, self.extras + n_tokens, embed_dim))
        n_half = depth // 2
        for i in range(2 * n_half + 1):
            setattr(self, f"UViTBlock_{i}",
                    UViTBlock(embed_dim, num_heads, mlp_ratio, skip=i > n_half))
        self.LayerNorm_0 = _layer_norm(embed_dim)
        self.decoder = f"Dense_{next(dense)}"
        setattr(self, self.decoder, nn.Linear(embed_dim, patch_size * patch_size * in_chans))
        head = 2 if model_output == "logistic_pars" else num_states
        self.Conv_1 = nn.Conv2d(in_chans, in_chans * head, 3, padding=1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's defaults (Dense and Conv lecun-normal, Embed normal with
        std 1/sqrt(features), LayerNorm 1 and 0, biases 0), the attention's
        projections xavier-uniform and the positional table zero; from
        `generator`, in the order of `modules()`."""
        xavier = {id(d) for a in self.modules() if isinstance(a, Attention)
                  for d in (a.Dense_0, a.Dense_1)}
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                (xavier_ if id(m) in xavier else lecun_normal_)(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               / m.weight.shape[1] ** 0.5)
        self.pos_embed.zero_()

    def _block(self, i: int, h, skip, dt):
        block = getattr(self, f"UViTBlock_{i}")
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(block, h, skip, dt, use_reentrant=False)
        return block(h, skip, dt)

    def forward(self, x: torch.Tensor, t: torch.Tensor, y=None):
        wdt = self.Conv_0.weight.dtype
        dt = torch.bfloat16 if self.bf16 else wdt
        B, C, H, W = x.shape
        p = self.patch_size
        x = center_data(x, (0, self.S - 1)).to(wdt)
        h = self.Conv_0(x).flatten(2).transpose(1, 2)  # (B, L, d), row-major
        temb = timestep_embedding(t, self.embed_dim).to(wdt)
        if self.mlp_time_embed:
            first, second = (getattr(self, n) for n in self.time_dense)
            temb = second(F.silu(first(temb)))
        tokens = [temb[:, None, :], h]
        if self.num_classes > 0:
            if y is None:
                # JAX's table, sized at init with a label, fits no other call
                raise ValueError("a U-ViT with num_classes > 0 takes labels")
            tokens = [self.Embed_0(y.long())[:, None, :]] + tokens
        h = torch.cat(tokens, dim=1) + self.pos_embed

        skips = []
        n_half = self.depth // 2
        for i in range(n_half):
            h = self._block(i, h, None, dt)
            skips.append(h)
        h = self._block(n_half, h, None, dt)
        for i in range(n_half + 1, 2 * n_half + 1):
            h = self._block(i, h, skips.pop(), dt)

        h = getattr(self, self.decoder)(self.LayerNorm_0(h))[:, self.extras:, :]
        g = H // p
        # unpatchify: token (i, j), entry (pi, qi, c) -> pixel (c, i·p + pi, j·p + qi)
        h = h.reshape(B, g, g, p, p, C).permute(0, 5, 1, 3, 2, 4).reshape(B, C, H, W)
        out = self.Conv_1(h)
        if self.model_output == "logistic_pars":
            return out.permute(0, 2, 3, 1)  # (B, H, W, 2C), the caller reshapes it
        return out.reshape(B, C, self.S, H, W).permute(0, 1, 3, 4, 2)


class UViTWrapper(nn.Module):
    """(B, D) states -> (B, D, S): the network's output reshaped as the
    JAX wrapper does (no label token: it builds the U-ViT with
    num_classes=-1, so a label is taken and ignored)."""

    def __init__(self, cfg):
        super().__init__()
        m = cfg.model
        self.S = cfg.data.S
        self.shape = tuple(cfg.data.shape)
        self.UViT_0 = UViT(
            img_size=cfg.data.image_size, num_states=self.S, patch_size=m.patch_size,
            in_chans=m.input_channel, embed_dim=m.hidden_dim, depth=m.depth,
            num_heads=m.num_heads, mlp_ratio=m.mlp_ratio, mlp_time_embed=True,
            num_classes=-1, model_output=m.model_output,
            use_checkpoint=bool(m.get("use_checkpoint", False)), bf16=bf16_compute(cfg),
        )

    def init_weights(self, generator: torch.Generator):
        """Draw the weights as the JAX package initializes them."""
        self.UViT_0.init_weights(generator)

    def forward(self, x: torch.Tensor, t: torch.Tensor, label=None):
        C, H, W = self.shape
        B = x.shape[0]
        out = self.UViT_0(x.reshape(B, C, H, W), t, y=label)
        return out.reshape(B, C * H * W, self.S).contiguous()
