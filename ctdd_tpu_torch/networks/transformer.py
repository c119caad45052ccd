"""The sequence transformer score network (tauLDR style).

Counterpart of ctdd_tpu/networks/transformer.py: (B, L) int states and (B,)
times -> (B, L, S) logits.

- `EncoderLayer`: post-norm self-attention and feed-forward blocks, FiLM
  from the time embedding after each.
- `FFResidual`: a residual feed-forward block, LayerNorm, FiLM.
- `SequenceTransformer`: the time-embedding MLP; the input as one-hot
  through a Dense, an embedding, or a normalized scalar; optionally scaled
  by sqrt(d_model) (`scale_input_embedding`); the positional table;
  `num_layers` encoder layers and `num_output_FFresiduals` residual blocks;
  a Dense to S logits plus the one-hot input; with `aux_key_classes` a
  per-position key head (`aux_key_head`) that `return_aux` returns too.

Submodules carry flax's names (`EncoderLayer_0`, `Dense_1`,
`MultiHeadDotProductAttention_0` with `query_ln`/`key_ln` under `qk_norm`),
but for the time-embedding MLP's two layers (`dense_0`, `dense_1` of the
shared `TimeEmbedMLP`): `convert.sequence_transformer_params_from_flax`
maps the weights. Attention is `F.scaled_dot_product_attention` without a
mask; its dropout and the blocks' draw from the device's default generator,
which the train step seeds.
"""

from __future__ import annotations

import math

import torch.nn as nn
import torch.nn.functional as F

from ctdd_tpu_torch.networks.common import (
    PositionalEncoding, TimeEmbedMLP, film, normalize_states, numbered_children,
)
from ctdd_tpu_torch.networks.hollow import (
    LN_EPS, MultiHeadDotProductAttention, _FlaxInit,
)


def _layer_norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=LN_EPS)


class EncoderLayer(nn.Module):
    """Post-norm self-attention then feed-forward, FiLM after each."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dropout: float, temb_out: int, qk_norm: bool = False):
        super().__init__()
        self.K = d_model
        self.Dense_0 = nn.Linear(temb_out, 2 * d_model)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            d_model, num_heads, dropout, qk_norm=qk_norm)
        self.LayerNorm_0 = _layer_norm(d_model)
        self.Dense_1 = nn.Linear(d_model, dim_feedforward)
        self.Dense_2 = nn.Linear(dim_feedforward, d_model)
        self.LayerNorm_1 = _layer_norm(d_model)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, temb):
        film_params = self.Dense_0(temb)
        sa = self.dropout(self.MultiHeadDotProductAttention_0(x))
        x = film(self.LayerNorm_0(x + sa), film_params, self.K)
        ff = self.dropout(F.relu(self.Dense_1(x)))
        ff = self.dropout(self.Dense_2(ff))
        return film(self.LayerNorm_1(x + ff), film_params, self.K)


class FFResidual(nn.Module):
    """x + FF(x), LayerNorm, FiLM."""

    def __init__(self, d_model: int, hidden: int, temb_out: int):
        super().__init__()
        self.K = d_model
        self.Dense_0 = nn.Linear(temb_out, 2 * d_model)
        self.Dense_1 = nn.Linear(d_model, hidden)
        self.Dense_2 = nn.Linear(hidden, d_model)
        self.LayerNorm_0 = _layer_norm(d_model)

    def forward(self, x, temb):
        film_params = self.Dense_0(temb)
        h = self.Dense_2(F.relu(self.Dense_1(x)))
        return film(self.LayerNorm_0(x + h), film_params, self.K)


class SequenceTransformer(_FlaxInit):
    def __init__(self, S: int, num_layers: int, d_model: int, num_heads: int,
                 dim_feedforward: int, dropout: float, num_output_FFresiduals: int,
                 time_scale_factor: float, temb_dim: int, use_one_hot_input: bool,
                 use_cat: bool = True, max_len: int = 5000,
                 scale_input_embedding: bool = False, qk_norm: bool = False,
                 aux_key_classes: int = 0):
        super().__init__()
        self.S, self.d_model = S, d_model
        self.num_layers, self.num_res = num_layers, num_output_FFresiduals
        self.use_cat, self.one_hot = bool(use_cat), bool(use_one_hot_input)
        self.scale_input_embedding = bool(scale_input_embedding)
        self.aux_key_classes = int(aux_key_classes)
        temb_out = 4 * temb_dim
        self.TimeEmbedMLP_0 = TimeEmbedMLP(temb_dim, dim_feedforward, temb_out,
                                           time_scale_factor)
        # flax numbers the Dense layers of this module in creation order:
        # the input Dense (where there is one) is Dense_0, the logits the next
        n_dense = 0
        if self.use_cat and not self.one_hot:
            self.Embed_0 = nn.Embedding(S, d_model)
        else:
            self.Dense_0 = nn.Linear(S if self.use_cat else 1, d_model)
            n_dense = 1
        self.PositionalEncoding_0 = PositionalEncoding(d_model, max_len)
        self.dropout = nn.Dropout(dropout)
        for i in range(num_layers):
            self.add_module(f"EncoderLayer_{i}", EncoderLayer(
                d_model, num_heads, dim_feedforward, dropout, temb_out, qk_norm))
        for i in range(num_output_FFresiduals):
            self.add_module(f"FFResidual_{i}", FFResidual(d_model, dim_feedforward, temb_out))
        self.out_name = f"Dense_{n_dense}"
        self.add_module(self.out_name, nn.Linear(d_model, S))
        if self.aux_key_classes > 0:
            self.aux_key_head = nn.Linear(d_model, self.aux_key_classes)

    def forward(self, x, t, return_aux: bool = False):
        temb = self.TimeEmbedMLP_0(t)
        dt = temb.dtype  # the weights' (float64 in a reference)
        one_hot_x = F.one_hot(x.long(), self.S).to(dt)
        if not self.use_cat:
            h = self.Dense_0(normalize_states(x, self.S)[..., None].to(dt))
        elif self.one_hot:
            h = self.Dense_0(one_hot_x)
        else:
            h = self.Embed_0(x.long())
        if self.scale_input_embedding:
            h = h * math.sqrt(self.d_model)  # float32(sqrt(d)), as JAX rounds it
        h = self.dropout(self.PositionalEncoding_0(h))
        for layer in numbered_children(self, "EncoderLayer", self.num_layers):
            h = layer(h, temb)
        for block in numbered_children(self, "FFResidual", self.num_res):
            h = block(h, temb)
        out = getattr(self, self.out_name)(h) + one_hot_x
        if return_aux and self.aux_key_classes > 0:
            return out, self.aux_key_head(h)
        return out
