"""Hollow, masked and enumerative transformers (the SDDM family).

Counterpart of ctdd_tpu/networks/hollow.py:

- `UniDirectionalTransformer`: a causal tower over shifted inputs. l2r
  prepends the time token and drops the last position (keeps keys at or
  before the query), r2l appends it and drops the first (keeps keys at or
  after).
- `BidirectionalTransformer`: both towers and a readout; the time embedding
  is an MLP over a half-width sinusoid (`nets` other than
  "bidir_transformer2") or the raw full-width sinusoid.
  `PrefixConditionalBidirTransformer` runs both towers with the prefix's
  embeddings before the time token and reads out the rest (it has no zoo
  entry, in JAX neither).
- Readouts: `ConcatReadout`, `ResidualReadout` (FiLM), `ConcatResidualReadout`
  and `AttentionReadout` over `CrossAttention`, whose keys are [t | l2r |
  r2l] under the joint causal / anti-causal key mask.
- `TransformerEncoderH` (prepends the time token, strips it after),
  `MaskedTransformer` (S+1 mask vocabulary), `EnumerativeTransformer` (masks
  each position in turn: a loop over positions with one module, where JAX
  scans) and `BertEnumTransformer` (one pass).
- The zoo's wrappers: `HollowTransformerWrapper`, `HollowLogisticsWrapper`,
  `EnumerativeTransformerWrapper`, `BertEnumTransformerWrapper`.

Every submodule is registered under the name flax gives its counterpart
(`Dense_0`, `LayerNorm_1`, `MultiHeadDotProductAttention_0`, ...; the
enumerative network's `Scan_Step_0` is the scanned step), so a flax param
path is a state-dict key of the port with its leaf renamed
(`convert.hollow_params_from_flax`). flax's defaults are kept: GELU is the
tanh approximation and LayerNorm's epsilon is 1e-6. Attention is
`F.scaled_dot_product_attention` with boolean keep-masks; every query keeps
at least one key, so its -inf fill gives the softmax of JAX's finfo.min
fill. The network computes in its weights' dtype.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ctdd_tpu_torch.networks.common import (
    PositionalEncoding, lecun_normal_, normalize_states, numbered_children, xavier_uniform_,
)
from ctdd_tpu_torch.ops.logistic import logistic_bin_logits
from ctdd_tpu_torch.ops.timestep import timestep_embedding

LN_EPS = 1e-6  # flax.linen.LayerNorm's epsilon (PyTorch's default is 1e-5)


def _layer_norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=LN_EPS)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu


def _dtype(module: nn.Module) -> torch.dtype:
    return next(module.parameters()).dtype


class MLP(nn.Module):
    """Dense layers with GELU between them."""

    def __init__(self, in_dim: int, features):
        super().__init__()
        dims = [in_dim, *features]
        for i in range(len(features)):
            self.add_module(f"Dense_{i}", nn.Linear(dims[i], dims[i + 1]))
        self.n = len(features)

    def forward(self, x):
        for i, dense in enumerate(numbered_children(self, "Dense", self.n)):
            x = dense(x)
            if i != self.n - 1:
                x = _gelu(x)
        return x


def apply_film(film_params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, 4E) params scale and shift a (B, K, 2E) tensor."""
    a, b = torch.chunk(film_params[:, None, :], 2, dim=-1)
    return a * x + b


class _XavierLinear(nn.Linear):
    """A Dense layer that flax initializes with xavier_uniform."""


class TransformerMlpBlock(nn.Module):
    """Dense -> ReLU -> Dropout -> Dense (no bias) -> Dropout."""

    def __init__(self, embed_dim: int, mlp_dim: int, dropout_rate: float, out_dim=None):
        super().__init__()
        self.Dense_0 = _XavierLinear(embed_dim, mlp_dim)
        self.Dense_1 = _XavierLinear(mlp_dim, out_dim or embed_dim, bias=False)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x):
        x = self.dropout(F.relu(self.Dense_0(x)))
        return self.dropout(self.Dense_1(x))


class MultiHeadDotProductAttention(nn.Module):
    """flax's self-attention: query/key/value/out projections (flax stores
    their kernels as (E, H, Dh) and (H, Dh, E); here they are Linear
    weights), softmax(q k / sqrt(Dh)) over the kept keys, dropout on the
    attention weights when training. `qk_norm` is flax's `normalize_qk`: a
    LayerNorm without bias over each head's features of q and k
    (`query_ln`, `key_ln`, one (Dh,) scale shared by the heads)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout_rate: float,
                 qk_norm: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.query = nn.Linear(embed_dim, embed_dim)
        self.key = nn.Linear(embed_dim, embed_dim)
        self.value = nn.Linear(embed_dim, embed_dim)
        self.out = nn.Linear(embed_dim, embed_dim)
        self.qk_norm = qk_norm
        if qk_norm:
            self.query_ln = nn.LayerNorm(embed_dim // num_heads, eps=LN_EPS, bias=False)
            self.key_ln = nn.LayerNorm(embed_dim // num_heads, eps=LN_EPS, bias=False)

    def forward(self, x, keep=None):
        B, L, E = x.shape
        H = self.num_heads

        def split(t):
            return t.reshape(B, L, H, E // H)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        if self.qk_norm:
            q, k = self.query_ln(q), self.key_ln(k)
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=keep, dropout_p=self.dropout_rate if self.training else 0.0)
        return self.out(o.transpose(1, 2).reshape(B, L, E))


class SelfAttentionBlock(nn.Module):
    """Pre- or post-norm self-attention under a boolean keep-mask."""

    def __init__(self, embed_dim, num_heads, attention_dropout_rate, dropout_rate,
                 norm_type):
        super().__init__()
        if norm_type not in ("prenorm", "postnorm"):
            raise ValueError(norm_type)
        self.norm_type = norm_type
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            embed_dim, num_heads, attention_dropout_rate)
        self.LayerNorm_0 = _layer_norm(embed_dim)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, inputs, keep=None):
        attn = self.MultiHeadDotProductAttention_0
        if self.norm_type == "prenorm":
            return self.dropout(attn(self.LayerNorm_0(inputs), keep)) + inputs
        return self.LayerNorm_0(self.dropout(attn(inputs, keep)) + inputs)


class FeedForwardBlock(nn.Module):
    def __init__(self, embed_dim, mlp_dim, dropout_rate, norm_type):
        super().__init__()
        if norm_type not in ("prenorm", "postnorm"):
            raise ValueError(norm_type)
        self.norm_type = norm_type
        self.TransformerMlpBlock_0 = TransformerMlpBlock(embed_dim, mlp_dim, dropout_rate)
        self.LayerNorm_0 = _layer_norm(embed_dim)

    def forward(self, x):
        mlp = self.TransformerMlpBlock_0
        if self.norm_type == "prenorm":
            return x + mlp(self.LayerNorm_0(x))
        return self.LayerNorm_0(x + mlp(x))


class TransformerBlock(nn.Module):
    def __init__(self, m):
        super().__init__()
        self.SelfAttentionBlock_0 = SelfAttentionBlock(
            m.embed_dim, m.num_heads, m.attention_dropout_rate, m.dropout_rate,
            m.transformer_norm_type)
        self.FeedForwardBlock_0 = FeedForwardBlock(
            m.embed_dim, m.mlp_dim, m.dropout_rate, m.transformer_norm_type)

    def forward(self, x, keep=None):
        return self.FeedForwardBlock_0(self.SelfAttentionBlock_0(x, keep))


class _Blocks(nn.Module):
    """The positional table, input dropout and `num_layers` blocks."""

    def __init__(self, m):
        super().__init__()
        # a prefix-conditional tower runs over concat_dim + conditional_dim
        self.pos = PositionalEncoding(m.embed_dim,
                                      m.concat_dim + 2 + m.get("conditional_dim", 0))
        self.dropout = nn.Dropout(m.dropout_rate)
        self.num_layers = m.num_layers
        for i in range(m.num_layers):
            self.add_module(f"TransformerBlock_{i}", TransformerBlock(m))

    def _run(self, x, keep=None):
        x = self.dropout(self.pos(x))
        for blk in numbered_children(self, "TransformerBlock", self.num_layers):
            x = blk(x, keep)
        return x


def _keep_mask(L: int, lower: bool, device) -> torch.Tensor:
    ones = torch.ones((L, L), dtype=torch.bool, device=device)
    return torch.tril(ones) if lower else torch.triu(ones)


class UniDirectionalTransformer(_Blocks):
    """A causal tower over inputs shifted by one, the time token at the
    free end."""

    def __init__(self, m, direction: str):
        super().__init__(m)
        if direction not in ("l2r", "r2l"):
            raise ValueError(direction)
        self.direction = direction

    def forward(self, x, temb, conditioner=None):
        """`conditioner` (B, P, E) goes before the time token: the towers
        then run over L + P positions."""
        cond = temb[:, None, :]
        if conditioner is not None:
            cond = torch.cat([conditioner, cond], dim=1)
        if self.direction == "l2r":
            x = torch.cat([cond, x[:, :-1]], dim=1)
        else:
            x = torch.cat([x[:, 1:], cond], dim=1)
        return self._run(x, _keep_mask(x.shape[1], self.direction == "l2r", x.device))


class ConcatReadout(nn.Module):
    def __init__(self, m, out_dim: int):
        super().__init__()
        self.MLP_0 = MLP(2 * m.embed_dim, (m.mlp_dim, out_dim))

    def forward(self, l2r, r2l, temb):
        return self.MLP_0(torch.cat([l2r, r2l], dim=-1))


class ResidualReadout(nn.Module):
    """FiLM residual readout, (B, K, E) (or (B, K, 2E) with `input_is_2e`)
    -> (B, K, out_dim)."""

    def __init__(self, m, out_dim: int, input_is_2e: bool = False):
        super().__init__()
        E = m.embed_dim
        self.n = m.num_output_ffresiduals
        self.MLP_0 = MLP(E, (m.mlp_dim, 4 * E))
        self.first = 0 if input_is_2e else 1  # index of the first FiLM Dense
        if not input_is_2e:
            self.Dense_0 = nn.Linear(E, 2 * E)
        for i in range(self.n):
            self.add_module(f"Dense_{self.first + i}", nn.Linear(4 * E, 4 * E))
            self.add_module(f"MLP_{1 + i}", MLP(2 * E, (m.mlp_dim, 2 * E)))
            self.add_module(f"LayerNorm_{i}", _layer_norm(2 * E))
        self.add_module(f"Dense_{self.first + self.n}", nn.Linear(2 * E, out_dim))

    def forward(self, x, temb):
        temb = self.MLP_0(temb)
        if self.first:
            x = self.Dense_0(x)
        for film, mlp, norm in zip(numbered_children(self, "Dense", self.n, self.first),
                                   numbered_children(self, "MLP", self.n, 1),
                                   numbered_children(self, "LayerNorm", self.n)):
            x = apply_film(film(temb), norm(x + mlp(x)))
        return getattr(self, f"Dense_{self.first + self.n}")(x)


class ConcatResidualReadout(nn.Module):
    def __init__(self, m, out_dim: int):
        super().__init__()
        self.ResidualReadout_0 = ResidualReadout(m, out_dim, input_is_2e=True)

    def forward(self, l2r, r2l, temb):
        return self.ResidualReadout_0(torch.cat([l2r, r2l], dim=-1), temb)


class CrossAttention(nn.Module):
    """Queries from l2r + r2l; keys and values from [t | l2r | r2l] under
    the joint mask: the time token, l2r keys at or before the query, r2l
    keys at or after it."""

    def __init__(self, m):
        super().__init__()
        E, Q = m.embed_dim, m.qkv_dim
        self.num_heads = m.num_heads
        self.Dense_0 = nn.Linear(E, Q, bias=False)
        self.Dense_1 = nn.Linear(E, Q)
        self.Dense_2 = nn.Linear(E, Q)
        self.Dense_3 = nn.Linear(Q, E)

    def forward(self, l2r, r2l, temb):
        B, L, _ = l2r.shape
        H = self.num_heads
        all_embed = torch.cat([temb[:, None, :], l2r, r2l], dim=1)

        def heads(t):
            return t.reshape(B, t.shape[1], H, -1).transpose(1, 2)

        q = heads(self.Dense_0(l2r + r2l))
        k, v = heads(self.Dense_1(all_embed)), heads(self.Dense_2(all_embed))
        keep = torch.cat([torch.ones((L, 1), dtype=torch.bool, device=l2r.device),
                          _keep_mask(L, True, l2r.device),
                          _keep_mask(L, False, l2r.device)], dim=1)  # (L, 2L + 1)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        return self.Dense_3(o.transpose(1, 2).reshape(B, L, -1))


class AttentionReadout(nn.Module):
    def __init__(self, m, out_dim: int):
        super().__init__()
        self.prenorm = m.transformer_norm_type == "prenorm"
        self.LayerNorm_0 = _layer_norm(m.embed_dim)
        if self.prenorm:
            self.LayerNorm_1 = _layer_norm(m.embed_dim)
        self.CrossAttention_0 = CrossAttention(m)
        self.ResidualReadout_0 = ResidualReadout(m, out_dim)

    def forward(self, l2r, r2l, temb):
        inputs = l2r + r2l
        if self.prenorm:
            x = self.CrossAttention_0(self.LayerNorm_0(l2r), self.LayerNorm_1(r2l),
                                      temb) + inputs
        else:
            x = self.LayerNorm_0(self.CrossAttention_0(l2r, r2l, temb) + inputs)
        return self.ResidualReadout_0(x, temb)


_READOUTS = {"concat": ("ConcatReadout_0", ConcatReadout),
             "res_concat": ("ConcatResidualReadout_0", ConcatResidualReadout),
             "attention": ("AttentionReadout_0", AttentionReadout)}


class _InputEmbed(nn.Module):
    """Categorical (one-hot Dense or Embed) or normalized-scalar input
    embedding; `vocab_extra` adds the mask state."""

    def __init__(self, m, S: int, vocab_extra: int = 0):
        super().__init__()
        self.S = S
        self.vocab = S + vocab_extra
        self.use_cat, self.one_hot = bool(m.use_cat), bool(m.use_one_hot_input)
        if self.use_cat and not self.one_hot:
            self.Embed_0 = nn.Embedding(self.vocab, m.embed_dim)
        else:
            self.Dense_0 = nn.Linear(self.vocab if self.use_cat else 1, m.embed_dim)

    def forward(self, x):
        if self.use_cat and not self.one_hot:
            return self.Embed_0(x.long())
        dt = self.Dense_0.weight.dtype
        if self.use_cat:
            return self.Dense_0(F.one_hot(x.long(), self.vocab).to(dt))
        return self.Dense_0(normalize_states(x, self.S).to(dt)[..., None])


def _sinusoid(t, m, dim, dtype):
    return timestep_embedding(t * m.time_scale_factor, dim).to(dtype)


class BidirectionalTransformer(nn.Module):
    """Two causal towers and a readout: (B, D) states, (B,) t -> (B, D,
    readout_dim)."""

    def __init__(self, cfg, readout_dim=None, learned_temb: bool = True):
        super().__init__()
        m = cfg.model
        self.m = m
        E = m.embed_dim
        self.learned_temb = learned_temb
        if learned_temb:
            self.MLP_0 = MLP(E // 2, (m.mlp_dim, E))
        self._InputEmbed_0 = _InputEmbed(m, cfg.data.S)
        self.UniDirectionalTransformer_0 = UniDirectionalTransformer(m, "l2r")
        self.UniDirectionalTransformer_1 = UniDirectionalTransformer(m, "r2l")
        name, readout = _READOUTS.get(m.bidir_readout, (None, None))
        if readout is None:
            raise ValueError(f"unknown bidir_readout {m.bidir_readout}")
        self.readout_name = name
        self.add_module(name, readout(
            m, readout_dim if readout_dim is not None else cfg.data.S))

    def forward(self, x, t):
        E, dt = self.m.embed_dim, _dtype(self)
        if self.learned_temb:
            temb = self.MLP_0(_sinusoid(t, self.m, E // 2, dt))
        else:
            temb = _sinusoid(t, self.m, E, dt)
        x_embed = self._InputEmbed_0(x)
        l2r = self.UniDirectionalTransformer_0(x_embed, temb)
        r2l = self.UniDirectionalTransformer_1(x_embed, temb)
        return getattr(self, self.readout_name)(l2r, r2l, temb)


class PrefixConditionalBidirTransformer(BidirectionalTransformer):
    """The first `model.conditional_dim` positions condition both towers
    (their embeddings go before the time token); the readout spans the rest,
    and the prefix positions get zero logits."""

    def __init__(self, cfg, readout_dim=None):
        super().__init__(cfg, readout_dim=readout_dim, learned_temb=True)
        self.cond_dim = cfg.model.get("conditional_dim", 0)

    def forward(self, x, t):
        E, dt = self.m.embed_dim, _dtype(self)
        temb = self.MLP_0(_sinusoid(t, self.m, E // 2, dt))
        x_embed = self._InputEmbed_0(x)
        conditioner = x_embed[:, :self.cond_dim]
        n_data = x.shape[1] - self.cond_dim
        l2r = self.UniDirectionalTransformer_0(x_embed, temb, conditioner)[:, -n_data:]
        r2l = self.UniDirectionalTransformer_1(x_embed, temb, conditioner)[:, :n_data]
        logits = getattr(self, self.readout_name)(l2r, r2l, temb)
        dummy = logits.new_zeros((x.shape[0], self.cond_dim, logits.shape[-1]))
        return torch.cat([dummy, logits], dim=1)


class TransformerEncoderH(_Blocks):
    """Prepends the time token, runs the blocks unmasked, strips it."""

    def forward(self, x_embed, temb):
        return self._run(torch.cat([temb[:, None, :], x_embed], dim=1))[:, 1:]


def _readout_head(module, m, S):
    if m.readout == "mlp":
        module.MLP_0 = MLP(m.embed_dim, (m.mlp_dim, S))
    elif m.readout == "resnet":
        module.ResidualReadout_0 = ResidualReadout(m, S)
    else:
        raise ValueError(f"unknown readout {m.readout}")


def _apply_head(module, embed, temb):
    if module.m.readout == "mlp":
        return module.MLP_0(embed)
    return module.ResidualReadout_0(embed, temb)


class MaskedTransformer(nn.Module):
    """S+1 mask-vocabulary encoder; the full (B, D, S) readout."""

    def __init__(self, cfg):
        super().__init__()
        self.m = cfg.model
        self._InputEmbed_0 = _InputEmbed(self.m, cfg.data.S, vocab_extra=1)
        self.TransformerEncoderH_0 = TransformerEncoderH(self.m)
        _readout_head(self, self.m, cfg.data.S)

    def forward(self, x, temb):
        embed = self.TransformerEncoderH_0(self._InputEmbed_0(x), temb)
        return _apply_head(self, embed, temb)


class _ScanStep(nn.Module):
    """The step JAX scans over positions; it holds the one masked net."""

    def __init__(self, cfg):
        super().__init__()
        self.MaskedTransformer_0 = MaskedTransformer(cfg)


class EnumerativeTransformer(nn.Module):
    """Masks each position in turn and reads out its logits, one forward per
    position (positions below `conditional_dim` get zero logits)."""

    def __init__(self, cfg):
        super().__init__()
        self.m, self.S = cfg.model, cfg.data.S
        self.Scan_Step_0 = _ScanStep(cfg)

    def forward(self, x, t):
        temb = _sinusoid(t, self.m, self.m.embed_dim, _dtype(self))
        B, D = x.shape
        prefix = self.m.get("conditional_dim", 0)
        iota = torch.arange(D, device=x.device)[None, :]
        net = self.Scan_Step_0.MaskedTransformer_0
        logits = [net(torch.where(iota == pos, self.S, x), temb)[:, pos]
                  for pos in range(prefix, D)]
        logits = torch.stack(logits, dim=1)
        if prefix:
            dummy = logits.new_zeros((B, prefix, self.S))
            logits = torch.cat([dummy, logits], dim=1)
        return logits


class BertEnumTransformer(nn.Module):
    """One-pass Bert-style encoder with a readout."""

    def __init__(self, cfg):
        super().__init__()
        self.m = cfg.model
        self._InputEmbed_0 = _InputEmbed(self.m, cfg.data.S)
        self.TransformerEncoderH_0 = TransformerEncoderH(self.m)
        _readout_head(self, self.m, cfg.data.S)

    def forward(self, x, t):
        temb = _sinusoid(t, self.m, self.m.embed_dim, _dtype(self))
        embed = self.TransformerEncoderH_0(self._InputEmbed_0(x), temb)
        return _apply_head(self, embed, temb)


# ---------------------------------------------------------------------------
# the zoo's wrappers
# ---------------------------------------------------------------------------


class _FlaxInit(nn.Module):
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Draw the weights as the JAX package initializes them: Dense
        lecun-normal (xavier-uniform in the transformer MLP blocks), zero
        biases, LayerNorm scale 1, Embed normal with std 1/sqrt(features);
        from `generator`, in the order of `modules()`."""
        for mod in self.modules():
            if isinstance(mod, _XavierLinear):
                xavier_uniform_(mod.weight, generator)
            elif isinstance(mod, nn.Linear):
                lecun_normal_(mod.weight, generator)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
            elif isinstance(mod, nn.Embedding):
                draw = torch.randn(mod.weight.shape, generator=generator)
                mod.weight.copy_(draw / mod.weight.shape[1] ** 0.5)
            if isinstance(mod, (nn.Linear, nn.LayerNorm)) and mod.bias is not None:
                mod.bias.zero_()


def _learned_temb(cfg) -> bool:
    return cfg.model.get("nets", "bidir_transformer") != "bidir_transformer2"


class HollowTransformerWrapper(_FlaxInit):
    def __init__(self, cfg, readout_dim=None):
        super().__init__()
        self.BidirectionalTransformer_0 = BidirectionalTransformer(
            cfg, readout_dim=readout_dim, learned_temb=_learned_temb(cfg))

    def forward(self, x, t):
        return self.BidirectionalTransformer_0(x, t)


class HollowLogisticsWrapper(_FlaxInit):
    """The hollow network with a truncated-logistic head: (mu, log_scale) per
    position -> S-bin logits."""

    def __init__(self, cfg):
        super().__init__()
        self.S = cfg.data.S
        self.fix_logistic = bool(cfg.model.fix_logistic)
        self.BidirectionalTransformer_0 = BidirectionalTransformer(
            cfg, readout_dim=2, learned_temb=_learned_temb(cfg))

    def forward(self, x, t):
        out = self.BidirectionalTransformer_0(x, t)  # (B, D, 2)
        return logistic_bin_logits(out[..., 0], out[..., 1], self.S, self.fix_logistic)


class EnumerativeTransformerWrapper(_FlaxInit):
    def __init__(self, cfg):
        super().__init__()
        self.EnumerativeTransformer_0 = EnumerativeTransformer(cfg)

    def forward(self, x, t):
        return self.EnumerativeTransformer_0(x, t)


class BertEnumTransformerWrapper(_FlaxInit):
    def __init__(self, cfg):
        super().__init__()
        self.BertEnumTransformer_0 = BertEnumTransformer(cfg)

    def forward(self, x, t):
        return self.BertEnumTransformer_0(x, t)
