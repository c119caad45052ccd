"""SDAR's block-diffusion decoder (`sdar_moe`, whose layer is Qwen3-MoE's),
trained with the absorbing process, with an expert layer that holds a
share of the experts.

The network reads the noisy and the clean copy of each sequence as one
stream of 2L ids, x_t ⊕ x_0 (BD3-LM's vectorised training, Arriola et al.
2025, arXiv:2503.09573), and returns logits over the vocabulary for the
noisy half, (B, L, V):

- embedding -> layers -> RMSNorm -> an untied head. A layer is
  x + Attn(RMSNorm(x)), then x + MoE(RMSNorm(x)).
- Attn: q, k, v without bias, an RMSNorm over each head of q and of k,
  RoPE (the two copies share the position ids 0..L-1), grouped-query
  attention, the o-projection. With block index b(i) = (i mod L) // block
  over the stream, a noisy query sees the noisy keys of its own block and
  the clean keys of earlier blocks; a clean query sees the clean keys of
  its own and earlier blocks, and never a noisy key.
- MoE: router logits in float32 over all `num_experts`, softmax, top-k,
  renormalised (`norm_topk_prob`). The layer holds experts
  [expert_offset, expert_offset + experts_held), as banks of (held, out,
  in), and adds for each token the sum over its chosen experts that it
  holds of w_e * down_e(SiLU(gate_e h) * up_e h): no capacity and no
  dropped token. What the experts held elsewhere add is left out, as on one
  card of expert parallelism.

The attention runs each half of the stream in up to `TILES` query tiles of
whole blocks, each over the keys its tile can see (the clean keys up to
the tile's end; a noisy tile its own noisy keys too), with the blocks
inside the tile masked by an additive bias:
`F.scaled_dot_product_attention`'s memory-efficient kernel on a CUDA
device. Eight tiles do 1.25x the kept pairs' work (tiles of 512 at
L = 4096), where a dense mask would do 4x; more tiles would copy more
keys. The query heads of a KV head are the head axis of one batch row,
their key and value expanded over it, so no key or value is repeated in
memory.

The expert layer sorts the token copies by the held expert they go to and
reads the held experts' counts on the host once a layer to split them
(`MOE_HOST_READS` counts those reads and the forwards).

The dense products, q, k, v and o of each layer and the head, run under
the `ctdd.dense` span through `ops/tf32x3_gemm.linear`: in float32 their
input and weight gradients take the 3xTF32 kernel (tensor cores at float32
accuracy; q, k and v as one product over their three weights), and so does
the head's forward. The forwards of q, k, v and o stay on `F.linear`, one a
weight: their outputs reach the routers, whose top-8 choice flips at a near
tie under any other rounding, so they round as a plain float32 model's
products do. `DENSE_FLOPS` counts the dense forward FLOPs, 2 M N K each.
The experts' products and the router stay on `F.linear`.

`model.compute_dtype="bfloat16"` runs the projections, the experts, the
head and the attention in bf16 over float32 weights; the router, the norms
and the embedding stay float32.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ctdd_tpu_torch.ops import tf32x3_gemm
from ctdd_tpu_torch.utils.trace import ATTN, DENSE, MOE_EXPERTS, MOE_ROUTE, span

# the host's reads of the held experts' counts, and the network's forwards,
# in this process
MOE_HOST_READS = {"reads": 0, "forwards": 0}

# the forward FLOPs of the dense products (2 M N K each) in this process
DENSE_FLOPS = {"forward": 0}

# the most query tiles a half of the stream is cut into
TILES = 8


def _linear(x: torch.Tensor, w: torch.Tensor, bf16: bool) -> torch.Tensor:
    """x @ w.T; in bf16 over the float32 weight, the result float32."""
    if bf16:
        return F.linear(x.to(torch.bfloat16), w.to(torch.bfloat16)).float()
    return F.linear(x, w)


def _dense(x: torch.Tensor, bf16: bool, *weights: torch.Tensor,
           before_routing: bool) -> Tuple[torch.Tensor, ...]:
    """x @ w.T for each weight (the attention's projections, the head), under
    `ctdd.dense`: in float32 through `tf32x3_gemm.linear`, its forward on
    `F.linear` where the output reaches a router; in bf16 one `_linear` a
    weight."""
    DENSE_FLOPS["forward"] += 2 * x.numel() * sum(w.shape[0] for w in weights)
    with span(DENSE):
        if bf16:
            return tuple(_linear(x, w, True) for w in weights)
        return tf32x3_gemm.linear(x, *weights, kernel_forward=not before_routing)


def rope_tables(L: int, head_dim: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of RoPE at positions 0..L-1, (L, head_dim), made in
    float32 on the host as HF's rotary embedding makes them."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.int64).float() / head_dim))
    freqs = torch.outer(torch.arange(L, dtype=torch.int64).float(), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(device), emb.sin().to(device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, N, heads, head_dim) rotated by the (N, head_dim) tables."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[None, :, None, :] + rotated * sin[None, :, None, :]


class TileBias:
    """The query tiles of a half of the stream, L positions in blocks of
    `block`: the most whole-block tiles, up to `TILES`, that divide it; and
    their additive biases (0 or -inf), (T, keys), made once for each tile
    kind, start and dtype."""

    def __init__(self, L: int, block: int, device):
        if L % block:
            raise ValueError(f"L={L} is not a multiple of the block length {block}")
        tiles = max(n for n in range(1, TILES + 1) if (L // block) % n == 0)
        self.L, self.T, self.block, self.device = L, L // tiles, block, device
        self._made: Dict[tuple, torch.Tensor] = {}

    def get(self, noisy: bool, start: int, dtype) -> torch.Tensor:
        key = (noisy, start, dtype)
        if key not in self._made:
            T, blk = self.T, self.block
            i = torch.arange(T, device=self.device)
            qb = (start + i)[:, None] // blk
            cb = (start + i)[None, :] // blk  # the tile's own positions as keys
            if noisy:
                # clean keys of earlier blocks; the noisy keys of its own block
                seen = torch.cat([cb < qb, cb == qb], dim=1)
            else:
                seen = cb <= qb
            bias = torch.zeros(seen.shape, dtype=dtype, device=self.device)
            bias.masked_fill_(~seen, float("-inf"))
            # every clean key before the tile is seen
            before = torch.zeros((T, start), dtype=dtype, device=self.device)
            self._made[key] = torch.cat([before, bias], dim=1)
        return self._made[key]


def _sdpa(q, k, v, bias):
    """The memory-efficient kernel on a CUDA device (an error, not a quiet
    fallback, where it cannot run); PyTorch's choice elsewhere."""
    if q.device.type == "cuda":
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)


def block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    biases: TileBias) -> torch.Tensor:
    """q (B, 2L, H, Dh), k and v (B, 2L, KV, Dh) over the stream x_t ⊕ x_0
    -> (B, 2L, H * Dh), by query tiles over the keys each tile can see."""
    B, N, H, Dh = q.shape
    KV = k.shape[2]
    G, L, T = H // KV, biases.L, biases.T
    # (B * KV, G, N, Dh): a KV head's query heads on the head axis
    qg = q.reshape(B, N, KV, G, Dh).permute(0, 2, 3, 1, 4).reshape(B * KV, G, N, Dh)
    kg = k.permute(0, 2, 1, 3).reshape(B * KV, 1, N, Dh)
    vg = v.permute(0, 2, 1, 3).reshape(B * KV, 1, N, Dh)
    outs = []
    for noisy in (True, False):
        for s in range(0, L, T):
            keys, vals = kg[:, :, L:L + s + T], vg[:, :, L:L + s + T]
            if noisy:
                keys = torch.cat([keys, kg[:, :, s:s + T]], dim=2)
                vals = torch.cat([vals, vg[:, :, s:s + T]], dim=2)
            rows = qg[:, :, s:s + T] if noisy else qg[:, :, L + s:L + s + T]
            outs.append(_sdpa(rows, keys.expand(-1, G, -1, -1), vals.expand(-1, G, -1, -1),
                              biases.get(noisy, s, q.dtype)))
    o = torch.cat(outs, dim=2)  # (B * KV, G, N, Dh), the stream's order
    return o.reshape(B, KV, G, N, Dh).permute(0, 3, 1, 2, 4).reshape(B, N, H * Dh)


class BlockAttention(nn.Module):
    def __init__(self, d: int, heads: int, kv_heads: int, head_dim: int, eps: float,
                 bf16: bool):
        super().__init__()
        self.heads, self.kv_heads, self.head_dim, self.bf16 = heads, kv_heads, head_dim, bf16
        self.q_proj = nn.Linear(d, heads * head_dim, bias=False)
        self.k_proj = nn.Linear(d, kv_heads * head_dim, bias=False)
        self.v_proj = nn.Linear(d, kv_heads * head_dim, bias=False)
        self.o_proj = nn.Linear(heads * head_dim, d, bias=False)
        self.q_norm = nn.RMSNorm(head_dim, eps=eps)
        self.k_norm = nn.RMSNorm(head_dim, eps=eps)

    def forward(self, x, cos, sin, biases: TileBias):
        B, N, _ = x.shape
        q, k, v = _dense(x, self.bf16, self.q_proj.weight, self.k_proj.weight,
                         self.v_proj.weight, before_routing=True)
        q = q.view(B, N, self.heads, self.head_dim)
        k = k.view(B, N, self.kv_heads, self.head_dim)
        v = v.view(B, N, self.kv_heads, self.head_dim)
        q = apply_rope(self.q_norm(q), cos, sin)
        k = apply_rope(self.k_norm(k), cos, sin)
        with span(ATTN):
            if self.bf16:
                q, k, v = q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)
            o = block_attention(q, k, v, biases).float()
        return _dense(o, self.bf16, self.o_proj.weight, before_routing=True)[0]


class ExpertShare(nn.Module):
    """The expert layer of one card: routes over all `num_experts` and
    computes the part of the result its `held` experts give."""

    def __init__(self, d: int, width: int, num_experts: int, held: int, offset: int,
                 top_k: int, norm_topk: bool, bf16: bool):
        super().__init__()
        if not 0 <= offset <= num_experts - held:
            raise ValueError(f"experts [{offset}, {offset + held}) lie outside the "
                             f"{num_experts} routed")
        self.held, self.offset, self.top_k = held, offset, top_k
        self.norm_topk, self.bf16 = norm_topk, bf16
        self.gate = nn.Linear(d, num_experts, bias=False)
        self.gate_proj = nn.Parameter(torch.empty(held, width, d))
        self.up_proj = nn.Parameter(torch.empty(held, width, d))
        self.down_proj = nn.Parameter(torch.empty(held, d, width))
        for bank in (self.gate_proj, self.up_proj, self.down_proj):
            bound = math.sqrt(3.0 / ((bank.shape[1] + bank.shape[2]) / 2.0))
            nn.init.uniform_(bank, -bound, bound)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """h (tokens, d) float32 -> the held experts' part, (tokens, d)."""
        with span(MOE_ROUTE):
            probs = torch.softmax(F.linear(h, self.gate.weight), dim=-1)
            w, idx = torch.topk(probs, self.top_k, dim=-1)
            if self.norm_topk:
                w = w / w.sum(dim=-1, keepdim=True)
            local = idx - self.offset
            # each token copy's held expert, or `held` where it is held elsewhere
            slot = torch.where((local >= 0) & (local < self.held), local,
                               torch.full_like(local, self.held)).reshape(-1)
            order = torch.argsort(slot, stable=True)
            counts = torch.bincount(slot, minlength=self.held + 1)[:self.held].tolist()
            MOE_HOST_READS["reads"] += 1
            pick = order[:sum(counts)]
            token = pick // self.top_k
            xs = h[token]
            ws = w.reshape(-1)[pick]
        with span(MOE_EXPERTS):
            outs = []
            for e, xe in enumerate(torch.split(xs, counts)):
                a = _linear(xe, self.gate_proj[e], self.bf16)
                b = _linear(xe, self.up_proj[e], self.bf16)
                outs.append(_linear(F.silu(a) * b, self.down_proj[e], self.bf16))
            y = torch.cat(outs) * ws[:, None]
            return torch.zeros_like(h).index_add_(0, token, y)


class SDARLayer(nn.Module):
    def __init__(self, m, bf16: bool):
        super().__init__()
        d, eps = m.hidden_size, m.rms_norm_eps
        self.input_layernorm = nn.RMSNorm(d, eps=eps)
        self.self_attn = BlockAttention(d, m.num_heads, m.num_kv_heads, m.head_dim, eps, bf16)
        self.post_attention_layernorm = nn.RMSNorm(d, eps=eps)
        self.mlp = ExpertShare(d, m.moe_intermediate_size, m.num_experts, m.experts_held,
                               m.get("expert_offset", 0), m.num_experts_per_tok,
                               m.norm_topk_prob, bf16)

    def forward(self, x, cos, sin, biases):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, biases)
        B, N, d = x.shape
        return x + self.mlp(self.post_attention_layernorm(x).reshape(B * N, d)).view(B, N, d)


class SDARMoE(nn.Module):
    """(B, 2L) ids x_t ⊕ x_0 (and the loss's times, unused: the network is
    not told the time) -> (B, L, V) logits of the noisy half."""

    def __init__(self, cfg):
        super().__init__()
        m = cfg.model
        name = m.get("compute_dtype", "float32")
        if name not in ("float32", "bfloat16"):
            raise ValueError(f"unknown model.compute_dtype {name!r}")
        self.bf16 = name == "bfloat16"
        self.block = int(m.block_length)
        self.head_dim, self.theta = m.head_dim, float(m.rope_theta)
        self.embed_tokens = nn.Embedding(m.vocab_size, m.hidden_size)
        self.layers = nn.ModuleList(SDARLayer(m, self.bf16) for _ in range(m.num_layers))
        self.norm = nn.RMSNorm(m.hidden_size, eps=m.rms_norm_eps)
        self.lm_head = nn.Linear(m.hidden_size, m.vocab_size, bias=False)
        self._tables: Dict[tuple, tuple] = {}

    def _tables_for(self, L: int, device) -> tuple:
        """RoPE's tables over the stream (both copies at 0..L-1) and the
        tiles' biases, made once for each L and device."""
        key = (L, str(device))
        if key not in self._tables:
            cos, sin = rope_tables(L, self.head_dim, self.theta, device)
            self._tables[key] = (torch.cat([cos, cos]), torch.cat([sin, sin]),
                                 TileBias(L, self.block, device))
        return self._tables[key]

    def forward(self, x: torch.Tensor, t: torch.Tensor = None) -> torch.Tensor:
        B, N = x.shape
        if N % 2:
            raise ValueError(f"the stream x_t ⊕ x_0 has an even length, not {N}")
        L = N // 2
        MOE_HOST_READS["forwards"] += 1
        cos, sin, biases = self._tables_for(L, x.device)
        h = self.embed_tokens(x)
        for layer in self.layers:
            h = layer(h, cos, sin, biases)
        return _dense(self.norm(h[:, :L]), self.bf16, self.lm_head.weight,
                      before_routing=False)[0]
