"""SDAR's block-diffusion decoder in plain float32 PyTorch: the benchmark's
reference of `sdar_moe` (a Qwen3-MoE layer) over the stream x_t ⊕ x_0.

The parameters carry the program's names and shapes (HF's Qwen3-MoE names,
the experts held as banks of (held, out, in)), so one set of seeded weights
loads into both. The attention is a dense (2L, 2L) score matrix with the
block-diffusion mask and a float32 softmax, one (sequence, KV head) at a
time under `torch.utils.checkpoint`, so that only its inputs are kept for
the backward. The expert layer finds each held expert's tokens by
comparing the router's choices with the expert's id. Run it with TF32 off.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight


def rope(L: int, head_dim: int, theta: float, device):
    """cos and sin at positions 0..L-1, (L, head_dim), float32, as HF's
    rotary embedding makes them."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.int64).float() / head_dim))
    freqs = torch.outer(torch.arange(L, dtype=torch.int64).float(), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(device), emb.sin().to(device)


def rotate(x, cos, sin):
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def block_mask(L: int, block: int, device) -> torch.Tensor:
    """(2L, 2L), True where a query of the stream x_t ⊕ x_0 sees a key: a
    noisy query the noisy keys of its own block and the clean keys of
    earlier blocks; a clean query the clean keys of its own and earlier
    blocks."""
    i = torch.arange(2 * L, device=device)
    noisy, b = i < L, (i % L) // block
    qn, kn, qb, kb = noisy[:, None], noisy[None, :], b[:, None], b[None, :]
    return torch.where(qn, torch.where(kn, qb == kb, kb < qb), ~kn & (kb <= qb))


def attend(q, k, v, mask):
    """q (G, N, Dh), k and v (N, Dh) -> (G, N, Dh)."""
    scores = (q @ k.T) / (q.shape[-1] ** 0.5)
    weights = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return weights @ v


class Attention(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        d, H, KV, Dh = m["hidden_size"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
        self.H, self.KV, self.Dh = H, KV, Dh
        self.q_proj = nn.Linear(d, H * Dh, bias=False)
        self.k_proj = nn.Linear(d, KV * Dh, bias=False)
        self.v_proj = nn.Linear(d, KV * Dh, bias=False)
        self.o_proj = nn.Linear(H * Dh, d, bias=False)
        self.q_norm = RMSNorm(Dh, m["rms_norm_eps"])
        self.k_norm = RMSNorm(Dh, m["rms_norm_eps"])

    def forward(self, x, cos, sin, mask):
        B, N, _ = x.shape
        q = rotate(self.q_norm(self.q_proj(x).view(B, N, self.H, self.Dh)), cos, sin)
        k = rotate(self.k_norm(self.k_proj(x).view(B, N, self.KV, self.Dh)), cos, sin)
        v = self.v_proj(x).view(B, N, self.KV, self.Dh)
        G = self.H // self.KV
        rows = []
        for b in range(B):
            heads = []
            for g in range(self.KV):
                qg = q[b, :, g * G:(g + 1) * G].transpose(0, 1)  # (G, N, Dh)
                heads.append(checkpoint(attend, qg, k[b, :, g], v[b, :, g], mask,
                                        use_reentrant=False))
            rows.append(torch.cat(heads, dim=0).transpose(0, 1).reshape(N, self.H * self.Dh))
        return self.o_proj(torch.stack(rows))


class Experts(nn.Module):
    """The router over all experts and the held experts' banks."""

    def __init__(self, m: dict):
        super().__init__()
        d, W, E, held = (m["hidden_size"], m["moe_intermediate_size"], m["num_experts"],
                         m["experts_held"])
        self.offset, self.held, self.k = m.get("expert_offset", 0), held, m["num_experts_per_tok"]
        self.norm_topk = m["norm_topk_prob"]
        self.gate = nn.Linear(d, E, bias=False)
        self.gate_proj = nn.Parameter(torch.zeros(held, W, d))
        self.up_proj = nn.Parameter(torch.zeros(held, W, d))
        self.down_proj = nn.Parameter(torch.zeros(held, d, W))

    def forward(self, h):
        """h (tokens, d) -> the held experts' part of the layer's output."""
        probs = torch.softmax(h @ self.gate.weight.T, dim=-1)
        w, idx = torch.topk(probs, self.k, dim=-1)
        if self.norm_topk:
            w = w / w.sum(-1, keepdim=True)
        out = torch.zeros_like(h)
        for e in range(self.held):
            chosen = idx == self.offset + e  # (tokens, k)
            rows = chosen.any(-1).nonzero().squeeze(1)
            weight = (w * chosen).sum(-1)[rows]
            x = h[rows]
            y = (F.silu(x @ self.gate_proj[e].T) * (x @ self.up_proj[e].T)) @ self.down_proj[e].T
            out = out.index_add(0, rows, y * weight[:, None])
        return out


class Layer(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        self.input_layernorm = RMSNorm(m["hidden_size"], m["rms_norm_eps"])
        self.self_attn = Attention(m)
        self.post_attention_layernorm = RMSNorm(m["hidden_size"], m["rms_norm_eps"])
        self.mlp = Experts(m)

    def forward(self, x, cos, sin, mask):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, mask)
        B, N, d = x.shape
        return x + self.mlp(self.post_attention_layernorm(x).reshape(B * N, d)).view(B, N, d)


class Net(nn.Module):
    """(B, 2L) ids x_t ⊕ x_0 -> (B, L, V) logits of the noisy half."""

    def __init__(self, cfg: dict):
        super().__init__()
        m = cfg["model"]
        self.m = m
        self.embed_tokens = nn.Embedding(m["vocab_size"], m["hidden_size"])
        self.layers = nn.ModuleList(Layer(m) for _ in range(m["num_layers"]))
        self.norm = RMSNorm(m["hidden_size"], m["rms_norm_eps"])
        self.lm_head = nn.Linear(m["hidden_size"], m["vocab_size"], bias=False)

    def forward(self, x, t=None):
        B, N = x.shape
        L = N // 2
        cos, sin = rope(L, self.m["head_dim"], float(self.m["rope_theta"]), x.device)
        cos, sin = torch.cat([cos, cos])[None, :, None], torch.cat([sin, sin])[None, :, None]
        mask = block_mask(L, self.m["block_length"], x.device)
        h = self.embed_tokens(x.long())
        for layer in self.layers:
            h = layer(h, cos, sin, mask)
        return self.lm_head(self.norm(h[:, :L]))
