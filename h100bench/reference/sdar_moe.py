"""The reference family of SDAR's block-diffusion training
(`sdar30b_a3b_l8_e16`): the decoder over x_t ⊕ x_0 (`sdar_net.py`), the
absorbing process, the block-diffusion CT-ELBO in its absorbing form, the
analytic FLOP count and the tiny widths of the harness's CPU tests. The
contract is in `reference/__init__.py`."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from h100bench.reference.sdar_net import Net

__all__ = ["Net", "process", "per_row_loss", "forward_flops", "shrink", "weight_kinds",
           "attention_flops"]


class Absorbing:
    """The mask process: a token keeps its value with probability
    α_t = 1 - t, else it is the mask id, the last of the vocabulary."""

    def __init__(self, mask_id: int):
        self.mask_id = mask_id

    @staticmethod
    def keep(t):
        return 1.0 - t


def process(cfg: dict, device) -> Absorbing:
    return Absorbing(cfg["data"]["S"])


def per_row_loss(net, proc, cfg: dict, x0, gen, n_iter: int):
    """(B,) terms and the (B, L, V) logits of the noisy half. Per row one t
    per block, uniform in [min_time, 1), then one uniform draw a position:
    masked where it is at least α_t. A row's term is
    (1/L) Σ_i 1[masked_i] (1/t_i) CE_i, CE under the logits with the mask
    id's left out of the softmax."""
    B, L = x0.shape
    block, min_t = cfg["model"]["block_length"], cfg["loss"]["min_time"]
    t = torch.rand((B, L // block), generator=gen, device=x0.device)
    t = (t * (1.0 - min_t) + min_t).repeat_interleave(block, dim=1)
    u = torch.rand((B, L), generator=gen, device=x0.device)
    masked = u >= proc.keep(t)
    x_t = torch.where(masked, torch.full_like(x0, proc.mask_id), x0)
    logits = net(torch.cat([x_t, x0], dim=1))
    cols = torch.arange(logits.shape[-1], device=x0.device)
    logp = F.log_softmax(torch.where(cols == proc.mask_id, float("-inf"), logits), dim=-1)
    ce = -torch.gather(logp, -1, x0.long()[..., None])[..., 0]
    return (masked.float() * (1.0 / t) * ce).sum(1) / L, logits


def kept_pairs(L: int, block: int) -> int:
    """The (query, key) pairs of one sequence's stream that the mask keeps:
    the n = L / block noisy blocks see their own block and the clean blocks
    before it, the clean blocks their own and those before it:
    block² (n + n(n-1)/2 + n(n+1)/2) = block² n (n + 1)."""
    n = L // block
    return block * block * n * (n + 1)


def attention_flops(cfg: dict, batch: int) -> float:
    """The forward FLOPs of the attention's kept pairs, every layer: q·k and
    the weights times v, 2 * head_dim each, for each query head."""
    m = cfg["model"]
    L = math.prod(cfg["data"]["shape"])
    per_layer = 4.0 * m["head_dim"] * m["num_heads"] * kept_pairs(L, m["block_length"])
    return batch * m["num_layers"] * per_layer


def forward_flops(cfg: dict, batch: int) -> float:
    """FLOPs of one forward at `batch`, counted from the shapes: the
    projections of the 2L positions, the router, the held experts at the
    expected load of top_k * held / num_experts copies a position, the
    attention over the kept pairs alone, and the head over the noisy half."""
    m = cfg["model"]
    L = math.prod(cfg["data"]["shape"])
    d, H, KV, Dh = m["hidden_size"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    proj = 2.0 * d * (H + 2 * KV) * Dh + 2.0 * H * Dh * d
    router = 2.0 * d * m["num_experts"]
    load = m["num_experts_per_tok"] * m["experts_held"] / m["num_experts"]
    experts = load * 3 * 2.0 * d * m["moe_intermediate_size"]
    per_layer = 2 * L * (proj + router + experts)
    head = 2.0 * d * m["vocab_size"] * L
    return batch * (m["num_layers"] * per_layer + head) + attention_flops(cfg, batch)


def weight_kinds(net) -> dict:
    """An RMSNorm's scale is a norm; every other leaf a kernel whose fan is
    (out + in) / 2, an expert bank's (held, out, in) too."""
    kinds = {}
    for name, p in net.named_parameters():
        if p.dim() == 1:
            kinds[name] = "norm"
        else:
            kinds[name] = ("fan", (p.shape[-2] + p.shape[-1]) / 2.0)
    return kinds


def shrink(cfg: dict) -> dict:
    """2 layers of 64, 4 query and 2 KV heads of 16, 8 experts of width 32
    with 4 held and 2 a token, a vocabulary of 64 (63 ids and the mask),
    L = 32 in blocks of 4, B = 2."""
    cfg["model"].update(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, head_dim=16,
                        num_experts=8, experts_held=4, num_experts_per_tok=2,
                        moe_intermediate_size=32, vocab_size=64, block_length=4)
    cfg["data"].update(S=63, shape=[32], batch_size=2)
    cfg["about"]["dataset_rows"] = 32
    return cfg
