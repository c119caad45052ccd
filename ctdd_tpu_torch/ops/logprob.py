"""Logits -> per-dimension log-probabilities.

Counterpart of ctdd_tpu/ops/logprob.py. Network logits (B, D, S) become
log-probs three ways, by `logit_type`:

- "direct":           log_softmax(logits)
- "reverse_prob":     log(softmax(logits) @ q_{t|0} + 1e-35)
- "reverse_logscale": logsumexp(log_softmax(logits)[..., None] + log q_{t|0})

`q_{t|0}` is one (S, S) table per sample, (B, S, S), or one table shared by
the batch, (S, S) (the samplers' steps share their time). Returns (ll_all
(B, D, S), ll_xt (B, D)), ll_xt gathered at the target state.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ctdd_tpu_torch.utils.math import NEG_INF

LOGIT_DIRECT = "direct"
LOGIT_REVERSE_PROB = "reverse_prob"
LOGIT_REVERSE_LOGSCALE = "reverse_logscale"


def log_prob_from_logits(logit_type: str, logits: torch.Tensor,
                         qt0: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, D, S) log-probs; `qt0` (B, S, S) or (S, S), unused by "direct".
    "reverse_logscale" materialises (B, D, S, S)."""
    if logit_type == LOGIT_DIRECT:
        return torch.log_softmax(logits, dim=-1)
    qt0 = qt0.to(logits.dtype)  # float64 logits (a reference) keep float64
    shared = qt0.dim() == 2
    if logit_type == LOGIT_REVERSE_PROB:
        p0t = torch.softmax(logits, dim=-1)
        prob = p0t @ qt0 if shared else torch.einsum("bds,bsk->bdk", p0t, qt0)
        return torch.log(prob + 1e-35)
    if logit_type == LOGIT_REVERSE_LOGSCALE:
        log_p0t = torch.log_softmax(logits, dim=-1)
        log_qt0 = torch.where(qt0 <= 1e-35, torch.full_like(qt0, NEG_INF),
                              torch.log(qt0 + 1e-35))
        if not shared:
            log_qt0 = log_qt0[:, None]
        # logsumexp over x0: (B, D, S, 1) + (B, 1, S, S) -> (B, D, S)
        return torch.logsumexp(log_p0t[..., None] + log_qt0, dim=-2)
    raise ValueError(f"unknown logit_type {logit_type}")


def logprob_with_logits(logit_type: str, process, xt: torch.Tensor, t: torch.Tensor,
                        logits: torch.Tensor, xt_target: Optional[torch.Tensor] = None,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ll_all, ll_xt); `process` supplies q_{t|0} at the times t (B,)."""
    if xt_target is None:
        xt_target = xt
    qt0 = None if logit_type == LOGIT_DIRECT else process.transition(t)
    log_prob = log_prob_from_logits(logit_type, logits, qt0)
    ll_xt = torch.gather(log_prob, -1, xt_target.long()[..., None])[..., 0]
    return log_prob, ll_xt
