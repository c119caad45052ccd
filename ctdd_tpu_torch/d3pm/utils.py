"""D3PM numerics helpers.

Counterpart of ctdd_tpu/d3pm/utils.py.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def meanflat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all but the leading batch axis."""
    return x.reshape(x.shape[0], -1).mean(dim=-1)


def log_min_exp(a: torch.Tensor, b: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    """log(exp(a) - exp(b)) for b < a."""
    return a + torch.log1p(-torch.exp(b - a) + epsilon)


def categorical_kl_logits(logits1, logits2, eps: float = 1e-6):
    """KL(Cat(logits1) || Cat(logits2)) per element."""
    p1 = F.softmax(logits1 + eps, dim=-1)
    return (p1 * (F.log_softmax(logits1 + eps, dim=-1)
                  - F.log_softmax(logits2 + eps, dim=-1))).sum(dim=-1)


def categorical_kl_probs(probs1, probs2, eps: float = 1e-6):
    """KL between categorical probability tensors."""
    return (probs1 * (torch.log(probs1 + eps) - torch.log(probs2 + eps))).sum(dim=-1)


def categorical_log_likelihood(x, logits):
    """log p(x) under Cat(logits); x integer classes."""
    log_probs = F.log_softmax(logits, dim=-1)
    return torch.gather(log_probs, -1, x[..., None].long())[..., 0]


def normalize_data(x, mean=128.0, std=128.0):
    return (x - mean) / std
