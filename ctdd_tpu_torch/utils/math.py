"""Numerics helpers of the losses and samplers.

Counterpart of ctdd_tpu/utils/math.py. Random draws take an explicit
`torch.Generator` where JAX takes a key: a categorical draw is a Gumbel-max,
argmax(logits + g) with g = -log(-log(u)).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# the reference's -1e9 "log of zero" sentinel (losses.py:55 et al.)
NEG_INF = -1e9


def log1mexp(x: torch.Tensor) -> torch.Tensor:
    """log(1 - exp(-|x|)), elementwise, split at log(2) for stability."""
    x = -x.abs()
    return torch.where(x > -math.log(2.0), torch.log(-torch.expm1(x)),
                       torch.log1p(-torch.exp(x)))


def log_minus_exp(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """log(exp(a) - exp(b)) for b < a."""
    return a + torch.log1p(-torch.exp(b - a) + eps)


def safe_log(p: torch.Tensor, neg: float = NEG_INF) -> torch.Tensor:
    """log(p) with p <= 0 mapped to `neg`."""
    bad = p <= 0.0
    return torch.where(bad, torch.full_like(p, neg),
                       torch.log(torch.where(bad, torch.ones_like(p), p)))


def gumbel_noise(generator, shape, device) -> torch.Tensor:
    """Standard Gumbel draws -log(-log(u)), finite for every u in [0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def categorical(generator, logits: torch.Tensor) -> torch.Tensor:
    """Indices drawn from Cat(softmax(logits)) along the last axis, int32."""
    g = gumbel_noise(generator, logits.shape, logits.device)
    return torch.argmax(logits + g, dim=-1).to(torch.int32)


def mean_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over every batch and dim position; logits (..., S)."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None]).mean()
