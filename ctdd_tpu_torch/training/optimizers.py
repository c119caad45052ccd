"""Optimizers: global-norm clip -> Adam (or AdamW) -> learning-rate schedule.

Counterpart of ctdd_tpu/training/optimizers.py, which builds an optax chain
(clip_by_global_norm, adam/adamw with the schedule). Here the same
arithmetic runs on dicts of tensors through `torch._foreach_*` ops, with the
state (count, mu, nu) laid out as optax's `ScaleByAdamState`, so a JAX
state converts one to one (`convert.train_state_from_flax`). Not
`torch.optim.Adam`: the schedule is read at optax's count, the clip adds no
epsilon to the norm, and the caller skips a non-finite step before any
state is touched.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ctdd_tpu_torch import registry

# optax.adam's defaults
B1, B2, EPS = 0.9, 0.999, 1e-8


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule(init, end, steps)."""
    return lambda c: (init - end) * (1.0 - min(max(c, 0), steps) / steps) + end


def _cosine(init: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(init, decay_steps, alpha)."""
    def schedule(c):
        cos = 0.5 * (1.0 + math.cos(math.pi * min(c, decay_steps) / decay_steps))
        return init * ((1.0 - alpha) * cos + alpha)

    return schedule


def _schedule(cfg) -> Callable[[int], float]:
    """lr as a function of optax's count: a linear warmup composed with
    "constant" (default), "cosine" or "linear" decay to
    `optimizer.end_lr_factor`·lr over training.n_iters - warmup steps (at
    least 1, as the JAX package has it)."""
    lr = cfg.optimizer.lr
    warmup = int(cfg.training.get("warmup", 0) or 0)
    kind = cfg.optimizer.get("schedule", "constant")
    n_iters = int(cfg.training.get("n_iters", 0) or 0)
    end = lr * float(cfg.optimizer.get("end_lr_factor", 0.1))
    decay_steps = max(n_iters - warmup, 1)
    if kind == "constant":
        body = lambda c: lr  # noqa: E731
    elif kind == "cosine":
        body = _cosine(lr, decay_steps, end / lr)
    elif kind == "linear":
        body = _linear(lr, end, decay_steps)
    else:
        raise ValueError(f"unknown optimizer.schedule {kind!r}")
    if warmup > 0:
        ramp = _linear(0.0, lr, warmup)
        if kind == "constant":
            return ramp
        # optax.join_schedules([ramp, body], [warmup])
        return lambda c: ramp(c) if c < warmup else body(c - warmup)
    return body


@dataclasses.dataclass
class AdamState:
    """optax's ScaleByAdamState: updates applied so far, first and second
    moments by parameter name."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class Adam:
    """clip_by_global_norm (optional) -> scale_by_adam -> + weight_decay·p
    (AdamW) -> scale by -lr(count), with optax's defaults (B1, B2, EPS added
    to sqrt(nu_hat)) and bias correction at count + 1."""

    def __init__(self, lr_fn: Callable[[int], float], clip_norm: Optional[float] = None,
                 weight_decay: float = 0.0):
        self.lr_fn = lr_fn
        self.clip_norm = clip_norm
        self.weight_decay = weight_decay

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        zeros = lambda: {k: torch.zeros_like(v, memory_format=torch.contiguous_format)  # noqa: E731
                         for k, v in params.items()}
        return AdamState(count=0, mu=zeros(), nu=zeros())

    def _clip(self, grads):
        """optax.clip_by_global_norm: g unchanged below max_norm, else
        (g / norm) · max_norm, with no epsilon; decided on the device."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        below = norm < self.clip_norm
        grads = torch._foreach_div(grads, torch.where(below, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(below, 1.0, self.clip_norm))
        return grads

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: AdamState) -> AdamState:
        """One step on `params`, `state.mu` and `state.nu` in place; returns
        the state with the count advanced."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        if self.clip_norm is not None:
            g = self._clip(g)
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, g, alpha=1.0 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - B2)
        count = min(state.count + 1, np.iinfo(np.int32).max)  # optax's safe_increment
        # 1 - b**count in float32, as optax computes it
        bc1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(count))
        upd = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            torch._foreach_add_(upd, p, alpha=self.weight_decay)
        # the schedule is read at the count before this update
        torch._foreach_mul_(upd, float(np.float32(-self.lr_fn(state.count))))
        torch._foreach_add_(p, upd)
        return AdamState(count=count, mu=state.mu, nu=state.nu)


def _clip_norm(cfg) -> Optional[float]:
    return float(cfg.training.grad_norm) if cfg.training.get("clip_grad", False) else None


@registry.optimizers.register(name="Adam")
def adam(cfg) -> Adam:
    return Adam(_schedule(cfg), clip_norm=_clip_norm(cfg))


@registry.optimizers.register(name="AdamW")
def adamw(cfg) -> Adam:
    return Adam(_schedule(cfg), clip_norm=_clip_norm(cfg),
                weight_decay=float(cfg.optimizer.get("weight_decay", 1e-4)))


def get_optimizer(cfg) -> Adam:
    return registry.optimizers.get(cfg.optimizer.name)(cfg)
