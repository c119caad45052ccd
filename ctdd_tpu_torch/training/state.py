"""Train state: params, EMA shadow params, optimizer state and counters.

Counterpart of ctdd_tpu/training/state.py. The tensors live in dicts keyed
by parameter name and are updated in place (the JAX package rebuilds its
pytree every step); the counters are Python ints.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from ctdd_tpu_torch.training.optimizers import AdamState


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    ema_params: Dict[str, torch.Tensor]
    opt_state: AdamState
    step: int = 0
    ema_num_updates: int = 0

    @torch.no_grad()
    def ema_update(self, new_params: Mapping[str, torch.Tensor], decay: float) -> int:
        """Shadow update s - (1 - d)(s - p) in place with the warmup ramp
        d = min(decay, (1 + n) / (10 + n)) in float32; returns the new n."""
        n = self.ema_num_updates + 1
        d = np.minimum(np.float32(decay), np.float32(1.0 + n) / np.float32(10.0 + n))
        ema = list(self.ema_params.values())
        diff = torch._foreach_sub(ema, [new_params[k] for k in self.ema_params])
        torch._foreach_mul_(diff, float(np.float32(1.0) - d))
        torch._foreach_sub_(ema, diff)
        return n


def create_train_state(params: Mapping[str, torch.Tensor], tx) -> TrainState:
    """State over `params` (a network's `named_parameters()` or a state dict):
    the params share storage with what is passed and require grad; the EMA
    starts as a copy."""
    params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    return TrainState(
        params=params,
        ema_params={k: v.detach().clone() for k, v in params.items()},
        opt_state=tx.init(params),
    )
