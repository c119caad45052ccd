"""Model composition: a network bound to its CTMC forward process.

Counterpart of ctdd_tpu/models/base.py. Weights live in the network module;
`apply(params_or_module, x, t)` runs either that module or, given a state
dict, the network with those weights (`torch.func.functional_call`), so the
EMA weights of a checkpoint can be used without a second module.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Union

import torch
import torch.nn as nn

from ctdd_tpu_torch import registry
from ctdd_tpu_torch.ops.forward_process import ForwardProcess, build_process
from ctdd_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class DiffusionModel:
    """A score network bound to its CTMC forward process."""

    net: nn.Module
    process: ForwardProcess
    cfg: Any

    @property
    def device(self) -> torch.device:
        return self.process.device

    def apply(
        self, params: Union[nn.Module, Mapping[str, torch.Tensor]],
        x: torch.Tensor, t: torch.Tensor, train: bool = False,
        return_aux: bool = False,
    ) -> torch.Tensor:
        """Network forward -> (B, D, S) logits; `train` turns dropout on,
        as the JAX package's `apply(train=True)` does. `return_aux` asks a
        network with an auxiliary head (the SequenceTransformer's key head)
        for (logits, aux); only losses pass it."""
        net = params if isinstance(params, nn.Module) else self.net
        if net.training != train:
            net.train(train)
        kwargs = {"return_aux": True} if return_aux else {}
        if isinstance(params, nn.Module):
            return params(x, t, **kwargs)
        return torch.func.functional_call(self.net, dict(params), (x, t), kwargs)

    # -- forward process passthrough ----------------------------------------
    def rate(self, t):
        return self.process.rate(t)

    def rate_mat(self, y, t):
        return self.process.rate_mat(y, t)

    def transition(self, t):
        return self.process.transition(t)

    def transit_between(self, t1, t2):
        return self.process.transit_between(t1, t2)


def create_model(cfg, device=None) -> DiffusionModel:
    """Build the registered model named by cfg.model.name on `device`: the
    GPU unless the caller passes another (`device="cpu"`)."""
    return registry.models.get(cfg.model.name)(cfg, device=resolve_device(device))


def compose(cfg, net: nn.Module, device=None) -> DiffusionModel:
    device = resolve_device(device)
    return DiffusionModel(
        net=net.to(device), process=build_process(cfg, device=device), cfg=cfg
    )
