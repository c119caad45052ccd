"""Model composition: a network bound to its CTMC forward process (none for
the D3PM models, which sample in discrete time).

Counterpart of ctdd_tpu/models/base.py. Weights live in the network module;
`apply(params_or_module, x, t)` runs either that module or, given a state
dict, the network with those weights (`torch.func.functional_call`), so the
EMA weights of a checkpoint can be used without a second module.

Label-conditional sampling binds the labels into the handle
(`bound_label`, `cfg_scale`, `null_label`; `dataclasses.replace` makes the
bound copy), since samplers call `apply(params, x, t)` with no label. With
`cfg_scale` > 0 a forward is classifier-free guidance in logit space: the
conditional pass c and the pass with every label at `null_label` u give
u + s·(c − u).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Union

import torch
import torch.nn as nn

from ctdd_tpu_torch import registry
from ctdd_tpu_torch.ops.forward_process import ForwardProcess, build_process
from ctdd_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class DiffusionModel:
    """A score network bound to its CTMC forward process, or to none
    (`process=None`: the D3PM models)."""

    net: nn.Module
    process: Optional[ForwardProcess]
    cfg: Any
    has_label: bool = False
    bound_label: Optional[torch.Tensor] = None
    cfg_scale: float = 0.0
    null_label: int = 0  # the LabelEmbedder's dropped-label row (num_classes)

    @property
    def device(self) -> torch.device:
        """The process's device; without one (the D3PM models), where the
        network's weights are."""
        if self.process is not None:
            return self.process.device
        return next(self.net.parameters()).device

    def apply(
        self, params: Union[nn.Module, Mapping[str, torch.Tensor]],
        x: torch.Tensor, t: torch.Tensor, label: Optional[torch.Tensor] = None,
        train: bool = False, return_aux: bool = False, generator=None,
    ) -> torch.Tensor:
        """Network forward -> (B, D, S) logits; `train` turns dropout on,
        as the JAX package's `apply(train=True)` does. `return_aux` asks a
        network with an auxiliary head (the SequenceTransformer's key head)
        for (logits, aux); only losses pass it. A label-conditional network
        takes `label` (else the bound one) and `generator`, which draws
        its training label drop mask; other networks get neither."""
        if label is None and self.bound_label is not None:
            label = self.bound_label
        kwargs = {"return_aux": True} if return_aux else {}
        if self.has_label and label is not None:
            kwargs["generator"] = generator
            if self.cfg_scale > 0.0:
                cond = self._forward(params, x, t, train, dict(kwargs, label=label))
                null = torch.full_like(label, self.null_label)
                uncond = self._forward(params, x, t, train, dict(kwargs, label=null))
                return uncond + self.cfg_scale * (cond - uncond)
            kwargs["label"] = label
        return self._forward(params, x, t, train, kwargs)

    def _forward(self, params, x, t, train: bool, kwargs: dict):
        net = params if isinstance(params, nn.Module) else self.net
        if net.training != train:
            net.train(train)
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


def compose(cfg, net: nn.Module, device=None, has_label: bool = False) -> DiffusionModel:
    device = resolve_device(device)
    return DiffusionModel(
        net=net.to(device), process=build_process(cfg, device=device), cfg=cfg,
        has_label=has_label,
    )
