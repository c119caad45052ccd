"""Checkpoints: one `.pt` file holding {params, ema_params, step, config}.

Counterpart of the checkpoint part of ctdd_tpu/utils/bookkeeping.py, which
keeps an orbax directory of the whole TrainState. The port stores the two
weight sets as state dicts, the step, and the config as plain data.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import torch


def save_checkpoint(path: str, params: Mapping[str, torch.Tensor],
                    ema_params: Mapping[str, torch.Tensor], step: int,
                    config) -> str:
    """Write the checkpoint atomically (a temporary file, then a rename)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "params": {k: v.detach().cpu() for k, v in params.items()},
        "ema_params": {k: v.detach().cpu() for k, v in ema_params.items()},
        "step": int(step),
        "config": config.to_dict() if hasattr(config, "to_dict") else dict(config),
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, map_location="cpu") -> dict[str, Any]:
    """The checkpoint's dict; tensors land on `map_location`."""
    ckpt = torch.load(path, map_location=map_location, weights_only=True)
    missing = {"params", "ema_params", "step", "config"} - set(ckpt)
    if missing:
        raise KeyError(f"{path} is not a port checkpoint: missing {sorted(missing)}")
    return ckpt
