"""Presets of the port; `get_preset(name)` resolves by the JAX preset name."""

from __future__ import annotations

import importlib

_PRESETS = {
    "tauUnet_mnist": "ctdd_tpu_torch.config.presets.mnist_tau_unet",
}


def preset_names():
    return sorted(_PRESETS)


def get_preset(name: str):
    if name not in _PRESETS:
        raise KeyError(f"no preset {name!r}; known: {preset_names()}")
    return importlib.import_module(_PRESETS[name]).get_config()
