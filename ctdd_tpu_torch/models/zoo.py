"""The registered model zoo: network wrapper x forward process.

Counterpart of ctdd_tpu/models/zoo.py, for the entries built on the UNet
wrapper (`_unet_paul`); they differ only in the process. Registered names
match the JAX zoo so its configs resolve unchanged.
"""

from __future__ import annotations

from ctdd_tpu_torch import registry
from ctdd_tpu_torch.models.base import DiffusionModel, compose


def _unet_paul(cfg):
    from ctdd_tpu_torch.networks.unet import UNetWrapper

    return UNetWrapper(cfg)


_ZOO = {
    # name                                   (network, process)
    "UniformRateImageX0PredEMA":              (_unet_paul, "UniformRate"),
    "GaussianTargetRateImageX0PredEMAPaul":   (_unet_paul, "GaussianTargetRate"),
    "UniformRateUnetEMA":                     (_unet_paul, "UniformRate"),
    "UniVarUnetEMA":                          (_unet_paul, "UniformVariantRate"),
}


def _make_entry(name, make_net, process_name):
    def build(cfg, device="cpu") -> DiffusionModel:
        # the process name is bound into the config, as the JAX zoo does
        if "rate_name" not in cfg.model:
            cfg.model.rate_name = process_name
        return compose(cfg, make_net(cfg), device=device)

    build.__name__ = name
    return build


for _name, (_net, _proc) in _ZOO.items():
    registry.models.register(_make_entry(_name, _net, _proc), name=_name)
