"""The benchmark's one door into the program (`ctdd_tpu_torch`): its config
object and its model, built on the card with the benchmark's weights."""

from __future__ import annotations

import copy

import torch

from h100bench import common


def config(cfg: dict, overrides: dict = None):
    """The program's Config of `cfg`, with dotted `overrides` applied."""
    from ctdd_tpu_torch.config.base import Config

    d = copy.deepcopy(cfg)
    for key, value in (overrides or {}).items():
        group, name = key.split(".")
        d[group][name] = value
    return Config(d)


def model(pcfg, weights, device):
    """The registered model of `pcfg` on `device`, built there (so no weight
    is drawn on the host) and loaded with the benchmark's `weights`."""
    from ctdd_tpu_torch.models.base import create_model

    with torch.device(device):
        m = create_model(pcfg, device=device)
    common.load_weights(m.net, weights)
    return m
