"""Carry flax UNet weights across into the port's `UNetWrapper` state dict.

Flax numbers submodules by creation order within each parent (`Conv_0` is
the UNet's input conv, `Conv_1` its output head; `ResBlock_i` follow the
order of `UNet.__call__`). The port keeps its submodules in lists in that
same order (see networks/unet.py), so each flax path maps to one port name:

- conv kernel HWIO -> Conv2d weight OIHW: permute(3, 2, 0, 1)
- Dense kernel (in, out) -> Linear weight (out, in)
- the ResBlock's 1x1 skip Dense -> a 1x1 Conv2d weight (out, in, 1, 1)
- GroupNorm scale -> weight
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

# per parent kind: flax child name -> (port child name, layer kind)
_CHILDREN = {
    "UNet": {
        "Dense_0": ("dense_0", "dense"), "Dense_1": ("dense_1", "dense"),
        "Conv_0": ("conv_0", "conv"), "Conv_1": ("conv_1", "conv"),
        "GroupNorm_0": ("norm_out", "norm"),
    },
    "ResBlock": {
        "GroupNorm_0": ("norm_0", "norm"), "Conv_0": ("conv_0", "conv"),
        "Dense_0": ("dense_0", "dense"), "GroupNorm_1": ("norm_1", "norm"),
        "Conv_1": ("conv_1", "conv"), "Dense_1": ("skip", "dense_1x1"),
    },
    "SelfAttention": {
        "GroupNorm_0": ("norm", "norm"), "Dense_0": ("qkv", "dense"),
        "Dense_1": ("proj", "dense"),
    },
    "Downsample": {"Conv_0": ("conv", "conv")},
    "Upsample": {"Conv_0": ("conv", "conv")},
}
_LISTS = {
    "ResBlock": "res_blocks", "SelfAttention": "attns",
    "Downsample": "downs", "Upsample": "ups",
}


def _leaf(kind: str, leaf: str, a: np.ndarray):
    if kind == "norm":
        return {"scale": "weight", "bias": "bias"}[leaf], a
    if leaf == "bias":
        return "bias", a
    if leaf != "kernel":
        raise KeyError(leaf)
    if kind == "conv":
        return "weight", a.transpose(3, 2, 0, 1)
    if kind == "dense":
        return "weight", a.T
    if kind == "dense_1x1":
        return "weight", a.T[:, :, None, None]
    raise KeyError(kind)


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _port_name(path: tuple) -> str:
    if path[0] != "UNet_0":
        raise KeyError(f"unexpected flax leaf {'/'.join(path)}")
    rest = path[1:]
    m = re.fullmatch(r"(ResBlock|SelfAttention|Downsample|Upsample)_(\d+)", rest[0])
    if m:
        kind, idx = m.group(1), m.group(2)
        parent = f"unet.{_LISTS[kind]}.{idx}"
        rest = rest[1:]
    else:
        kind, parent = "UNet", "unet"
    if len(rest) != 2 or rest[0] not in _CHILDREN[kind]:
        raise KeyError(f"unexpected flax leaf {'/'.join(path)}")
    child, layer = _CHILDREN[kind][rest[0]]
    return f"{parent}.{child}", layer, rest[1]


def unet_params_from_flax(tree: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """flax `UNetWrapper` params (nested dict of arrays) -> the port's
    `UNetWrapper(cfg)` state dict. Raises on a leaf that is missing, left
    over or of the wrong shape."""
    from ctdd_tpu_torch.networks.unet import UNetWrapper

    want = {k: v.shape for k, v in UNetWrapper(cfg).state_dict().items()}
    sd = {}
    for path, a in _flatten(tree).items():
        module, layer, leaf = _port_name(path)
        name, value = _leaf(layer, leaf, a)
        key = f"{module}.{name}"
        if key not in want:
            raise KeyError(f"flax leaf {'/'.join(path)} -> {key}: no such parameter")
        if tuple(value.shape) != tuple(want[key]):
            raise ValueError(
                f"flax leaf {'/'.join(path)} -> {key}: shape {value.shape}, "
                f"expected {tuple(want[key])}"
            )
        sd[key] = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f"no flax leaf for port parameters {missing}")
    return sd
