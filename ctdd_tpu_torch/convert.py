"""Carry flax weights across into the port's state dicts: the UNet
(`unet_params_from_flax`), the residual MLP (`mlp_params_from_flax`), the
hollow family and the EBM score functions (`hollow_params_from_flax`), the
DDSM score networks (`ddsm_params_from_flax`), the sequence transformer
(`sequence_transformer_params_from_flax`), the FID
feature nets (`inception_params_from_flax`, `lenet_params_from_flax`,
`classifier_params_from_flax`); and a whole JAX train state of the UNet
(`train_state_from_flax`).

Flax numbers submodules by creation order within each parent (`Conv_0` is
the UNet's input conv, `Conv_1` its output head; `ResBlock_i` follow the
order of `UNet.__call__`). The port keeps its submodules in lists in that
same order (see networks/unet.py), so each flax path maps to one port name:

- conv kernel HWIO -> Conv2d weight OIHW: permute(3, 2, 0, 1)
- Dense kernel (in, out) -> Linear weight (out, in)
- the ResBlock's 1x1 skip Dense -> a 1x1 Conv2d weight (out, in, 1, 1)
- GroupNorm / LayerNorm scale -> weight

The residual MLP's Dense layers are numbered in the order of
`ResidualMLP.__call__`: Dense_0 the input layer, then per layer i
Dense_{3i+1} (FF in), Dense_{3i+2} (FF out), Dense_{3i+3} (FiLM), and last
the output layer.

The hollow family's modules carry flax's own names, so a flax path is a
port module path; flax's MultiHeadDotProductAttention stores query, key and
value kernels as (E, H, Dh) and the output kernel as (H, Dh, E), each
flattened to a Linear weight. So do the DDSM networks' modules; their 1D
conv kernels (K, in, out) become Conv1d weights (out, in, K), and the
Fourier projection's `W` is carried as it is.
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
    if kind == "embed":
        return {"embedding": "weight"}[leaf], a
    if kind == "param":
        return leaf, a
    if kind == "bn":
        return {"scale": "weight", "bias": "bias", "mean": "running_mean",
                "var": "running_var"}[leaf], a
    if leaf == "bias":
        return "bias", a.reshape(-1)
    if leaf != "kernel":
        raise KeyError(leaf)
    if kind == "conv":
        return "weight", a.transpose(3, 2, 0, 1)
    if kind == "dense":
        return "weight", a.T
    if kind == "dense_qkv":  # (E, H, Dh) -> (H * Dh, E)
        return "weight", a.reshape(a.shape[0], -1).T
    if kind == "dense_out":  # (H, Dh, E) -> (E, H * Dh)
        return "weight", a.reshape(-1, a.shape[-1]).T
    if kind == "conv1d":
        return "weight", a.transpose(2, 1, 0)
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


def _state_dict_from_flax(tree: Mapping, net, port_name) -> Dict[str, torch.Tensor]:
    """Map every flax leaf through `port_name(path) -> (module, layer kind,
    leaf)` onto `net`'s state dict. Raises on a leaf that is missing, left
    over or of the wrong shape; BatchNorm's step counters keep the net's
    values."""
    want = {k: v.shape for k, v in net.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    sd = {}
    for path, a in _flatten(tree).items():
        module, layer, leaf = port_name(path)
        name, value = _leaf(layer, leaf, a)
        key = f"{module}.{name}"
        if key not in want:
            raise KeyError(f"flax leaf {'/'.join(path)} -> {key}: no such parameter")
        if tuple(value.shape) != tuple(want[key]):
            raise ValueError(
                f"flax leaf {'/'.join(path)} -> {key}: shape {value.shape}, "
                f"expected {tuple(want[key])}"
            )
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f"no flax leaf for port parameters {missing}")
    return sd


def unet_params_from_flax(tree: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """flax `UNetWrapper` params (nested dict of arrays) -> the port's
    `UNetWrapper(cfg)` state dict. Raises on a leaf that is missing, left
    over or of the wrong shape."""
    from ctdd_tpu_torch.networks.unet import UNetWrapper

    return _state_dict_from_flax(tree, UNetWrapper(cfg), _port_name)


def mlp_params_from_flax(tree: Mapping, net) -> Dict[str, torch.Tensor]:
    """flax `ResidualMLP` params (nested dict of arrays) -> the state dict of
    the port's `ResidualMLP` `net`. Raises on a leaf that is missing, left
    over or of the wrong shape."""
    num_layers = len(net.norms)

    def port_name(path: tuple):
        bad = KeyError(f"unexpected flax leaf {'/'.join(path)}")
        if len(path) == 3 and path[0] == "TimeEmbedMLP_0":
            if path[1] not in ("Dense_0", "Dense_1"):
                raise bad
            return f"temb.{path[1].lower()}", "dense", path[2]
        if len(path) != 2:
            raise bad
        m = re.fullmatch(r"(Dense|LayerNorm)_(\d+)", path[0])
        if not m:
            raise bad
        kind, idx = m.group(1), int(m.group(2))
        if kind == "LayerNorm":
            if idx >= num_layers:
                raise bad
            return f"norms.{idx}", "norm", path[1]
        if idx == 0:
            return "dense_in", "dense", path[1]
        if idx == 3 * num_layers + 1:
            return "dense_out", "dense", path[1]
        if idx > 3 * num_layers + 1:
            raise bad
        layer, part = divmod(idx - 1, 3)
        return f"{('ff_in', 'ff_out', 'films')[part]}.{layer}", "dense", path[1]

    return _state_dict_from_flax(tree, net, port_name)


def hollow_params_from_flax(tree: Mapping, net) -> Dict[str, torch.Tensor]:
    """flax params of a hollow-family wrapper (`HollowTransformerWrapper`,
    `HollowLogisticsWrapper`, `EnumerativeTransformerWrapper`,
    `BertEnumTransformerWrapper`, `PrefixConditionalBidirTransformer`) or an
    EBM score function (`networks/ebm.py`) -> the state dict of the port's
    `net` of the same config. Raises on a leaf that is missing, left over or of the
    wrong shape."""
    import torch.nn as nn

    def port_name(path: tuple):
        module = ".".join(path[:-1])
        try:
            mod = net.get_submodule(module)
        except AttributeError:
            raise KeyError(f"unexpected flax leaf {'/'.join(path)}") from None
        if isinstance(mod, nn.Linear):
            kind = "dense"
            if len(path) >= 3 and "MultiHeadDotProductAttention" in path[-3]:
                kind = "dense_out" if path[-2] == "out" else "dense_qkv"
        elif isinstance(mod, nn.LayerNorm):
            kind = "norm"
        elif isinstance(mod, nn.Embedding):
            kind = "embed"
        else:
            raise KeyError(f"unexpected flax leaf {'/'.join(path)}")
        return module, kind, path[-1]

    return _state_dict_from_flax(tree, net, port_name)


def sequence_transformer_params_from_flax(tree: Mapping, net) -> Dict[str, torch.Tensor]:
    """flax `SequenceTransformer` params -> the state dict of the port's
    `net` of the same config: the hollow family's mapping, with the
    time-embedding MLP's `Dense_i` as the shared `TimeEmbedMLP`'s
    `dense_i`."""

    def renamed(tree):
        return {k: ({c.lower(): w for c, w in v.items()} if k == "TimeEmbedMLP_0" else v)
                for k, v in tree.items()}

    return hollow_params_from_flax(renamed(tree), net)


def ddsm_params_from_flax(tree: Mapping, net) -> Dict[str, torch.Tensor]:
    """flax params of `SudokuScoreNetWrapper` or `ProteinScoreNetWrapper` ->
    the state dict of the port's `net` of the same config. Raises on a leaf
    that is missing, left over or of the wrong shape."""
    import torch.nn as nn

    from ctdd_tpu_torch.networks.ddsm import GaussianFourierProjection

    kinds = ((nn.Linear, "dense"), (nn.Conv1d, "conv1d"), (nn.LayerNorm, "norm"),
             (nn.GroupNorm, "norm"), (GaussianFourierProjection, "param"))

    def port_name(path: tuple):
        module = ".".join(path[:-1])
        try:
            mod = net.get_submodule(module)
        except AttributeError:
            raise KeyError(f"unexpected flax leaf {'/'.join(path)}") from None
        for cls, kind in kinds:
            if isinstance(mod, cls):
                return module, kind, path[-1]
        raise KeyError(f"unexpected flax leaf {'/'.join(path)}")

    return _state_dict_from_flax(tree, net, port_name)


def inception_params_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax `InceptionV3Features` variables ({"params": ..., "batch_stats":
    ...}) -> the state dict of the port's `InceptionV3Features` (BatchNorm's
    `num_batches_tracked` left out). Raises on a leaf that is missing, left
    over or of the wrong shape."""
    from ctdd_tpu_torch.metrics.inception import InceptionV3Features

    def port_name(path: tuple):
        if path[0] not in ("params", "batch_stats") or len(path) < 4 \
                or path[-2] not in ("conv", "bn"):
            raise KeyError(f"unexpected flax leaf {'/'.join(path)}")
        return ".".join(path[1:-1]), path[-2], path[-1]

    return _state_dict_from_flax(variables, InceptionV3Features(), port_name)


def _lenet_params(tree: Mapping, net) -> Dict[str, torch.Tensor]:
    kinds = {"Conv_0": "conv", "Conv_1": "conv", "Conv_2": "conv", "Dense_0": "dense",
             "Dense_1": "dense"}

    def port_name(path: tuple):
        if len(path) != 2 or path[0] not in kinds:
            raise KeyError(f"unexpected flax leaf {'/'.join(path)}")
        return path[0].lower(), kinds[path[0]], path[1]

    return _state_dict_from_flax(tree, net, port_name)


def lenet_params_from_flax(tree: Mapping, feature_dim: int = 256) -> Dict[str, torch.Tensor]:
    """The JAX package's random-conv FID net (`_lenet_features`' params) ->
    the state dict of the port's `LeNetFeatures(feature_dim)`."""
    from ctdd_tpu_torch.metrics.fid import LeNetFeatures

    return _lenet_params(tree, LeNetFeatures(feature_dim))


def classifier_params_from_flax(tree: Mapping, feature_dim: int = 256,
                                n_classes: int = 10) -> Dict[str, torch.Tensor]:
    """The JAX package's classifier feature net (`trained_classifier_features`'
    params) -> the state dict of `LeNetFeatures(feature_dim, n_classes)`."""
    from ctdd_tpu_torch.metrics.fid import LeNetFeatures

    return _lenet_params(tree, LeNetFeatures(feature_dim, n_classes))


def _find_adam_state(opt_state):
    """optax's ScaleByAdamState inside a (nested) chain state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _find_adam_state(part)
            if found is not None:
                return found
    return None


def train_state_from_flax(state, cfg):
    """A JAX `TrainState` of the UNet (optax Adam/AdamW chain) -> the port's
    `TrainState`, on the CPU: params, EMA params and optax's mu/nu through
    the mapping of `unet_params_from_flax`; optax's count, `step` and
    `ema_num_updates` carried across."""
    from ctdd_tpu_torch.training.optimizers import AdamState
    from ctdd_tpu_torch.training.state import TrainState

    adam = _find_adam_state(state.opt_state)
    if adam is None:
        raise KeyError("no optax ScaleByAdamState (count, mu, nu) in opt_state")
    params = {k: v.requires_grad_(True)
              for k, v in unet_params_from_flax(state.params, cfg).items()}
    return TrainState(
        params=params,
        ema_params=unet_params_from_flax(state.ema_params, cfg),
        opt_state=AdamState(count=int(np.asarray(adam.count)),
                            mu=unet_params_from_flax(adam.mu, cfg),
                            nu=unet_params_from_flax(adam.nu, cfg)),
        step=int(np.asarray(state.step)),
        ema_num_updates=int(np.asarray(state.ema_num_updates)),
    )
