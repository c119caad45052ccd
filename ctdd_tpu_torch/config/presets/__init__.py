"""Presets of the port; `get_preset(name)` resolves by the JAX preset name.

`parse_overrides` / `apply_overrides` take the CLIs' `--set key=value`
pairs: values through `ast.literal_eval` (a plain string where that
fails), dotted keys into the nested config.
"""

from __future__ import annotations

import ast
import difflib
import importlib

from ctdd_tpu_torch.config.base import Config

_PRESETS = {
    "tauUnet_mnist": "ctdd_tpu_torch.config.presets.mnist_tau_unet",
    "tauUnet_mnist_ll": "ctdd_tpu_torch.config.presets.mnist_tau_unet_ll",
    "tauUnet_maze": "ctdd_tpu_torch.config.presets.maze_tau_unet",
    "mlp_synthetic": "ctdd_tpu_torch.config.presets.synthetic_mlp",
    "hollow_synthetic": "ctdd_tpu_torch.config.presets.synthetic_hollow",
    "hollow_synthetic_rmdirect": "ctdd_tpu_torch.config.presets.synthetic_hollow_rmdirect",
    "bert_synthetic": "ctdd_tpu_torch.config.presets.synthetic_bert",
    "masked_synthetic": "ctdd_tpu_torch.config.presets.synthetic_masked",
    "hollow_mnist": "ctdd_tpu_torch.config.presets.mnist_hollow",
    "holvisual_mnist": "ctdd_tpu_torch.config.presets.mnist_hollow_crm",
    "bert_mnist": "ctdd_tpu_torch.config.presets.mnist_bert",
    "hollow_maze": "ctdd_tpu_torch.config.presets.maze_hollow",
    "bert_maze": "ctdd_tpu_torch.config.presets.maze_bert",
    "bert_mazemasked": "ctdd_tpu_torch.config.presets.maze_bert_masked",
    "hollow_maze_distr": "ctdd_tpu_torch.config.presets.maze_hollow_distr",
    "protein_maze": "ctdd_tpu_torch.config.presets.maze_protein",
    "hollow_protein": "ctdd_tpu_torch.config.presets.protein_hollow",
    "sudoku": "ctdd_tpu_torch.config.presets.sudoku",
    "ebm_synthetic": "ctdd_tpu_torch.config.presets.synthetic_ebm",
    "pianoroll_cond": "ctdd_tpu_torch.config.presets.pianoroll_conditional",
}


def preset_names():
    return sorted(_PRESETS)


def get_preset(name: str):
    if name not in _PRESETS:
        raise KeyError(f"no preset {name!r}; known: {preset_names()}")
    return importlib.import_module(_PRESETS[name]).get_config()


def parse_overrides(pairs) -> dict:
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def apply_overrides(cfg: Config, overrides: dict) -> Config:
    """Set each dotted key. Every section on the way must exist, else a
    KeyError names the key and the nearest known ones; a new last key is
    added (options read with a default, such as `optimizer.schedule`), as
    ml_collections does for the JAX CLI."""
    for dotted, v in overrides.items():
        node = cfg
        parts = dotted.split(".")
        for i, p in enumerate(parts[:-1]):
            if not isinstance(node, Config) or p not in node:
                known = node.to_dict() if isinstance(node, Config) else {}
                near = difflib.get_close_matches(p, list(known), n=3)
                raise KeyError(
                    f"bad override {dotted!r}: no config section "
                    f"{'.'.join(parts[:i + 1])!r}; did you mean {near}? "
                    f"known: {sorted(known)}"
                )
            node = node[p]
        if not isinstance(node, Config):
            raise KeyError(f"bad override {dotted!r}: {'.'.join(parts[:-1])!r} "
                           "is a value, not a section")
        node[parts[-1]] = v
    return cfg
