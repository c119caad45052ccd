"""A small attribute-access config (the port's stand-in for ConfigDict).

Nested dicts become `Config`s; `to_dict()` gives plain data back, which is
what a checkpoint stores. `save_config` / `load_config` keep a run's config
as JSON beside its checkpoints.
"""

from __future__ import annotations

import json
import os
from typing import Any


class Config:
    """Mutable nested config with attribute and item access."""

    def __init__(self, d: dict | None = None, **kw):
        object.__setattr__(self, "_d", {})
        for k, v in {**(d or {}), **kw}.items():
            self[k] = v

    def __getattr__(self, name: str) -> Any:
        if name == "_d":  # a copy under construction (copy, pickle) has none yet
            raise AttributeError(name)
        try:
            return self._d[name]
        except KeyError:
            raise AttributeError(
                f"no config key {name!r}; known: {sorted(self._d)}"
            ) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __getitem__(self, name: str) -> Any:
        return self._d[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self._d[name] = Config(value) if isinstance(value, dict) else value

    def __contains__(self, name: str) -> bool:
        return name in self._d

    def get(self, name: str, default: Any = None) -> Any:
        return self._d.get(name, default)

    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, Config) else v
            for k, v in self._d.items()
        }

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"


def save_config(cfg: Config, path: str) -> str:
    """Write the config as JSON (the JAX package writes YAML)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(cfg.to_dict(), f, indent=1, sort_keys=True)
    return path


def load_config(path: str) -> Config:
    with open(path) as f:
        return Config(json.load(f))
