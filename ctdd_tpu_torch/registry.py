"""String-keyed registries: configs carry names, registries resolve factories.

The port's own copy of ctdd_tpu/registry.py, with its own instances, so the
two packages' names never collide.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable


class Registry:
    """A named string->factory registry with decorator registration."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, obj: Any = None, *, name: str | None = None):
        def _do(o, n):
            key = n or getattr(o, "__name__", None)
            if key is None:
                raise ValueError(f"cannot infer registry name for {o!r}")
            if key in self._entries:
                raise ValueError(f"{key} already registered in {self.kind}")
            self._entries[key] = o
            return o

        if obj is None:
            return lambda o: _do(o, name)
        return _do(obj, name)

    def alias(self, name: str, target: str) -> None:
        self._entries[name] = self._entries[target]

    def get(self, name: str) -> Any:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"no {self.kind} named {name!r}; known: {sorted(self._entries)}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self) -> Iterable[str]:
        return sorted(self._entries)


models = Registry("model")
samplers = Registry("sampler")
processes = Registry("forward_process")
losses = Registry("loss")
optimizers = Registry("optimizer")
train_steps = Registry("train_step")
datasets = Registry("dataset")
loggers = Registry("logger")
