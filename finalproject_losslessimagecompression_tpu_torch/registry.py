"""Name -> constructor registries driving the YAML config system.

The port's own copy of the JAX package's `registry.py` (framework-free, but
the port imports nothing of that package), with the same registries.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    """A namespaced string -> callable registry."""

    def __init__(self, namespace: str):
        self.namespace = namespace
        self._record: Dict[str, Callable] = {}

    def register(self, obj: Callable = None, *, name: str = None):
        """`@register`, `@register(name=...)` or `register(obj)`: records
        obj under `name`, by default its `__name__`."""
        def _do(o):
            key = name or o.__name__
            if key in self._record and self._record[key] is not o:
                raise KeyError(
                    f"{self.namespace}: duplicate registration {key!r}")
            self._record[key] = o
            return o

        if obj is None:
            return _do
        return _do(obj)

    def get(self, name: str) -> Callable:
        try:
            return self._record[name]
        except KeyError:
            raise KeyError(
                f"{self.namespace}: unknown name {name!r}; "
                f"known: {sorted(self._record)}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._record

    def names(self):
        return sorted(self._record)


FLOWS = Registry("flows")
COUPLINGS = Registry("couplings")
PRIORS = Registry("priors")
DISTRIBUTIONS = Registry("distributions")
ROUNDS = Registry("rounds")
EXTENDDIMS = Registry("extenddims")
LAYERS = Registry("layers")
BLOCKS = Registry("blocks")
ENDECODERS = Registry("endecoders")
ACTIVATIONS = Registry("activations")
DATASETS = Registry("datasets")
DATALOADERS = Registry("dataloaders")
OPTIMIZERS = Registry("optimizers")
SCHEDULERS = Registry("schedulers")
TRAINERS = Registry("trainers")


def build(registry: Registry, config: dict, **extra) -> Any:
    """Instantiate from a config dict with a `name` key; the input dict is
    not mutated."""
    cfg = dict(config)
    name = cfg.pop("name")
    return registry.get(name)(**cfg, **extra)
