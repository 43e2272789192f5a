"""Name -> constructor registries driving the YAML config system.

The port's own copy of the JAX package's `registry.py` (framework-free, but
the port imports nothing of that package).  Only the registries the ported
slices fill are declared: distributions, datasets, data loaders,
optimizers, schedulers and trainers.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    """A namespaced string -> callable registry."""

    def __init__(self, namespace: str):
        self.namespace = namespace
        self._record: Dict[str, Callable] = {}

    def register(self, *, name: str):
        def _do(o):
            if name in self._record and self._record[name] is not o:
                raise KeyError(
                    f"{self.namespace}: duplicate registration {name!r}")
            self._record[name] = o
            return o

        return _do

    def get(self, name: str) -> Callable:
        try:
            return self._record[name]
        except KeyError:
            raise KeyError(
                f"{self.namespace}: unknown name {name!r}; "
                f"known: {sorted(self._record)}"
            ) from None


DISTRIBUTIONS = Registry("distributions")
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
