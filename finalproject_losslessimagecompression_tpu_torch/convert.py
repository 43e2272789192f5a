"""Weights and optimizer state carried across from the JAX package.

`params_from_flax(tree)`: a flax IDFlow parameter tree -> this package's
`state_dict`.

`params_from_flax(tree)` takes the JAX package's parameter tree as nested
dicts of numpy arrays (what `jax.device_get(params)` returns), with or
without its top-level "params" key.  The flax names are

    couples_{level}_{step}/dense/layer{i}/...   coupling DenseBlocks
    priors_{level}/net/layer{i}/...             prior DenseBlocks
    .../proj/{kernel, bias}                     zero-initialised projections

and each DenseLayer holds its four leaves in either layout: fused
(`conv1_kernel`, `conv1_bias`, `conv3_kernel`, `conv3_bias`) or unfused
(`conv1/{kernel, bias}`, `conv3/{kernel, bias}`).  Kernels go from HWIO to
OIHW; values are copied unchanged.

`opt_state_from_optax(opt_state, names, name)`: an optax Adamax or Adam
state (`count`, and `mu` / `nu` trees shaped like the params) -> the
state_dict of this package's `train.optim.Optimizer`, so that a JAX run
resumes in the port on the same trajectory.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch


def _oihw(kernel) -> np.ndarray:
    return np.asarray(kernel, np.float32).transpose(3, 2, 0, 1)


def _layer_leaves(node):
    """(w1, b1, w3, b3) of one DenseLayer in either flax layout."""
    if "conv1_kernel" in node:
        return (node["conv1_kernel"], node["conv1_bias"],
                node["conv3_kernel"], node["conv3_bias"])
    return (node["conv1"]["kernel"], node["conv1"]["bias"],
            node["conv3"]["kernel"], node["conv3"]["bias"])


def _block(node, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for name, sub in node.items():
        if name == "proj":
            out[prefix + "proj.weight"] = _oihw(sub["kernel"])
            out[prefix + "proj.bias"] = np.asarray(sub["bias"], np.float32)
        elif name.startswith("layer"):
            w1, b1, w3, b3 = _layer_leaves(sub)
            p = f"{prefix}layers.{int(name[5:])}."
            out[p + "conv1_kernel"] = _oihw(w1)
            out[p + "conv1_bias"] = np.asarray(b1, np.float32)
            out[p + "conv3_kernel"] = _oihw(w3)
            out[p + "conv3_bias"] = np.asarray(b3, np.float32)
        else:
            raise KeyError(f"unexpected DenseBlock entry {name!r}")


def params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """The state_dict of `models.IDFlow` for the same configuration."""
    tree = tree.get("params", tree)
    out: Dict[str, np.ndarray] = {}
    for name, node in tree.items():
        kind, *idx = name.split("_")
        if kind == "couples":
            level, step = idx
            _block(node["dense"], f"couples.{level}.{step}.dense.", out)
        elif kind == "priors":
            (level,) = idx
            _block(node["net"], f"priors.{level}.net.", out)
        else:
            raise KeyError(f"unexpected IDFlow entry {name!r}")
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


# the torch optimizer's name for optax's second moment
_SECOND_MOMENT = {"Adamax": "exp_inf", "Adam": "exp_avg_sq"}


def _adam_state(node):
    """The ScaleByAdamState (count, mu, nu) inside an optax state."""
    if hasattr(node, "mu") and hasattr(node, "nu"):
        return node
    if isinstance(node, (tuple, list)):
        for sub in node:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def opt_state_from_optax(opt_state, names: Iterable, name: str = "Adamax"):
    """The port optimizer's state_dict from an optax Adamax/Adam state.

    `opt_state` is the JAX trainer's optimizer state with numpy leaves (what
    `jax.device_get` returns; a chain with `clip_by_global_norm` in front
    is fine); `names` are the port model's parameter names in the
    optimizer's order (`[n for n, _ in model.named_parameters()]`, or the
    pairs themselves); `name` is the optimizer's config name."""
    st = _adam_state(opt_state)
    if st is None or name not in _SECOND_MOMENT:
        raise ValueError(f"no {name} moments in this optax state")
    mu, nu = params_from_flax(st.mu), params_from_flax(st.nu)
    names = [n if isinstance(n, str) else n[0] for n in names]
    if sorted(names) != sorted(mu):
        raise KeyError("optax moments do not match the parameter names: "
                       f"{sorted(set(names) ^ set(mu))}")
    count = int(np.asarray(st.count))
    state = {
        i: {"step": torch.tensor(float(count)), "exp_avg": mu[n],
            _SECOND_MOMENT[name]: nu[n]}
        for i, n in enumerate(names)
    }
    return {"count": count, "state": state}
