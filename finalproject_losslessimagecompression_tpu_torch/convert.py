"""Weights and optimizer state carried across from the JAX package.

`params_from_flax(tree)`: a flax IDFlow parameter tree -> this package's
`state_dict`.

`vqvae_params_from_flax(tree)`: a flax VQVAE variable tree (params and,
with BatchNorm, batch_stats) -> the state_dict of `models.VQVAE`.

`params_from_flax(tree)` takes the JAX package's parameter tree as nested
dicts of numpy arrays (what `jax.device_get(params)` returns), with or
without its top-level "params" key.  The flax names are

    couples_{level}_{step}/dense/layer{i}/...   coupling DenseBlocks
    priors_{level}/net/layer{i}/...             prior DenseBlocks
    .../proj/{kernel, bias}                     zero-initialised projections
    cond_convs_{level}/{kernel, bias}           conditional flow's convs

and each DenseLayer holds its four leaves in either layout: fused
(`conv1_kernel`, `conv1_bias`, `conv3_kernel`, `conv3_bias`) or unfused
(`conv1/{kernel, bias}`, `conv3/{kernel, bias}`).  Kernels go from HWIO to
OIHW; values are copied unchanged.

`twolevel_params_from_flax(tree)`: a flax TwoLevelFlow parameter tree
(`rough` and `fine` IDFlow sub-trees; flax's `nn.remat` keeps the module's
name) -> the state_dict of `models.TwoLevelFlow`.

`opt_state_from_optax(opt_state, names, name, convert)`: an optax Adamax or
Adam state (`count`, and `mu` / `nu` trees shaped like the params) -> the
state_dict of this package's `train.optim.Optimizer`, so that a JAX run
resumes in the port on the same trajectory.  `convert` is the converter of
the model's parameter tree (`params_from_flax` by default,
`vqvae_params_from_flax` or `twolevel_params_from_flax`).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

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
        elif name.startswith("cond_convs_"):
            _conv(node, f"cond_convs.{idx[-1]}.", out)
        else:
            raise KeyError(f"unexpected IDFlow entry {name!r}")
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def twolevel_params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """The state_dict of `models.TwoLevelFlow`: `params_from_flax` of the
    `rough` and the `fine` sub-trees."""
    tree = tree.get("params", tree)
    return {f"{name}.{k}": v for name in ("rough", "fine")
            for k, v in params_from_flax(tree[name]).items()}


def _conv(node, prefix: str, out, transpose: bool = False) -> None:
    """A flax Conv (HWIO kernel -> OIHW) or ConvTranspose: flax correlates
    the dilated input with its [h, w, in, out] kernel as it is, torch's
    conv_transpose2d with the kernel flipped in h and w and laid out
    [in, out, h, w]."""
    k = np.asarray(node["kernel"], np.float32)
    out[prefix + "weight"] = (k[::-1, ::-1].transpose(2, 3, 0, 1)
                              if transpose else k.transpose(3, 2, 0, 1))
    out[prefix + "bias"] = np.asarray(node["bias"], np.float32)


# flax's automatic module names in the VQ-VAE -> the port's module lists
_VQ_MODULES = {"Conv": "convs", "ConvTranspose": "deconvs",
               "ResBlock": "blocks", "BatchNorm": "bns"}


def _batch_norm(params, stats, prefix: str, out) -> None:
    out[prefix + "weight"] = np.asarray(params["scale"], np.float32)
    out[prefix + "bias"] = np.asarray(params["bias"], np.float32)
    out[prefix + "running_mean"] = np.asarray(stats["mean"], np.float32)
    out[prefix + "running_var"] = np.asarray(stats["var"], np.float32)


def vqvae_params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """The state_dict of `models.VQVAE` from a flax VQVAE's variables
    (`{"params": ..., "batch_stats": ...}`, or the params alone when the
    model has no BatchNorm).  The flax names are

        encoder/Conv_i, encoder/BatchNorm_i, encoder/ResBlock_i/{conv_a,
        conv_b, bn_a, bn_b}, decoder/Conv_i, decoder/ConvTranspose_i,
        decoder/BatchNorm_i, decoder/ResBlock_i/..., vq/codebook."""
    params = tree.get("params", tree)
    stats = tree.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}
    for part in ("encoder", "decoder"):
        for name, node in params[part].items():
            kind, i = name.rsplit("_", 1)
            prefix = f"{part}.{_VQ_MODULES[kind]}.{int(i)}."
            st = stats.get(part, {}).get(name, {})
            if kind == "BatchNorm":
                _batch_norm(node, st, prefix, out)
            elif kind == "ResBlock":
                for sub, leaf in node.items():
                    if sub.startswith("conv"):
                        _conv(leaf, f"{prefix}{sub}.", out)
                    else:
                        _batch_norm(leaf, st[sub], f"{prefix}{sub}.", out)
            else:
                _conv(node, prefix, out, transpose=kind == "ConvTranspose")
    out["vq.codebook"] = np.asarray(params["vq"]["codebook"], np.float32)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


# the torch optimizer's name for optax's second moment
_SECOND_MOMENT = {"Adamax": "exp_inf", "Adam": "exp_avg_sq"}


def _adam_state(node):
    """The ScaleByAdamState (count, mu, nu) inside an optax state: the
    NamedTuples of a live state, or the nested dicts (keyed "0", "1", ...)
    that a msgpack checkpoint restores them as."""
    if isinstance(node, dict):
        if "mu" in node and "nu" in node:
            return node
        node = list(node.values())
    elif hasattr(node, "mu") and hasattr(node, "nu"):
        return node
    if isinstance(node, (tuple, list)):
        for sub in node:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def _field(state, name: str):
    return state[name] if isinstance(state, dict) else getattr(state, name)


def opt_state_from_optax(opt_state, names: Iterable, name: str = "Adamax",
                         convert: Callable = params_from_flax):
    """The port optimizer's state_dict from an optax Adamax/Adam state.

    `opt_state` is the JAX trainer's optimizer state with numpy leaves (what
    `jax.device_get` returns, or the nested dicts `train.msgpack` reads
    from a checkpoint; a chain with `clip_by_global_norm` in front is
    fine); `names` are the port model's parameter names in the
    optimizer's order (`[n for n, _ in model.named_parameters()]`, or the
    pairs themselves); `name` is the optimizer's config name; `convert`
    maps a moment tree as it maps the parameter tree.  Moments of entries
    that are not parameters in the port (the VQ-VAE's BatchNorm running
    averages, which flax keeps beside its params) are dropped."""
    st = _adam_state(opt_state)
    if st is None or name not in _SECOND_MOMENT:
        raise ValueError(f"no {name} moments in this optax state")
    mu, nu = convert(_field(st, "mu")), convert(_field(st, "nu"))
    names = [n if isinstance(n, str) else n[0] for n in names]
    missing = set(names) - set(mu)
    extra = {k for k in set(mu) - set(names) if not k.endswith(
        ("running_mean", "running_var"))}
    if missing or extra:
        raise KeyError("optax moments do not match the parameter names: "
                       f"{sorted(missing | extra)}")
    count = int(np.asarray(_field(st, "count")))
    state = {
        i: {"step": torch.tensor(float(count)), "exp_avg": mu[n],
            _SECOND_MOMENT[name]: nu[n]}
        for i, n in enumerate(names)
    }
    return {"count": count, "state": state}
