"""Checkpoints with real resume: the whole train state {params, opt_state,
step} as one `torch.save` file.

Saving writes a temporary file beside the target and `os.replace`s it, so a
crash mid-write never leaves a truncated checkpoint.  Loading uses
`weights_only=True` (tensors, numbers, strings and containers only) and maps
every tensor onto the model's device.  Permutations are derived from seeds,
so they are not stored.

The JAX package's msgpack checkpoints load too: the two formats are told
apart by the zip magic that every `torch.save` file starts with.  A JAX
file is read by `train.msgpack` (no flax needed); its `params` go through
the converter of the model being loaded (`convert.params_from_flax`,
`vqvae_params_from_flax` or `twolevel_params_from_flax`), and a trainer's
resume reads its optax state through `convert.opt_state_from_optax`.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..convert import opt_state_from_optax
from .msgpack import load_raw

# torch.save writes a zip archive
_ZIP_MAGIC = b"PK\x03\x04"


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(state, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def is_jax_checkpoint(path: str) -> bool:
    """True for a JAX package (msgpack) checkpoint, False for a
    `torch.save` file."""
    with open(path, "rb") as f:
        return f.read(len(_ZIP_MAGIC)) != _ZIP_MAGIC


def _to_device(node, device):
    """A JAX file's numpy arrays as tensors on `device` (copied: the reader's
    arrays are read-only views of the file's bytes)."""
    if isinstance(node, dict):
        return {k: _to_device(v, device) for k, v in node.items()}
    if isinstance(node, np.ndarray):
        return torch.from_numpy(np.array(node)).to(device)
    return node


def load_checkpoint(path: str, device,
                    convert: Optional[Callable] = None) -> Dict[str, Any]:
    """A checkpoint's entries, tensors on `device`.  A JAX file's `params`
    go through `convert` (the loaded model's converter, required for such
    a file); its other entries keep the JAX layout, arrays as tensors."""
    if not is_jax_checkpoint(path):
        return torch.load(path, map_location=device, weights_only=True)
    if convert is None:
        raise ValueError(
            f"{path} is a JAX package checkpoint: pass the converter of the "
            "model it holds (convert.params_from_flax, "
            "vqvae_params_from_flax or twolevel_params_from_flax)")
    raw = load_raw(path)
    if not isinstance(raw, dict) or "params" not in raw:
        raise ValueError(f"{path}: not a trainer checkpoint (no params)")
    out = {k: (v if k == "opt_state" else _to_device(v, device))
           for k, v in raw.items() if k != "params"}
    out["params"] = {k: v.to(device)
                     for k, v in convert(raw["params"]).items()}
    return out


def load_params(path: str, device,
                convert: Optional[Callable] = None) -> Dict[str, Any]:
    """The `params` of a checkpoint of either package, whatever else it
    holds: how a model reads the weights another trainer saved (the frozen
    VQ-VAE of the residual trainer, the CLI's and the fine-tuner's
    models).  `convert` is the model's converter, used for a JAX file."""
    raw = load_checkpoint(path, device, convert)
    if not isinstance(raw, dict) or "params" not in raw:
        raise ValueError(f"{path}: not a trainer checkpoint (no params)")
    return raw["params"]


def restore_train_state(path: str, model: torch.nn.Module, optimizer,
                        convert: Callable) -> Dict[str, Any]:
    """Load a trainer checkpoint of either package into `model` and its
    `train.optim.Optimizer` (built over `model.parameters()`), and return
    the checkpoint (its step and any other entries, on the model's
    device).  A JAX file's optax state goes through
    `opt_state_from_optax`, its moments through `convert` as the params."""
    device = next(model.parameters()).device
    st = load_checkpoint(path, device, convert)
    model.load_state_dict(st["params"])
    opt = st["opt_state"]
    if is_jax_checkpoint(path):
        opt = opt_state_from_optax(
            opt, [n for n, _ in model.named_parameters()],
            type(optimizer.inner).__name__, convert)
    optimizer.load_state_dict(opt)
    return st
