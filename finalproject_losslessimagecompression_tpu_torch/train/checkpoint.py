"""Checkpoints with real resume: the whole train state {params, opt_state,
step} as one `torch.save` file.

Saving writes a temporary file beside the target and `os.replace`s it, so a
crash mid-write never leaves a truncated checkpoint.  Loading uses
`weights_only=True` (tensors, numbers, strings and containers only) and maps
every tensor onto the model's device.  Permutations are derived from seeds,
so they are not stored.  A file that is not a `torch.save` archive (the JAX
package's msgpack checkpoints among them) raises ValueError.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict

import torch

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


def load_checkpoint(path: str, device) -> Dict[str, Any]:
    with open(path, "rb") as f:
        head = f.read(len(_ZIP_MAGIC))
    if head != _ZIP_MAGIC:
        raise ValueError(
            f"{path}: not a checkpoint of this package (torch.save); the "
            "JAX package's msgpack checkpoints are not readable yet: ROADMAP "
            "queue 1, item 7 (msgpack checkpoint reader)")
    return torch.load(path, map_location=device, weights_only=True)


def load_params(path: str, device) -> Dict[str, Any]:
    """The `params` of a checkpoint, whatever else it holds: how a model
    reads the weights another trainer saved (the frozen VQ-VAE of the
    residual trainer, the CLI's models)."""
    raw = load_checkpoint(path, device)
    if not isinstance(raw, dict) or "params" not in raw:
        raise ValueError(f"{path}: not a trainer checkpoint (no params)")
    return raw["params"]
