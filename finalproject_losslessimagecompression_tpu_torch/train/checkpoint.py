"""Checkpoints with real resume: the whole train state {params, opt_state,
step} as one `torch.save` file.

Saving writes a temporary file beside the target and `os.replace`s it, so a
crash mid-write never leaves a truncated checkpoint.  Loading uses
`weights_only=True` (tensors, numbers, strings and containers only) and maps
every tensor onto the model's device.  Permutations are derived from seeds,
so they are not stored.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict

import torch


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
    return torch.load(path, map_location=device, weights_only=True)
