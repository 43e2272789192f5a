"""Build the package's native sources at first use, and what the kernel
wrappers (codec/cuda_rans.py, ops/dense_conv.py) share around a launch.

Each library is compiled once per hash of its source and flags into the
package's `build/` directory (git-ignored), written under a temporary name
and renamed into place, so a half-written library is never loaded.  A
failed build or launch raises."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")


def build_native(src: str, compiler: str, flags: Sequence[str],
                 stem: str) -> str:
    """Compile `src` with `compiler flags -o <lib> src` unless a library of
    the same source and flags is already built; return the library's path.
    Raises RuntimeError with the compiler's output if the build fails."""
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(flags).encode())
    so = os.path.join(BUILD_DIR, f"{stem}-{key.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([compiler, *flags, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{os.path.basename(compiler)} failed to build {src}:\n"
            f"{proc.stderr}")
    os.replace(tmp, so)
    return so


def find_nvcc() -> str:
    """The nvcc that builds the CUDA sources; raises RuntimeError if none."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def check_launch(err: int, what: str) -> None:
    """Raise if a library's launch function returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def stream() -> int:
    """The current CUDA stream's handle, where a launch is queued."""
    return torch.cuda.current_stream().cuda_stream
