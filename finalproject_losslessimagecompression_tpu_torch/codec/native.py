"""Build the package's native sources at first use.

Each library is compiled once per hash of its source and flags into the
package's `build/` directory (git-ignored), written under a temporary name
and renamed into place, so a half-written library is never loaded.  A
failed build raises."""

from __future__ import annotations

import hashlib
import os
import subprocess
from typing import Sequence

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
