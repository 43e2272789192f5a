"""A reader of flax's msgpack checkpoints in pure Python.

The JAX package saves checkpoints with `flax.serialization.to_bytes`: a
msgpack document of nested maps whose array leaves are msgpack ext types.
`msgpack_restore(blob)` returns what `flax.serialization.msgpack_restore`
returns for the same bytes -- nested dicts (and lists) of numpy arrays and
Python scalars -- without msgpack or flax, which a host serving the card
need not have.

The msgpack types read are nil, bools, positive and negative fixints, the
int and uint widths 8-64, float32/64, fixstr and str8-32, bin8-32,
fixarray and array16/32, fixmap and map16/32, fixext1-16 and ext8-32.
flax's ext codes:

    1  ndarray       payload msgpack [shape, dtype name, C-order bytes]
    2  complex       payload msgpack [real, imag]
    3  numpy scalar  payload as an ndarray, of shape ()

An array's bytes become an `np.frombuffer` view of the blob (read-only, as
flax's are), so a checkpoint of 10^8 bytes costs no per-element Python.
The dtype name `bfloat16` has no numpy dtype: such a leaf is read as uint16
and returned as a `torch.bfloat16` tensor with the same bits.  Arrays over
flax's `MAX_CHUNK_SIZE` are stored as `__msgpack_chunked_array__` dicts of
flat chunks and are joined back into one array, where flax joins them.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """One pass over a msgpack document held in `blob` (bytes or a
    memoryview).  With `raw`, str values come back as bytes, as flax reads
    an ndarray's header."""

    def __init__(self, blob, raw: bool = False):
        self.blob = blob
        self.view = memoryview(blob)
        self.pos = 0
        self.raw = raw

    def _take(self, n: int) -> int:
        """The offset of the next n bytes, which are consumed."""
        start = self.pos
        if start + n > len(self.view):
            raise ValueError("truncated msgpack document")
        self.pos = start + n
        return start

    def _unpack(self, fmt: str):
        return struct.unpack_from(fmt, self.view,
                                  self._take(struct.calcsize(fmt)))[0]

    def _bytes(self, n: int) -> bytes:
        start = self._take(n)
        return bytes(self.view[start:start + n])

    def _str(self, n: int):
        data = self._bytes(n)
        return data if self.raw else data.decode("utf-8")

    def _ext(self, n: int):
        code = self._unpack(">b")
        start = self._take(n)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray(self.blob, start, n)
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            real, imag = _Reader(self.view[start:start + n]).read()
            return complex(real, imag)
        raise ValueError(f"msgpack ext type {code} is not one flax writes")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _length(self, b: int, fixed: range, sized: dict) -> int:
        """The length of a str/bin/array header `b`: in its low bits for
        the fix types in `fixed`, else in the following bytes."""
        if b in fixed:
            return b - fixed.start
        if b in sized:
            return self._unpack(sized[b])
        raise ValueError(f"msgpack type byte 0x{b:02x} is not the one "
                         "expected here")

    def span(self):
        """(offset, length) of the next str or bin, consumed without a
        copy."""
        n = self._length(self.view[self._take(1)], range(0xA0, 0xC0),
                         _SPAN_SIZES)
        return self._take(n), n

    def array_header(self) -> int:
        return self._length(self.view[self._take(1)], range(0x90, 0xA0),
                            {0xDC: ">H", 0xDD: ">I"})

    def read(self) -> Any:
        b = self.view[self._take(1)]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self._map(b & 0x0F)
        if b <= 0x9F:
            return self._array(b & 0x0F)
        if b <= 0xBF:
            return self._str(b & 0x1F)
        if b in _FIXED:
            return _FIXED[b]
        if b in _NUMBERS:
            return self._unpack(_NUMBERS[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            return getattr(self, kind)(self._unpack(fmt))
        if b in _FIXEXT:
            return self._ext(_FIXEXT[b])
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")


_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {0xC4: ("_bytes", ">B"), 0xC5: ("_bytes", ">H"),
          0xC6: ("_bytes", ">I"), 0xC7: ("_ext", ">B"), 0xC8: ("_ext", ">H"),
          0xC9: ("_ext", ">I"), 0xD9: ("_str", ">B"), 0xDA: ("_str", ">H"),
          0xDB: ("_str", ">I"), 0xDC: ("_array", ">H"),
          0xDD: ("_array", ">I"), 0xDE: ("_map", ">H"), 0xDF: ("_map", ">I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
# str8-32 and bin8-32: the width of their length
_SPAN_SIZES = {b: _SIZED[b][1] for b in (0xC4, 0xC5, 0xC6, 0xD9, 0xDA, 0xDB)}


def _ndarray(blob, start: int, n: int):
    """flax's ndarray payload at blob[start:start + n] -- a msgpack array
    [shape, dtype name, C-order bytes] -- as a view of blob."""
    sub = _Reader(memoryview(blob)[start:start + n], raw=True)
    if sub.array_header() != 3:
        raise ValueError("malformed ndarray payload")
    shape, name = sub.read(), sub.read()
    offset, size = sub.span()
    if name == b"bfloat16":
        bits = np.frombuffer(blob, np.uint16, size // 2, start + offset)
        return torch.from_numpy(bits.reshape(shape).copy()).view(
            torch.bfloat16)
    dtype = np.dtype(name.decode())
    if size % dtype.itemsize:
        raise ValueError("malformed ndarray payload: partial element")
    return np.frombuffer(blob, dtype, size // dtype.itemsize,
                         start + offset).reshape(shape)


def _unchunk(d: dict) -> np.ndarray:
    shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):  # bfloat16
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    """flax's `_unchunk_array_leaves_in_place`: chunked arrays at the top
    or nested in dicts are joined (lists are not searched, as in flax)."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if _CHUNKED in v else _unchunk_leaves(v)
    return d


def msgpack_restore(blob: bytes) -> Any:
    """The tree `flax.serialization.msgpack_restore(blob)` returns."""
    reader = _Reader(blob)
    tree = reader.read()
    if reader.pos != len(reader.view):
        raise ValueError("trailing bytes after the msgpack document")
    return _unchunk_leaves(tree)


def load_raw(path: str) -> Any:
    """The raw tree of a JAX package checkpoint file (nested dicts of numpy
    arrays and Python scalars), with no template."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
