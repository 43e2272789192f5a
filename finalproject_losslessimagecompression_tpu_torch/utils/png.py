"""A PNG reader that needs no PIL: numpy and the standard library's zlib.

It reads what the codec CLI takes as an image: 8-bit greyscale, greyscale
with alpha, RGB and RGBA, non-interlaced, with the five row filters of the
PNG specification (none, sub, up, average, Paeth), checking every chunk's
CRC.  Anything else (palette images, 1/2/4/16-bit samples, Adam7
interlacing, an unknown critical chunk, a damaged file) is refused with a
`PNGError` that says why.

    read_png(path_or_bytes) -> uint8 [H, W, C], C = 1, 2, 3 or 4
    as_rgb(arr)             -> uint8 [H, W, 3], as PIL's convert("RGB")
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (0 grey, 2 RGB, 4 grey + alpha, 6 RGBA)
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
# critical chunks this reader understands; PLTE is a suggested palette for
# the colour types read here and carries no pixel data
_KNOWN_CRITICAL = (b"IHDR", b"PLTE", b"IDAT", b"IEND")


class PNGError(ValueError):
    """A PNG this reader refuses or cannot parse."""


def _chunks(data: bytes, name: str):
    """(type, payload) of every chunk up to IEND, each CRC checked."""
    if data[:8] != SIGNATURE:
        raise PNGError(f"{name}: not a PNG file (bad signature)")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise PNGError(f"{name}: truncated (no IEND chunk)")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        end = pos + 12 + length
        if end > len(data):
            raise PNGError(f"{name}: truncated {ctype!r} chunk")
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(ctype + payload) != crc:
            raise PNGError(f"{name}: CRC mismatch in {ctype!r} chunk")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end


def _header(payload: bytes, name: str):
    if len(payload) != 13:
        raise PNGError(f"{name}: IHDR of {len(payload)} bytes")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              payload)
    if w == 0 or h == 0:
        raise PNGError(f"{name}: empty image ({w}x{h})")
    if ctype not in CHANNELS:
        kind = "palette" if ctype == 3 else f"unknown ({ctype})"
        raise PNGError(f"{name}: {kind} colour type is not supported "
                       "(greyscale, grey + alpha, RGB and RGBA are)")
    if depth != 8:
        raise PNGError(f"{name}: {depth}-bit samples are not supported "
                       "(8-bit only)")
    if interlace != 0:
        raise PNGError(f"{name}: interlaced (Adam7) PNGs are not supported")
    if comp != 0 or filt != 0:
        raise PNGError(f"{name}: unknown compression or filter method")
    return h, w, CHANNELS[ctype]


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, h: int, w: int, bpp: int, name: str) -> np.ndarray:
    stride = w * bpp
    if len(raw) != h * (stride + 1):
        raise PNGError(f"{name}: image data of {len(raw)} bytes, expected "
                       f"{h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # sub: a running sum over the pixels of a row
            cur = (np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.int64)
                   & 0xFF).astype(np.uint8).reshape(stride)
        elif ftype == 2:  # up (uint8 addition wraps mod 256)
            cur = line + prev
        elif ftype in (3, 4):  # average, Paeth: each byte needs its left
            buf = bytearray(line.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(buf, prev.tobytes(),
                                                         bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise PNGError(f"{name}: unknown row filter {ftype} (row {y})")
        out[y] = cur
        prev = out[y]
    return out.reshape(h, w, bpp)


def read_png(source) -> np.ndarray:
    """Decode an 8-bit, non-interlaced greyscale, grey + alpha, RGB or RGBA
    PNG (a path, or the file's bytes) to uint8 [H, W, C]."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        data, name = bytes(source), "<png bytes>"
    else:
        name = str(source)
        with open(source, "rb") as f:
            data = f.read()
    shape, idat = None, []
    for ctype, payload in _chunks(data, name):
        if ctype == b"IHDR":
            if shape is not None:
                raise PNGError(f"{name}: two IHDR chunks")
            shape = _header(payload, name)
        elif shape is None:
            raise PNGError(f"{name}: {ctype!r} chunk before IHDR")
        elif ctype == b"IDAT":
            idat.append(payload)
        elif ctype[0] & 0x20 == 0 and ctype not in _KNOWN_CRITICAL:
            raise PNGError(f"{name}: unknown critical chunk {ctype!r}")
    if not idat:
        raise PNGError(f"{name}: no image data (IDAT)")
    h, w, c = shape
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as err:
        raise PNGError(f"{name}: corrupt image data ({err})") from None
    return _unfilter(raw, h, w, c, name)


def as_rgb(arr: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] of `read_png` -> [H, W, 3] as PIL's convert("RGB")
    gives it: grey is repeated over three channels and alpha dropped."""
    c = arr.shape[-1]
    if c in (1, 2):
        return np.repeat(arr[..., :1], 3, axis=-1)
    return np.ascontiguousarray(arr[..., :3])
