"""PNG encode and decode with the standard library (zlib + struct).

The CLI writes its images and the server answers with PNGs without
Pillow, which the machine with the card does not have. ``encode_png``
writes 8-bit greyscale, RGB or RGBA, unfiltered rows, one IDAT chunk;
``decode_png`` reads any non-interlaced 8-bit greyscale, RGB or RGBA PNG
(every row filter), which covers what this module and Pillow write.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type
_CHANNELS = {v: k for k, v in _COLOR_TYPES.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """uint8 [H, W], [H, W, 1], [H, W, 3] or [H, W, 4] -> PNG bytes."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 images, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in _COLOR_TYPES:
        raise ValueError(f"encode_png takes [H, W] or [H, W, 1|3|4] images, got {a.shape}")
    h, w, c = a.shape
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = 0  # filter type None
    rows[:, 1:] = a.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a.astype(np.int16) + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W] (greyscale) or [H, W, 3|4]."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"decode_png reads 8-bit non-interlaced grey/RGB/RGBA only "
                         f"(depth {depth}, colour type {ctype}, interlace {interlace})")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    out = np.zeros((h, w * c), np.uint8)
    prev = np.zeros(w * c, np.uint8)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].copy()
        if f == 1 or f == 3 or f == 4:  # left-dependent filters run pixel by pixel
            for x in range(w * c):
                left = line[x - c] if x >= c else 0
                if f == 1:
                    line[x] = (int(line[x]) + int(left)) & 0xFF
                elif f == 3:
                    line[x] = (int(line[x]) + ((int(left) + int(prev[x])) >> 1)) & 0xFF
                else:
                    ul = prev[x - c] if x >= c else 0
                    line[x] = (int(line[x]) + int(_paeth(np.uint8(left), prev[x],
                                                         np.uint8(ul)))) & 0xFF
        elif f == 2:
            line = (line.astype(np.uint16) + prev).astype(np.uint8)
        elif f != 0:
            raise ValueError(f"unknown PNG row filter {f}")
        out[y] = line
        prev = line
    img = out.reshape(h, w, c)
    return img[..., 0] if c == 1 else img
