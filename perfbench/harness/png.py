"""A PNG reader for the served images (8-bit greyscale, RGB or RGBA, every
row filter), so that the benchmark reads the program's answers itself."""

from __future__ import annotations

import struct
import zlib

import numpy as np

CHANNELS = {0: 1, 2: 3, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def decode(data: bytes) -> np.ndarray:
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, width = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            width, height, depth, color = struct.unpack(">IIBB", body[:10])
            if depth != 8 or color not in CHANNELS or body[12] != 0:
                raise ValueError("only 8-bit, non-interlaced greyscale, RGB or RGBA")
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    ch = CHANNELS[color]
    stride = width * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 2:
            cur = (line + prev) & 255
        else:
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = int(cur[x - ch]) if x >= ch else 0
                c = int(prev[x - ch]) if x >= ch else 0
                pred = {1: a, 3: (a + int(prev[x])) >> 1,
                        4: _paeth(a, int(prev[x]), c)}.get(int(f))
                if pred is None:
                    raise ValueError(f"unknown PNG row filter {f}")
                cur[x] = (int(line[x]) + pred) & 255
        out[y] = cur
        prev = cur
    return out.reshape(height, width, ch) if ch > 1 else out.reshape(height, width)
