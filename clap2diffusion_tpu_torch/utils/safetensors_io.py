"""safetensors read/write with torch and the standard library only (a copy
of ``clap2diffusion_tpu/utils/safetensors_io.py`` for the port).

Published SD v1.5, CLIP and CLAP weights ship as ``.safetensors``; the port
reads them, and writes its own pipeline checkpoints, without the
``safetensors`` package and without ``ml_dtypes``: BF16 goes through
``torch.frombuffer(..., dtype=torch.bfloat16)``.

Format (stable, versionless): an 8-byte little-endian u64 header length, a
JSON header mapping tensor name -> {"dtype", "shape", "data_offsets":
[begin, end]} (offsets into the byte buffer that follows, tensors
little-endian and C-contiguous) and an optional "__metadata__" string map.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional

import torch

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read every tensor into a {name: CPU tensor} state dict. The tensors
    share one writable buffer read from the file."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        buf = bytearray(os.fstat(f.fileno()).st_size - 8 - hlen)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: truncated safetensors file")
    out: Dict[str, torch.Tensor] = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES[spec["dtype"]]
        begin, end = spec["data_offsets"]
        shape = list(spec["shape"])
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        t = torch.frombuffer(buf, dtype=dtype, count=(end - begin) // dtype.itemsize,
                             offset=begin)
        out[name] = t.reshape(shape)
    return out


def _raw(t: torch.Tensor) -> tuple:
    """(safetensors dtype name, shape, the bytes as a uint8 numpy view)."""
    t = t.detach().cpu().contiguous()
    if t.dtype not in _NAMES:
        raise ValueError(f"unsupported dtype for safetensors: {t.dtype}")
    return _NAMES[t.dtype], list(t.shape), t.reshape(-1).view(torch.uint8).numpy()


def save_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                     metadata: Optional[Dict[str, str]] = None) -> str:
    """Write a {name: tensor} dict in safetensors layout, each tensor in its
    own type; round-trips through ``load_safetensors`` and the upstream
    readers."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    chunks = []
    offset = 0
    for name, t in tensors.items():
        dtype, shape, raw = _raw(t)
        header[name] = {"dtype": dtype, "shape": shape,
                        "data_offsets": [offset, offset + raw.size]}
        chunks.append(raw)
        offset += raw.size
    hjson = json.dumps(header, separators=(",", ":")).encode()
    hjson += b" " * ((-len(hjson)) % 8)  # upstream aligns the buffer to 8 bytes
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for raw in chunks:
            f.write(raw)
    return path
