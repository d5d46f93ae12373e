"""Build a CUDA source of the port into a shared library and load it.

Each source under ``clap2diffusion_tpu_torch/csrc/`` is compiled by ``nvcc``
for ``sm_90a`` (Hopper) into a library with a plain C interface, loaded with
``ctypes``. The build happens at first use, into ``build/kernels/`` beside
the package (``C2D_TORCH_BUILD_DIR`` overrides it); the library's name
carries a hash of the source and flags, so an edited source is rebuilt. A
failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
# -Xptxas=-v prints each kernel's registers, shared memory and spills at build time
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> str:
    default = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)), "build", "kernels")
    return os.environ.get("C2D_TORCH_BUILD_DIR", default)


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of the port cannot be built")


def library_path(source: str) -> str:
    src = os.path.join(CSRC_DIR, source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(build_dir(), f"lib{stem}_{digest.hexdigest()[:12]}.so")


def build(source: str) -> str:
    """Compile ``csrc/<source>`` unless its library is already built;
    returns the library's path. Prints what nvcc prints."""
    out = library_path(source)
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    if proc.stdout.strip() or proc.stderr.strip():
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, out)
    return out


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>`` once per process."""
    with _LOCK:
        if source not in _LOADED:
            _LOADED[source] = ctypes.CDLL(build(source))
        return _LOADED[source]
