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
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
# -Xptxas=-v prints each kernel's registers, shared memory and spills at build time
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# what nvcc printed for each source built in this process (ptxas -v lines)
BUILD_LOGS: Dict[str, str] = {}
_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def _short_name(mangled: str) -> str:
    """``flash_bwd_dq_bf16<64>`` from a mangled kernel name of this repo."""
    m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkdv)_(?:bf16|f32)|bwd_delta)", mangled)
    if m is None:
        return mangled
    args = re.findall(r"Li(\d+)E", mangled)
    if m.group(1) == "bwd_delta":
        args = ["bf16" if "bfloat16" in mangled else "f32"]
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def ptxas_summary(text: str) -> List[Dict]:
    """Per kernel of an nvcc ``-Xptxas=-v`` log: name, registers, spill
    stores and loads (bytes)."""
    out: List[Dict] = []
    for line in text.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            out.append({"kernel": _short_name(m.group(1))})
        elif out and (m := _PTXAS_SPILL.search(line)):
            out[-1]["spill_stores"], out[-1]["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif out and (m := _PTXAS_REGS.search(line)):
            out[-1]["registers"] = int(m.group(1))
    return out


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
    returns the library's path. What nvcc printed goes to ``BUILD_LOGS``."""
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
    BUILD_LOGS[source] = proc.stdout + proc.stderr
    os.replace(tmp, out)
    return out


def build_all(sources: Iterable[str]) -> None:
    """Build several sources at once, one nvcc process each."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        for fut in [pool.submit(build, s) for s in sources]:
            fut.result()


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>`` once per process."""
    with _LOCK:
        if source not in _LOADED:
            _LOADED[source] = ctypes.CDLL(build(source))
        return _LOADED[source]
