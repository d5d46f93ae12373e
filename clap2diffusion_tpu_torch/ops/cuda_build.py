"""Build a CUDA source of the port into a shared library and load it.

Each source under ``clap2diffusion_tpu_torch/csrc/`` is compiled by ``nvcc``
for ``sm_90a`` (Hopper) into a library with a plain C interface, loaded with
``ctypes``. The build happens at first use, into ``build/kernels/`` beside
the package (``C2D_TORCH_BUILD_DIR`` overrides it); the library's name
carries a hash of the source, of the headers under ``csrc/`` it includes
and of the flags, so an edited source or header is rebuilt. A failed build
raises: there is no fallback.
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
from typing import Dict, Iterable, List, Optional

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


_TYPE_NAMES = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}


def _short_name(mangled: str) -> str:
    """``flash_bwd_bf16<40>``, ``wino_filter<bf16,f32>`` or
    ``group_norm_fwd<bf16,bf16>`` from a mangled kernel name of this repo."""
    m = re.search(r"(wino_filter|group_norm_fwd)I((?:13__nv_bfloat16|6__half|f|S\d*_)+)E",
                  mangled)
    if m is not None:
        types: List[str] = []
        for tok in re.findall(r"13__nv_bfloat16|6__half|f|S\d*_", m.group(2)):
            # a repeated type is mangled as a substitution (S1_): the one before it
            types.append(types[-1] if tok.startswith("S") else _TYPE_NAMES[tok])
        return f"{m.group(1)}<{','.join(types)}>"
    m = re.search(r"((?:flash_(?:fwd(?:_wide|_ws)?|bwd(?:_dq|_dkdv)?)|packed_fwd"
                  r"|wino(?:_gemm|_input|_reduce)?)_(?:bf16|f32)|bwd_delta|qreg_probe)", mangled)
    if m is None:
        return mangled
    args = re.findall(r"L[ib](\d+)E", mangled)
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


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(source: str, csrc_dir: Optional[str] = None) -> List[str]:
    """``source`` and every header of ``csrc/`` it includes with quotes,
    directly or through another header, each once, in the order found."""
    csrc_dir = csrc_dir or CSRC_DIR
    found: List[str] = []
    todo = [source]
    while todo:
        name = todo.pop(0)
        if name in found:
            continue
        found.append(name)
        with open(os.path.join(csrc_dir, name), "r", encoding="utf-8") as f:
            todo.extend(_INCLUDE.findall(f.read()))
    return found


def library_path(source: str, csrc_dir: Optional[str] = None) -> str:
    """Where ``source``'s library is built: the name carries a hash of the
    source, of the headers it includes and of the flags."""
    csrc_dir = csrc_dir or CSRC_DIR
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in source_files(source, csrc_dir):
        with open(os.path.join(csrc_dir, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(build_dir(), f"lib{stem}_{digest.hexdigest()[:12]}.so")


def build(source: str, csrc_dir: Optional[str] = None) -> str:
    """Compile ``<csrc_dir>/<source>`` (the package's ``csrc/`` by default)
    unless its library is already built; returns the library's path. What
    nvcc printed goes to ``BUILD_LOGS``."""
    csrc_dir = csrc_dir or CSRC_DIR
    out = library_path(source, csrc_dir)
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(csrc_dir, source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    BUILD_LOGS[source if csrc_dir == CSRC_DIR else out] = proc.stdout + proc.stderr
    os.replace(tmp, out)
    return out


def build_all(sources: Iterable[str], csrc_dir: Optional[str] = None) -> None:
    """Build several sources of ``csrc_dir`` (the package's ``csrc/`` by
    default) at once, one nvcc process each."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        for fut in [pool.submit(build, s, csrc_dir) for s in sources]:
            fut.result()


def load(source: str, csrc_dir: Optional[str] = None) -> ctypes.CDLL:
    """Build (if needed) and load ``<csrc_dir>/<source>`` once per process
    (another checkout's ``csrc/`` gives another library: a baseline to
    measure against)."""
    key = os.path.join(csrc_dir or CSRC_DIR, source)
    with _LOCK:
        if key not in _LOADED:
            _LOADED[key] = ctypes.CDLL(build(source, csrc_dir))
        return _LOADED[key]
