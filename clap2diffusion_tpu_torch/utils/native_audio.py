"""ctypes bindings to the repository's native audio loader (port of
``clap2diffusion_tpu/utils/native_audio.py``).

The library is built from the sources the two packages share,
``native/audio_loader.cpp`` and ``native/flac_decoder.h``, at first use,
with the flags of ``native/Makefile`` (``g++ -O3 -march=native -fPIC
-shared -std=c++17 -pthread``, ``-ldl``), into the port's build directory
(``ops/cuda_build.py::build_dir``, under ``build/``). The library's name
carries a hash of the sources, the flags and the host, so that a tree
copied to another machine builds its own (``-march=native``). The
committed ``native/libc2d_audio.so`` is neither loaded nor rewritten.
``C2D_AUDIO_LIB`` names a library to load instead, as in the JAX package.
A failed build raises with the compiler's output; nothing falls back on
its own.

The library decodes WAV, FLAC (the in-repo decoder) and mp3 (the system's
libmpg123, opened with ``dlopen`` when present), resamples and pads or
crops, one file per call or a batch on threads; a file it cannot read
becomes zeros (status 1 in a batch). ``_fallback_one`` is the numpy path of
the same contract for WAV files, which the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from clap2diffusion_tpu_torch.ops.cuda_build import build_dir

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
SOURCES = ("audio_loader.cpp", "flac_decoder.h")
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread"]
LDLIBS = ["-ldl"]

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
# the last build in this process: the library's path and the compiler's seconds
BUILD_INFO: Dict[str, object] = {}


def _host() -> str:
    return " ".join((platform.node(), platform.machine(), platform.processor()))


def library_path() -> str:
    """Where the library is built: the name carries a hash of the sources,
    the flags and the host."""
    digest = hashlib.sha256(" ".join(CXXFLAGS + LDLIBS + [_host()]).encode())
    for name in SOURCES:
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    return os.path.join(build_dir(), f"libc2d_audio_{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the loader unless its library is already built; returns the
    library's path. Raises with the compiler's output when the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native audio loader (native/audio_loader.cpp) "
                           "cannot be built")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cxx, *CXXFLAGS, "-o", tmp, os.path.join(NATIVE_DIR, SOURCES[0]), *LDLIBS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the native audio loader failed (exit {proc.returncode}):"
                           f"\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO.update(path=out, seconds=time.perf_counter() - t0)
    return out


def load_library() -> ctypes.CDLL:
    """The loader, built and loaded once per process (``C2D_AUDIO_LIB``
    names another library to load)."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = os.environ.get("C2D_AUDIO_LIB") or build()
        lib = ctypes.CDLL(path)
        lib.c2d_abi_version.restype = ctypes.c_int
        if lib.c2d_abi_version() not in (1, 2, 3):
            raise RuntimeError(f"{path}: audio loader ABI {lib.c2d_abi_version()}, "
                               "expected 1-3")
        lib.c2d_load_audio.restype = ctypes.c_int
        lib.c2d_load_audio.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        lib.c2d_load_audio_batch.restype = ctypes.c_int
        lib.c2d_load_audio_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)]
        if lib.c2d_abi_version() >= 2:
            lib.c2d_decode_audio.restype = ctypes.c_longlong
            lib.c2d_decode_audio.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_int)]
        if lib.c2d_abi_version() >= 3:
            lib.c2d_decode_audio_alloc.restype = ctypes.c_longlong
            lib.c2d_decode_audio_alloc.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int)]
            lib.c2d_free.restype = None
            lib.c2d_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        BUILD_INFO.setdefault("path", path)
        _LIB = lib
        return lib


def native_available() -> bool:
    """True once the library is built and loaded (a failed build raises)."""
    return load_library() is not None


def decode_audio(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """Decode WAV/FLAC/mp3 at the file's own rate -> (mono float32 [n], sr);
    None from a library of ABI 1, which cannot decode alone. Raises
    ``ValueError`` when the file cannot be decoded (a corrupt stream, or mp3
    without the system's libmpg123)."""
    lib = load_library()
    if lib.c2d_abi_version() < 2:
        return None
    sr = ctypes.c_int(0)
    if lib.c2d_abi_version() >= 3:
        buf = ctypes.POINTER(ctypes.c_float)()
        n = lib.c2d_decode_audio_alloc(path.encode(), ctypes.byref(buf), ctypes.byref(sr))
        if n < 0:
            raise ValueError(f"{path}: native audio decode failed")
        try:
            out = np.ctypeslib.as_array(buf, shape=(int(n),)).copy() if n else \
                np.zeros(0, np.float32)
        finally:
            lib.c2d_free(buf)
        return out, int(sr.value)
    n = lib.c2d_decode_audio(path.encode(), None, 0, ctypes.byref(sr))
    if n < 0:
        raise ValueError(f"{path}: native audio decode failed")
    out = np.zeros(int(n), np.float32)
    n2 = lib.c2d_decode_audio(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                              int(n), ctypes.byref(sr))
    if n2 != n:  # the file changed, or an IO error, between the passes
        raise ValueError(f"{path}: native audio decode failed on fill pass")
    return out, int(sr.value)


def load_audio(path: str, target_sr: int, target_len: int,
               peak_norm: bool = False) -> np.ndarray:
    """Decode + resample + zero-pad or crop one file -> float32
    [target_len]; zeros when the file cannot be read."""
    out = np.zeros(target_len, np.float32)
    load_library().c2d_load_audio(path.encode(), target_sr, target_len, int(peak_norm),
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def load_audio_batch(paths: List[str], target_sr: int, target_len: int,
                     peak_norm: bool = False,
                     num_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Threaded batch decode -> (float32 [n, target_len], statuses [n],
    0 for a file read, 1 for a file that became zeros)."""
    n = len(paths)
    out = np.zeros((n, target_len), np.float32)
    statuses = np.zeros(n, np.int32)
    load_library().c2d_load_audio_batch(
        "\n".join(paths).encode(), n, target_sr, target_len, int(peak_norm), num_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out, statuses


def _fallback_one(path: str, target_sr: int, target_len: int,
                  peak_norm: bool) -> np.ndarray:
    """The numpy path of ``load_audio`` for a WAV: decode, mono-average,
    optionally peak-normalise, resample, pad or crop; zeros on any error."""
    from clap2diffusion_tpu_torch.models.clap.frontend import resample_poly
    from clap2diffusion_tpu_torch.utils.audio_io import peak_normalize, read_wav

    try:
        wav, sr = read_wav(path)
        if wav.ndim == 2:
            wav = wav.mean(axis=0)
        if peak_norm:
            wav = peak_normalize(wav)
        if sr != target_sr:
            wav = resample_poly(wav, sr, target_sr, keep=target_len)
        if len(wav) < target_len:
            wav = np.pad(wav, (0, target_len - len(wav)))
        return wav[:target_len].astype(np.float32)
    except Exception:
        return np.zeros(target_len, np.float32)
