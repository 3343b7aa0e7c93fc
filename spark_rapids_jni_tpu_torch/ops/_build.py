"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

The library is compiled on first use for ``sm_90a`` into ``build/kernels/``
at the repository root, under a name keyed on the sources' content, so an
edited source is never served by a stale build.  Threads that make their
first kernel call at once build and load it once: :func:`library` holds a
lock.  Nothing here runs at import time: a machine without nvcc or a card
can import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "hash_kernels.cu", _PKG / "csrc" / "agg_kernels.cu")
BUILD_DIR = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _U32, _U64, _I64 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int64
# (value, seed-or-hash tensor or NULL, scalar seed-or-hash, out, n, stream)
_SIGNATURES = {
    "srt_mm_hash_int": (_P, _P, _U32, _P, _I64, _P),
    "srt_mm_hash_long": (_P, _P, _U32, _P, _I64, _P),
    "srt_xx_hash_fixed4": (_P, _P, _U64, _P, _I64, _P),
    "srt_xx_hash_fixed8": (_P, _P, _U64, _P, _I64, _P),
    # (chars, offsets[n+1], hash tensor or NULL, scalar hash, out, n, stream)
    "srt_mm_hash_strings": (_P, _P, _P, _U32, _P, _I64, _P),
    # (chars, starts, lens, hash tensor or NULL, scalar hash, out, n, stream)
    "srt_mm_hash_bytes": (_P, _P, _P, _P, _U32, _P, _I64, _P),
    # (hi, lo, hash tensor or NULL, scalar hash, out, n, stream)
    "srt_mm_hash_decimal128": (_P, _P, _P, _U32, _P, _I64, _P),
    # (ids, id bytes, values, value code, out, n, num_segments, stream)
    "srt_segment_sum": (_P, ctypes.c_int, _P, ctypes.c_int, _P, _I64, _I64, _P),
}

#: nvcc's output of the build this process ran (ptxas register counts), or
#: "" when the library was already built.
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA "
                       "toolkit is installed (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    digest = hashlib.sha256(b"".join(src.read_bytes() for src in SOURCES)
                            + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsrt_kernels-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless these exact sources are already built."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (rc={res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    build_log = res.stdout + res.stderr
    return out


_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The built kernel library, with every function's C signature declared:
    built and loaded once, by the first caller, while the others wait."""
    global _library
    if _library is None:
        with _lock:
            if _library is None:
                lib = ctypes.CDLL(str(build()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                _library = lib
    return _library
