"""q97's key-space split in native host code (``csrc/key_split.cpp``).

:func:`partition` cuts one table's (customer_sk, item_sk) int32 rows in two
by one bit of the composite key's mixing hash, keeping input order on each
side.  The library is loaded with ``ctypes.CDLL``, which releases the GIL
for the whole call, so the other task threads run while one splits; inside
the call, rows are cut into ranges over up to 8 threads by the row count.

The library is built with ``g++`` on first use into ``build/native/`` at
the repository root, under a name keyed on the source's content, so an
edited source is never served by a stale build.  Threads that split at once
build and load it once: :func:`library` holds a lock.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "key_split.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
GXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libkey_split-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless this exact source is already built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # built under a per-process and per-thread name and renamed into place,
    # so processes building at once never load a half-written file
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (rc={res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The built split library, with its function's C signature declared:
    built and loaded once, by the first caller, while the others wait."""
    global _library
    if _library is None:
        with _lock:
            if _library is None:
                lib = ctypes.CDLL(str(build()))
                p = ctypes.c_void_p
                # (cust, item, rows, bit, out cust, out item) -> side 0's rows
                lib.srt_key_split.argtypes = [p, p, ctypes.c_int64, ctypes.c_int, p, p]
                lib.srt_key_split.restype = ctypes.c_int64
                _library = lib
    return _library


def _keys(a) -> np.ndarray:
    a = np.asarray(a)
    if not np.can_cast(a.dtype, np.int32):
        raise TypeError(f"q97 split keys are int32, not {a.dtype}")
    return np.ascontiguousarray(a, dtype=np.int32)


def partition(cust, item, bit: int) -> Tuple[Tuple[np.ndarray, np.ndarray],
                                             Tuple[np.ndarray, np.ndarray]]:
    """((cust, item) of side 0, (cust, item) of side 1) of one table's rows,
    each side in input order, a row's side being bit ``bit`` (0..63) of
    ``((uint64)((int64)cust << 32 | item & 0xFFFFFFFF)) * 0x9E3779B97F4A7C15``.
    The sides are C-contiguous int32 slices of two new arrays of the table's
    length, side 0 first."""
    cust, item = _keys(cust), _keys(item)
    if cust.shape != item.shape or cust.ndim != 1:
        raise ValueError(f"cust {cust.shape} and item {item.shape} must be one length")
    if not 0 <= bit <= 63:
        raise ValueError(f"split bit {bit} is outside 0..63")
    out_cust, out_item = np.empty_like(cust), np.empty_like(item)
    n0 = library().srt_key_split(cust.ctypes.data, item.ctypes.data, len(cust), bit,
                                 out_cust.ctypes.data, out_item.ctypes.data)
    return (out_cust[:n0], out_item[:n0]), (out_cust[n0:], out_item[n0:])
