"""Build the port's host library (``csrc/wal.cc``) with ``g++`` on first use.

The library compiles into ``lazzaro_tpu_torch/_build/libwal-<hash>.so`` (the
hash covers the source and the flags), to a temporary name renamed into
place, so a concurrent loader never opens a half-written file. Without a
toolchain :func:`load` raises: the port has no silent Python fallback for
the write-ahead log.
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

SRC = Path(__file__).resolve().parent / "csrc" / "wal.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-Wall"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def so_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libwal-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path."""
    out = so_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the write-ahead log needs g++ (or $CXX) to build "
                           f"{SRC.name}; none was found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed for {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The built library with its argument types set, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.lz_crc32.restype = ctypes.c_uint32
        lib.lz_crc32.argtypes = [u8p, ctypes.c_int64]
        lib.lz_wal_append.restype = ctypes.c_int64
        lib.lz_wal_append.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int64,
                                      ctypes.c_int32]
        lib.lz_wal_load.restype = ctypes.c_void_p   # malloc'd, lz_free frees
        lib.lz_wal_load.argtypes = [ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_int64)]
        lib.lz_free.restype = None
        lib.lz_free.argtypes = [ctypes.c_void_p]
        lib.lz_wal_reset.restype = ctypes.c_int64
        lib.lz_wal_reset.argtypes = [ctypes.c_char_p]
        _lib = lib
        return lib
