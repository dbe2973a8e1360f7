"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``lazzaro_tpu_torch/_build/<name>-<hash>.so`` (the hash covers the
source, the ``csrc/*.cuh`` headers it may include and the flags, so an
edited source or header rebuilds). Nothing here runs at
import time: the first call that needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest = digest.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_command(name: str, out: Path, verbose: bool = False) -> List[str]:
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / f"{name}.cu")]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd


def start_build(name: str, verbose: bool = False):
    """Start ``nvcc`` for one source; returns ``(process, final_path)`` or
    ``(None, final_path)`` when the library is already built. The output
    goes to a temporary name and is renamed by :func:`finish_build`, so a
    concurrent loader never sees a half-written file."""
    out = library_path(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(build_command(name, tmp, verbose),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, out


def finish_build(proc, out: Path) -> str:
    """Wait for a build from :func:`start_build`; returns nvcc's output and
    raises if it failed."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)
    return log


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            proc, out = start_build(name)
            finish_build(proc, out)
            lib = ctypes.CDLL(str(out))
            _libs[name] = lib
        return lib
