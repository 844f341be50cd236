"""Build the package's CUDA sources into shared libraries at first use.

Each source under `csrc/` is compiled by `nvcc` for Hopper (`sm_90a`) into
a shared library with a plain C interface and loaded with `ctypes`. No
PyTorch header is included, so a build takes seconds. Libraries land in
`build/kernels/` beside the package (listed in `.gitignore`), named by a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. A build writes to a temporary name and
renames it, so processes that build at once do not see half a file, and
each source has its own lock, so threads can build several sources at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                      "-Xptxas", "-v"]

_LOCK = threading.Lock()
_SOURCE_LOCKS: Dict[str, threading.Lock] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
# What the last build of each source printed (-Xptxas -v: registers,
# shared memory and spills per kernel) and how long it took.
BUILD_INFO: Dict[str, dict] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels are built from source at first use")
    return found


def load_library(source: str) -> ctypes.CDLL:
    """Compile `csrc/<source>` if needed and return the loaded library."""
    with _LOCK:
        lock = _SOURCE_LOCKS.setdefault(source, threading.Lock())
    with lock:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(_build(source)))
            _LIBS[source] = lib
        return lib


def _build(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    if out.exists():
        BUILD_INFO.setdefault(source, {"seconds": 0.0, "log": "(cached)",
                                       "path": str(out)})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *FLAGS, "-o", tmp, str(src)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_INFO[source] = {"seconds": time.perf_counter() - t0,
                          "log": proc.stdout + proc.stderr, "path": str(out)}
    return out
