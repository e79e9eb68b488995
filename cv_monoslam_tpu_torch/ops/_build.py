"""Build and load the hand-written CUDA kernels.

``csrc/vision_kernels.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, cached under ``.cache/torch_ext/``
at the repository root and loaded with ``ctypes``. The library's file name
carries a hash of its source and flags, so an edited source is rebuilt at
its next use. Nothing is compiled when this module is imported: the first
kernel launch (or :func:`build`) does it, from the sources in the checkout
only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCE = os.path.join(CSRC_DIR, "vision_kernels.cu")
BUILD_DIR = os.path.join(os.path.dirname(CSRC_DIR), "..", "..", ".cache",
                         "torch_ext")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.abspath(
        os.path.join(BUILD_DIR, f"libvision_kernels_{h.hexdigest()[:16]}.so"))


def build() -> bool:
    """Compile the library unless it is cached; True if it was built.
    Raises with the compiler's output if ``nvcc`` fails."""
    out = library_path()
    if os.path.exists(out):
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return True


def load(signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library with ``argtypes`` set for each function in
    ``signatures`` (every entry point returns a C int error code)."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(library_path())
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _lib = lib
    return _lib
