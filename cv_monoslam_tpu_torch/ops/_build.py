"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` (``vision_kernels.cu``: the vision kernels;
``scan_kernels.cu``: the stored-table slot policy and the greedy corner
separation; ``conditional.cu``: IF nodes in a captured CUDA graph, for
``control.py``) is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, cached under ``.cache/torch_ext/`` at the
repository root and loaded with ``ctypes``. A library's file name carries a
hash of its source and flags, so an edited source is rebuilt at its next
use. Nothing is compiled when this module is imported: the first kernel
launch (or :func:`build`) does it, from the sources in the checkout only;
:func:`build` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Optional

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = {name: os.path.join(CSRC_DIR, f"{name}.cu")
           for name in ("vision_kernels", "scan_kernels", "conditional")}
BUILD_DIR = os.path.join(os.path.dirname(CSRC_DIR), "..", "..", ".cache",
                         "torch_ext")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str = "vision_kernels") -> str:
    with open(SOURCES[name], "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.abspath(
        os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so"))


def build(names: Optional[List[str]] = None) -> bool:
    """Compile the libraries ``names`` (all by default) that are not cached,
    one ``nvcc`` each, started together; True if any was built. Raises with
    the compiler's output if an ``nvcc`` fails."""
    jobs = []
    for name in names or list(SOURCES):
        out = library_path(name)
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, SOURCES[name]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return bool(jobs)


def load(signatures: Dict[str, list],
         name: str = "vision_kernels") -> ctypes.CDLL:
    """The loaded library ``name`` with ``argtypes`` set for each function
    in ``signatures`` (every entry point returns a C int error code)."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib
