"""ctypes bindings for the native C++ host runtime (native/cvms_runtime.cpp).

The native library is the analogue of the reference's C++ ingestion and
recording layers (SLAM.cpp:363-543, 3499-3603): odometry text parsing with
min-step/redirect preprocessing, libjpeg grayscale decode, a threaded
double-buffered image prefetcher, and buffered text recording. Every entry
point has a pure-Python counterpart in :mod:`.dataset` / :mod:`.recording`;
``available()`` reports whether the native path is usable. It runs on the
host and touches no device.

The functions and classes are those of ``cv_monoslam_tpu/io/native.py``;
the build is this package's own. The source ``native/cvms_runtime.cpp`` is
compiled with the flags of ``native/Makefile`` into
``.cache/native/libcvms_runtime-<hash of source and flags>.so`` through a
temporary file named by the process id and an atomic rename, as
``ops/_build.py`` builds the kernels: processes that build at once never
load a half-written library, and nothing is written into ``native/``.
``available()`` is False when ``g++`` or libjpeg is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
SOURCE = os.path.abspath(os.path.join(_ROOT, "native", "cvms_runtime.cpp"))
BUILD_DIR = os.path.abspath(os.path.join(_ROOT, ".cache", "native"))
#: ``native/Makefile``'s CXXFLAGS and LDFLAGS
CXXFLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall"]
LDFLAGS = ["-shared", "-ljpeg", "-lpthread"]

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(CXXFLAGS + LDFLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libcvms_runtime-{h.hexdigest()[:16]}.so")


def build() -> bool:
    """Compile the library unless it is cached; True if it was built.
    Raises with the compiler's output if ``g++`` fails."""
    out = library_path()
    if os.path.exists(out):
        return False
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXXFLAGS, SOURCE, "-o", tmp, *LDFLAGS],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        build()
        lib = ctypes.CDLL(library_path())
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None

    c = ctypes
    lib.cvms_load_odometry.restype = c.c_int
    lib.cvms_load_odometry.argtypes = [
        c.c_char_p, c.c_double, c.c_double, c.c_longlong, c.c_double,
        c.c_double, c.POINTER(c.c_longlong), c.POINTER(c.c_double),
        c.POINTER(c.c_double), c.POINTER(c.c_uint8)]
    lib.cvms_decode_jpeg_file_gray.restype = c.c_int
    lib.cvms_decode_jpeg_file_gray.argtypes = [
        c.c_char_p, c.POINTER(c.c_float), c.c_int, c.c_int,
        c.POINTER(c.c_int), c.POINTER(c.c_int)]
    lib.cvms_prefetch_open.restype = c.c_void_p
    lib.cvms_prefetch_open.argtypes = [
        c.c_char_p, c.POINTER(c.c_longlong), c.c_longlong, c.c_int, c.c_int,
        c.c_int]
    lib.cvms_prefetch_next.restype = c.c_int
    lib.cvms_prefetch_next.argtypes = [c.c_void_p, c.POINTER(c.c_float)]
    lib.cvms_prefetch_close.restype = None
    lib.cvms_prefetch_close.argtypes = [c.c_void_p]
    lib.cvms_recorder_open.restype = c.c_void_p
    lib.cvms_recorder_open.argtypes = [c.c_char_p, c.c_char_p]
    lib.cvms_record_robot.restype = None
    lib.cvms_record_robot.argtypes = [
        c.c_void_p, c.c_longlong, c.c_double, c.c_double, c.c_double,
        c.c_double, c.POINTER(c.c_double)]
    lib.cvms_record_features.restype = None
    lib.cvms_record_features.argtypes = [
        c.c_void_p, c.POINTER(c.c_longlong), c.POINTER(c.c_double),
        c.POINTER(c.c_uint8), c.c_longlong]
    lib.cvms_recorder_close.restype = None
    lib.cvms_recorder_close.argtypes = [c.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    return lib


def load_odometry(path: str, min_step_xy: float = 0.01,
                  min_step_theta: float = float(np.deg2rad(45.0)),
                  capacity: int = 3000,
                  init_pos=(0.0, 0.0)):
    """Native odometry load -> (ids, xy, theta, redirect) arrays.

    Same semantics as dataset.preprocess_odometry (SLAM.cpp:363-519).
    Raises RuntimeError if the library is unavailable or the file bad.
    """
    lib = _require()
    cap = capacity + 1
    ids = np.zeros(cap, np.int64)
    xy = np.zeros((cap, 2), np.float64)
    theta = np.zeros(cap, np.float64)
    redirect = np.zeros(cap, np.uint8)
    n = lib.cvms_load_odometry(
        path.encode(), min_step_xy, min_step_theta, capacity,
        init_pos[0], init_pos[1],
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        theta.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        redirect.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if n < 0:
        raise RuntimeError(f"cvms_load_odometry failed: {n} ({path})")
    return ids[:n], xy[:n], theta[:n], redirect[:n].astype(bool)


def decode_jpeg_gray(path: str, max_w: int = 4096,
                     max_h: int = 4096) -> np.ndarray:
    """Decode a JPEG file to grayscale float32 (H, W) in [0, 255]."""
    lib = _require()
    out = np.zeros((max_h, max_w), np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.cvms_decode_jpeg_file_gray(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_w, max_h, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise RuntimeError(f"jpeg decode failed ({rc}): {path}")
    return out.ravel()[: w.value * h.value].reshape(h.value, w.value).copy()


class NativePrefetcher:
    """Background-thread JPEG prefetcher over a printf-pattern sequence:
    decode of frames t+1..t+depth overlaps the work on frame t."""

    def __init__(self, pattern: str, ids: np.ndarray, width: int,
                 height: int, depth: int = 4):
        self._handle = None
        self._lib = _require()
        self.width, self.height = width, height
        ids64 = np.ascontiguousarray(ids, np.int64)
        self._handle = self._lib.cvms_prefetch_open(
            pattern.encode(),
            ids64.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            len(ids64), width, height, depth)

    def next(self) -> Optional[np.ndarray]:
        out = np.empty((self.height, self.width), np.float32)
        rc = self._lib.cvms_prefetch_next(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc == 1:
            return None
        if rc != 0:
            raise RuntimeError(f"prefetch decode error {rc}")
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.cvms_prefetch_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class NativeRecorder:
    """Buffered append of RobotPath.txt / FeaturesInfo.txt rows
    (SLAM.cpp:3546-3556, 3596-3602) through the C++ runtime. It writes
    10 decimals and no ``# frame k`` lines, so its files are not the Python
    writers' bytes; ``np.loadtxt`` reads both alike."""

    def __init__(self, robot_path: str = "", features_path: str = ""):
        self._handle = None
        self._lib = _require()
        self._handle = self._lib.cvms_recorder_open(
            robot_path.encode(), features_path.encode())

    def record_robot(self, frame: int, odo_xy, pose_xy, cov2x2) -> None:
        cov = np.ascontiguousarray(cov2x2, np.float64).reshape(4)
        self._lib.cvms_record_robot(
            self._handle, frame, float(odo_xy[0]), float(odo_xy[1]),
            float(pose_xy[0]), float(pose_xy[1]),
            cov.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))

    def record_features(self, ids, xyz, valid) -> None:
        ids64 = np.ascontiguousarray(ids, np.int64)
        x = np.ascontiguousarray(xyz, np.float64).reshape(-1, 3)
        v = np.ascontiguousarray(valid, np.uint8)
        if not len(x) == len(v) == len(ids64):
            raise ValueError("ids, xyz and valid differ in length")
        self._lib.cvms_record_features(
            self._handle,
            ids64.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(ids64))

    def close(self) -> None:
        if self._handle:
            self._lib.cvms_recorder_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
