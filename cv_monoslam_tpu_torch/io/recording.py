"""Recording / telemetry writers (reference C17, SLAM.cpp:3499-3603).

Drop-in output formats:
  * :class:`RobotPathRecorder` — the reference's RobotPath.txt: per frame
    ``index odo_x odo_y est_x est_y p00 p01 p10 p11`` (recordRobotInformation,
    SLAM.cpp:3512-3562);
  * :class:`FeaturesInfoRecorder` — FeaturesInfo.txt: per frame, one
    ``id x y z`` line per stored landmark (recordFeaturesInformation,
    SLAM.cpp:3571-3603);
  * :class:`MetricsRecorder` — structured JSONL per-frame metrics
    (frame index, pose, counters, timings) replacing the reference's
    UI counters + Chinese console prints (SLAM.cpp:2469-2511,
    MonoSLAMView.cpp:76-93).

All writers are append-only host-side objects; the filter itself stays pure.
"""

from __future__ import annotations

import json
import os
from typing import IO, Optional

import numpy as np


def _open(path: str) -> IO[str]:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    return open(path, "w")


class RobotPathRecorder:
    """Reference-format robot trajectory file (SLAM.cpp:3546-3556)."""

    def __init__(self, path: str):
        self.path = path
        self._f = _open(path)

    def record(self, frame: int, odo_xy: np.ndarray, est_xy: np.ndarray,
               pose_cov2: np.ndarray) -> None:
        p = np.asarray(pose_cov2, dtype=np.float64).reshape(2, 2)
        self._f.write(
            f"{frame:d} {odo_xy[0]:.6f} {odo_xy[1]:.6f} "
            f"{est_xy[0]:.6f} {est_xy[1]:.6f} "
            f"{p[0, 0]:.6e} {p[0, 1]:.6e} {p[1, 0]:.6e} {p[1, 1]:.6e}\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class FeaturesInfoRecorder:
    """Reference-format landmark xyz file (SLAM.cpp:3596-3602)."""

    def __init__(self, path: str):
        self.path = path
        self._f = _open(path)

    def record(self, frame: int, lids: np.ndarray, xyz: np.ndarray,
               valid: np.ndarray) -> None:
        self._f.write(f"# frame {frame:d}\n")
        for i in np.flatnonzero(np.asarray(valid)):
            x, y, z = np.asarray(xyz[i], dtype=np.float64)
            self._f.write(f"{int(lids[i]):d} {x:.6f} {y:.6f} {z:.6f}\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class MetricsRecorder:
    """JSONL per-frame metrics stream."""

    def __init__(self, path: str):
        self.path = path
        self._f = _open(path)

    def record(self, **fields) -> None:
        clean = {}
        for k, v in fields.items():
            if isinstance(v, (np.ndarray, np.generic)):
                v = v.tolist()
            clean[k] = v
        self._f.write(json.dumps(clean) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class RunRecorder:
    """Bundles the three writers behind the reference's two config toggles
    (record_robot_info / record_features_info, SetParameters.cpp) plus the
    new metrics stream. Any writer may be disabled with a None path."""

    def __init__(self, robot_path: Optional[str] = None,
                 features_path: Optional[str] = None,
                 metrics_path: Optional[str] = None,
                 use_native: bool = False):
        # ``use_native`` routes the robot and landmark files through the C++
        # writer (``io/native.py``) when that library builds, else through
        # the Python writers below. The C++ writer prints 10 decimals and no
        # ``# frame k`` lines: its bytes differ, its rows agree to 1e-6.
        self._native = None
        if use_native and (robot_path or features_path):
            from . import native

            if native.available():
                self._native = native.NativeRecorder(robot_path or "",
                                                     features_path or "")
                robot_path = features_path = None
        self.robot = RobotPathRecorder(robot_path) if robot_path else None
        self.features = (FeaturesInfoRecorder(features_path)
                         if features_path else None)
        self.metrics = MetricsRecorder(metrics_path) if metrics_path else None

    def record_frame(self, frame: int, *, odo_xy, pose, pose_cov2=None,
                     lids=None, xyz=None, valid=None, **metrics) -> None:
        if self._native is not None:
            cov = (np.zeros((2, 2)) if pose_cov2 is None
                   else np.asarray(pose_cov2))
            self._native.record_robot(frame, np.asarray(odo_xy),
                                      np.asarray(pose)[:2], cov)
            if lids is not None:
                self._native.record_features(np.asarray(lids),
                                             np.asarray(xyz),
                                             np.asarray(valid))
        if self.robot is not None:
            cov = (np.zeros((2, 2)) if pose_cov2 is None
                   else np.asarray(pose_cov2))
            self.robot.record(frame, np.asarray(odo_xy),
                              np.asarray(pose)[:2], cov)
        if self.features is not None and lids is not None:
            self.features.record(frame, np.asarray(lids), np.asarray(xyz),
                                 np.asarray(valid))
        if self.metrics is not None:
            self.metrics.record(frame=frame,
                                pose=np.asarray(pose),
                                odo=np.asarray(odo_xy), **metrics)

    def close(self) -> None:
        if self._native is not None:
            self._native.close()
        for w in (self.robot, self.features, self.metrics):
            if w is not None:
                w.close()


def load_robot_path(path: str) -> dict:
    """Parse a RobotPath-format file back into arrays (for analysis/tests)."""
    rows = np.loadtxt(path, ndmin=2)
    if rows.size == 0:
        rows = np.zeros((0, 9))
    return dict(
        frame=rows[:, 0].astype(int),
        odo_xy=rows[:, 1:3],
        est_xy=rows[:, 3:5],
        pose_cov=rows[:, 5:9].reshape(-1, 2, 2),
    )
