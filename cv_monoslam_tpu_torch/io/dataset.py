"""Dataset ingestion: odometry text parsing + image sequences.

Formats match the reference exactly so recorded TurtleBot runs drop in:
  * odometry text lines ``"<id> : <t> <x> <y> <theta>"`` (the reference scans
    ``"%d : %*lf %lf %lf %lf"``, SLAM.cpp:474-475);
  * image sequences named ``%04d.jpg`` indexed by odometry frame id
    (SLAM.cpp:306-308), or any printf-style pattern.

Preprocessing reproduces SLAM.cpp:363-519: rebase positions to the start
pose, drop rows whose |dx| and |dy| are both under ``min_step_xy``, and flag
"redirection" frames where |wrap(dtheta)| exceeds ``min_step_theta``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Iterator, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class OdometryTrack:
    """Preprocessed odometry, one row per *kept* frame."""

    frame_id: np.ndarray   # (N,) int  — image index for %04d patterns
    xy: np.ndarray         # (N, 2) float64, rebased to start at initial pose
    theta: np.ndarray      # (N,) float64
    redirect: np.ndarray   # (N,) bool — |dtheta| > min_step_theta (SLAM.cpp:434-445)

    def __len__(self) -> int:
        return len(self.frame_id)


def parse_odometry_text(text: str) -> np.ndarray:
    """Parse reference-format odometry text -> (N, 4) [id, x, y, theta].

    Line format: ``id : t x y theta`` (t is skipped, SLAM.cpp:474-475).
    """
    rows = []
    pat = re.compile(
        r"^\s*(\d+)\s*:\s*\S+\s+(-?[\d.eE+-]+)\s+(-?[\d.eE+-]+)\s+(-?[\d.eE+-]+)"
    )
    for line in text.splitlines():
        m = pat.match(line)
        if m:
            rows.append([float(m.group(1)), float(m.group(2)),
                         float(m.group(3)), float(m.group(4))])
    return np.asarray(rows, dtype=np.float64).reshape(-1, 4)


def wrap_angle(a):
    return np.arctan2(np.sin(a), np.cos(a))


def preprocess_odometry(
    raw: np.ndarray,
    min_step_xy: float = 0.01,
    min_step_theta: float = np.deg2rad(45.0),
    start: int = 0,
    capacity: int = 3000,
    init_pos: Sequence[float] = (0.0, 0.0),
) -> OdometryTrack:
    """raw: (N, 4) [id, x, y, theta] -> filtered, rebased OdometryTrack.

    Mirrors loadOdometryData/getOneMomentData (SLAM.cpp:363-496): the first
    kept row becomes the origin (positions rebased to ``init_pos``); later
    rows are kept only once either |dx| or |dy| from the previously-kept row
    reaches ``min_step_xy``. Redirection flags compare *kept-row* headings.
    """
    raw = raw[start:]
    if len(raw) == 0:
        raise ValueError("empty odometry")
    ids = [int(raw[0, 0])]
    xs = [init_pos[0]]
    ys = [init_pos[1]]
    thetas = [raw[0, 3]]
    x0, y0 = raw[0, 1], raw[0, 2]
    last_x, last_y = init_pos[0], init_pos[1]
    for i in range(1, len(raw)):
        x = init_pos[0] + (raw[i, 1] - x0)
        y = init_pos[1] + (raw[i, 2] - y0)
        if abs(x - last_x) < min_step_xy and abs(y - last_y) < min_step_xy:
            continue
        ids.append(int(raw[i, 0]))
        xs.append(x)
        ys.append(y)
        thetas.append(raw[i, 3])
        last_x, last_y = x, y
        if len(ids) > capacity:
            break
    theta = np.asarray(thetas)
    dtheta = np.abs(wrap_angle(np.diff(theta, prepend=theta[0])))
    redirect = dtheta > min_step_theta
    redirect[0] = False
    return OdometryTrack(
        frame_id=np.asarray(ids, dtype=np.int64),
        xy=np.stack([np.asarray(xs), np.asarray(ys)], axis=1),
        theta=theta,
        redirect=redirect,
    )


def load_odometry_file(path: str, **kw) -> OdometryTrack:
    with open(path) as f:
        return preprocess_odometry(parse_odometry_text(f.read()), **kw)


class ImageSequence:
    """Grayscale image provider.

    Either an in-memory array stack or a printf-pattern directory of images
    (``%04d.jpg``), decoded and converted to grayscale float32 in [0, 255] —
    the reference converts RGB->gray every frame (SLAM.cpp:542). JPEG files
    go through the native libjpeg decoder (``io/native.py``) when it builds,
    everything else through PIL.
    """

    def __init__(self, pattern: Optional[str] = None,
                 frames: Optional[np.ndarray] = None,
                 frame_ids: Optional[np.ndarray] = None):
        if (pattern is None) == (frames is None):
            raise ValueError("provide exactly one of pattern/frames")
        self._pattern = pattern
        self._frames = frames
        if frames is not None and frame_ids is None:
            frame_ids = np.arange(len(frames))
        self._index = (
            {int(fid): i for i, fid in enumerate(frame_ids)}
            if frame_ids is not None else None
        )

    def get(self, frame_id: int) -> np.ndarray:
        if self._frames is not None:
            return np.asarray(self._frames[self._index[int(frame_id)]],
                              dtype=np.float32)
        path = self._pattern % int(frame_id)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        if path.lower().endswith((".jpg", ".jpeg")):
            from . import native

            if native.available():   # C++ libjpeg decode
                return native.decode_jpeg_gray(path)
        from PIL import Image

        img = Image.open(path).convert("L")
        return np.asarray(img, dtype=np.float32)

    def iter_ids(self, ids: Sequence[int]) -> Iterator[np.ndarray]:
        for i in ids:
            yield self.get(i)

    def prefetch(self, ids: Sequence[int], width: int, height: int,
                 depth: int = 4) -> Iterator[np.ndarray]:
        """Iterate frames with background-thread decode when the native
        runtime is available (the C++ prefetcher decodes up to ``depth``
        frames ahead while the caller works); falls back to synchronous
        decode otherwise."""
        if (self._pattern is not None
                and self._pattern.lower().endswith((".jpg", ".jpeg"))):
            from . import native

            if native.available():
                pf = native.NativePrefetcher(self._pattern,
                                             np.asarray(ids, np.int64),
                                             width, height, depth)
                try:
                    while True:
                        frame = pf.next()
                        if frame is None:
                            return
                        yield frame
                finally:
                    pf.close()
                return
        yield from self.iter_ids(ids)
