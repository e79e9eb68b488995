"""Synthetic ceiling-world generator (NumPy).

The reference ships no dataset (only a robot photo), so parity and benchmarks
are measured on a synthetic world: a textured ceiling plane at height
``deep`` above a ground-driving robot with an upward camera, rendered through
*exactly* the reference camera model (including its axis conventions — see
:mod:`cv_monoslam_tpu_torch.geometry.camera`), plus scripted trajectories
and odometry with optional noise in the reference text format.

This module is deliberately NumPy-only and independent from the torch
geometry code so that tests cross-check the two implementations.
:func:`get_sequence` renders a sequence once and caches it on disk.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import zipfile
from typing import Tuple

import numpy as np

from ..config import CameraConfig, SlamConfig
from .dataset import ImageSequence, OdometryTrack, preprocess_odometry


@dataclasses.dataclass
class SyntheticWorld:
    cam: CameraConfig
    deep: float                  # ceiling height above camera plane (m)
    blobs: np.ndarray            # (K, 4): wx, wy, sigma, amplitude
    base: float = 40.0

    def texture(self, wx: np.ndarray, wy: np.ndarray) -> np.ndarray:
        """Intensity of the ceiling at world (wx, wy), Gaussian-blob field.

        Evaluated in row chunks with per-chunk blob culling (blob support is
        4*sigma <= 0.3 m) so a 640x480 frame renders in well under a second.
        """
        out = np.full(wx.shape, self.base, dtype=np.float64)
        flat_x = wx.reshape(-1)
        flat_y = wy.reshape(-1)
        flat_o = out.reshape(-1)
        chunk = 64 * 640
        margin = 0.5
        for s in range(0, flat_x.size, chunk):
            fx = flat_x[s : s + chunk]
            fy = flat_y[s : s + chunk]
            sel = (
                (self.blobs[:, 0] >= fx.min() - margin)
                & (self.blobs[:, 0] <= fx.max() + margin)
                & (self.blobs[:, 1] >= fy.min() - margin)
                & (self.blobs[:, 1] <= fy.max() + margin)
            )
            blobs = self.blobs[sel]
            if not len(blobs):
                continue
            d2 = ((fx[:, None] - blobs[:, 0]) ** 2
                  + (fy[:, None] - blobs[:, 1]) ** 2)
            flat_o[s : s + chunk] += np.exp(
                -d2 / (2.0 * blobs[:, 2] ** 2)
            ) @ blobs[:, 3]
        return np.clip(out, 0.0, 255.0)

    def render(self, cam_xy: np.ndarray, theta: float) -> np.ndarray:
        """Render one grayscale frame from robot pose (x, y, theta).

        Inverts the projection chain of the measurement model: pixel ->
        undistort -> camera ray (v pairs with camera X via cx/f1, u with
        camera Y via cy/f2) -> world ray via R_wc(theta) -> intersect the
        z=deep plane -> sample texture.
        """
        cam = self.cam
        u, v = np.meshgrid(
            np.arange(cam.width, dtype=np.float64),
            np.arange(cam.height, dtype=np.float64),
            indexing="xy",
        )
        # closed-form undistort (SLAM.cpp:3224-3236 semantics)
        xd = (u - cam.cx) * cam.dx
        yd = (v - cam.cy) * cam.dy
        rd2 = xd * xd + yd * yd
        d = 1.0 + cam.k1 * rd2 + cam.k2 * rd2 * rd2
        uu = cam.cx + xd * d / cam.dx
        vu = cam.cy + yd * d / cam.dy
        # camera ray (reference image2camera, SLAM.cpp:3360-3363)
        X = (vu - cam.cx) / cam.f1
        Y = (uu - cam.cy) / cam.f2
        c, s = np.cos(theta), np.sin(theta)
        wx_dir = c * X - s * Y
        wy_dir = s * X + c * Y
        t = self.deep  # Z component of the ray is 1 -> scale = deep / 1
        wx = cam_xy[0] + t * wx_dir
        wy = cam_xy[1] + t * wy_dir
        return self._stamp(wx, wy, cam_xy, c, s).astype(np.float32)

    def _stamp(self, wx: np.ndarray, wy: np.ndarray, cam_xy: np.ndarray,
               c: float, s: float) -> np.ndarray:
        """Blob-stamped rendering: evaluate each blob's EXACT world-space
        Gaussian only over its 5-sigma pixel box (located by projecting
        the blob center through the inverse of the pixel->world map).

        Identical to the dense ``texture`` evaluation up to the 5-sigma
        support cutoff (< 1e-4 gray levels) but O(blobs x box) instead of
        O(pixels x blobs): a dense grid world rendered at ~25 s/frame the
        dense way and renders at ~0.05 s/frame here — the difference
        between a 3000-frame longrun being possible and not."""
        cam = self.cam
        t = self.deep
        out = np.full(wx.shape, self.base, dtype=np.float64)
        H, W = out.shape
        bx, by, sig, amp = (self.blobs[:, i] for i in range(4))
        # world -> undistorted (mirrors render()'s mixed axis pairing)
        X = (c * (bx - cam_xy[0]) + s * (by - cam_xy[1])) / t
        Y = (-s * (bx - cam_xy[0]) + c * (by - cam_xy[1])) / t
        vu = cam.cx + cam.f1 * X
        uu = cam.cy + cam.f2 * Y
        # invert the radial distortion factor d(rd2) by fixed point
        # (k1*r^2 ~ 1e-4 here: converges in one step, run three)
        ru2 = ((uu - cam.cx) * cam.dx) ** 2 + ((vu - cam.cy) * cam.dy) ** 2
        rd2 = ru2.copy()
        for _ in range(3):
            dd = 1.0 + cam.k1 * rd2 + cam.k2 * rd2 * rd2
            rd2 = ru2 / (dd * dd)
        dd = 1.0 + cam.k1 * rd2 + cam.k2 * rd2 * rd2
        u0 = cam.cx + (uu - cam.cx) / dd
        v0 = cam.cy + (vu - cam.cy) / dd
        # 5-sigma support in pixels (f1 ~ f2; +3 px slack for distortion)
        half = np.ceil(5.0 * sig * cam.f1 / t).astype(int) + 3
        inview = ((u0 > -half) & (u0 < W + half)
                  & (v0 > -half) & (v0 < H + half))
        for i in np.flatnonzero(inview):
            lo_u = max(int(u0[i]) - half[i], 0)
            hi_u = min(int(u0[i]) + half[i] + 1, W)
            lo_v = max(int(v0[i]) - half[i], 0)
            hi_v = min(int(v0[i]) + half[i] + 1, H)
            if lo_u >= hi_u or lo_v >= hi_v:
                continue
            d2 = ((wx[lo_v:hi_v, lo_u:hi_u] - bx[i]) ** 2
                  + (wy[lo_v:hi_v, lo_u:hi_u] - by[i]) ** 2)
            out[lo_v:hi_v, lo_u:hi_u] += amp[i] * np.exp(
                -d2 / (2.0 * sig[i] ** 2))
        return np.clip(out, 0.0, 255.0)


def make_world(seed: int = 0, extent: float = 12.0, blob_density: float = 18.0,
               cfg: SlamConfig | None = None) -> SyntheticWorld:
    """Random blob ceiling over [-extent/2, extent/2]^2, ~blob_density per m^2."""
    cfg = cfg or SlamConfig()
    rng = np.random.default_rng(seed)
    n = int(blob_density * extent * extent)
    pos = rng.uniform(-extent / 2, extent / 2, size=(n, 2))
    sig = rng.uniform(0.03, 0.07, size=(n, 1))
    amp = rng.uniform(60.0, 200.0, size=(n, 1))
    return SyntheticWorld(cam=cfg.camera, deep=cfg.deep,
                          blobs=np.concatenate([pos, sig, amp], axis=1))


def make_world_periodic(seed: int = 0, extent: float = 8.0,
                        spacing: float = 0.08, jitter: float = 0.006,
                        cfg: SlamConfig | None = None) -> SyntheticWorld:
    """REPETITIVE ceiling: a near-regular blob grid (acoustic-tile /
    perforated-panel ceilings). At deep=3 m / f~776 px, ``spacing`` of
    ~8 cm projects to ~20 px — neighbouring blobs fall INSIDE the active-
    search window, so NCC matching aliases under odometry error. The
    adversarial fixture for the 1-point RANSAC (repetitive texture is the
    mis-association source the reference's commented-out RANSAC branch
    targets, SLAM.cpp:2097-2103)."""
    cfg = cfg or SlamConfig()
    rng = np.random.default_rng(seed)
    k = int(extent / spacing)
    gx, gy = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
    pos = (np.stack([gx, gy], axis=-1).reshape(-1, 2) * spacing
           - extent / 2.0)
    pos = pos + rng.normal(0, jitter, pos.shape)
    n = len(pos)
    sig = np.full((n, 1), 0.018)
    amp = rng.uniform(140.0, 180.0, size=(n, 1))
    return SyntheticWorld(cam=cfg.camera, deep=cfg.deep,
                          blobs=np.concatenate([pos, sig, amp], axis=1))


def make_trajectory(kind: str = "arc", n: int = 60, step: float = 0.03,
                    turn_rate: float = 0.008) -> Tuple[np.ndarray, np.ndarray]:
    """Ground-truth robot path: xy (n, 2), theta (n,)."""
    theta = np.zeros(n)
    xy = np.zeros((n, 2))
    for i in range(1, n):
        if kind == "straight":
            dth = 0.0
        elif kind == "arc":
            dth = turn_rate
        elif kind == "square":
            # sharp 90-degree turns every n//4 steps -> exercises redirection
            dth = (np.pi / 2) if (i % max(n // 4, 1) == 0) else 0.0
        elif kind == "loop":
            # full circle returning to the start: early landmarks re-enter
            # the view on the final frames -> exercises loop closure
            dth = 2.0 * np.pi / n
        elif kind == "lap":
            # 1.25 laps of a circle: the last quarter RE-TRAVERSES the
            # first quarter, so several keyframes live in the revisited
            # region — the loop-closure bench trajectory (with step large
            # enough that the circle diameter exceeds the ~2.4 m camera
            # ceiling footprint, mid-run views are disjoint from the start)
            dth = 2.5 * np.pi / n
        else:
            raise ValueError(kind)
        theta[i] = theta[i - 1] + dth
        xy[i] = xy[i - 1] + step * np.array(
            [np.cos(theta[i]), np.sin(theta[i])]
        )
    return xy, theta


def noisy_odometry(gt_xy, gt_th, rng, sigma_rot=0.0, sigma_trans_rel=0.02):
    """Control-space odometry noise: heading random-walk + relative step
    noise, integrated — smooth self-consistent drift like real encoders
    (position-jitter models make atan2-derived headings explode)."""
    n = len(gt_th)
    odo_xy = np.zeros_like(gt_xy)
    odo_th = gt_th.copy()
    odo_xy[0] = gt_xy[0]
    phi = 0.0
    for k in range(1, n):
        d = gt_xy[k] - gt_xy[k - 1]
        phi += rng.normal(0, sigma_rot)
        c, s = np.cos(phi), np.sin(phi)
        dn = np.array([c * d[0] - s * d[1], s * d[0] + c * d[1]])
        if sigma_rot > 0:
            dn = dn * (1 + rng.normal(0, sigma_trans_rel))
        odo_xy[k] = odo_xy[k - 1] + dn
        odo_th[k] = gt_th[k] + phi
    return odo_xy, odo_th


def make_sequence(
    world: SyntheticWorld,
    xy: np.ndarray,
    theta: np.ndarray,
    odo_noise_xy: float = 0.0,
    odo_noise_theta: float = 0.0,
    seed: int = 1,
    cfg: SlamConfig | None = None,
):
    """Render frames + build odometry for a trajectory.

    Returns (ImageSequence, OdometryTrack, gt_xy, gt_theta). Odometry noise is
    a random walk added to the true pose (the filter sees the noisy track; ATE
    is evaluated against the true one).
    """
    cfg = cfg or SlamConfig()
    rng = np.random.default_rng(seed)
    n = len(theta)
    frames = np.stack(
        [world.render(xy[i], theta[i]) for i in range(n)], axis=0
    )
    walk_xy = np.cumsum(rng.normal(0, odo_noise_xy, size=(n, 2)), axis=0)
    walk_th = np.cumsum(rng.normal(0, odo_noise_theta, size=n), axis=0)
    raw = np.concatenate(
        [
            np.arange(n, dtype=np.float64)[:, None],
            xy + walk_xy,
            (theta + walk_th)[:, None],
        ],
        axis=1,
    )
    track = preprocess_odometry(
        raw,
        min_step_xy=cfg.min_step_xy,
        min_step_theta=cfg.min_step_theta,
    )
    seq = ImageSequence(frames=frames, frame_ids=np.arange(n))
    return seq, track, xy, theta


#: rendered-sequence cache, shared with the JAX package's experiment
#: harness: same directory, same keys, same file layout, so a sequence one
#: package rendered serves the other
CACHE = os.path.join(os.path.dirname(__file__), "..", "..", ".cache", "seq")


def get_sequence(kind: str, n: int, seed: int, noise: float = 0.0,
                 step: float = 0.03):
    """Cached synthetic sequence: ``(ImageSequence, OdometryTrack, gt_xy,
    gt_th)``. ``kind`` may carry a step suffix (e.g. ``"loop@0.06"``) so
    revisit-scale trajectories — where the camera footprint (~2.4 m at
    deep=3) must NOT cover the whole path — get distinct cache entries."""
    if "@" in kind:
        kind, s = kind.split("@")
        step = float(s)
    os.makedirs(CACHE, exist_ok=True)
    key = hashlib.md5(
        f"{kind}-{n}-{seed}-{noise}-{step}-v4".encode()).hexdigest()[:16]
    path = os.path.join(CACHE, key + ".npz")
    cfg = SlamConfig()
    if os.path.exists(path):
        try:
            with np.load(path) as d:
                frames, raw, gt_xy, gt_th = (d["frames"], d["raw"],
                                             d["gt_xy"], d["gt_th"])
        except (OSError, ValueError, EOFError, KeyError, zipfile.BadZipFile):
            pass      # another process is still writing it: render anew
        else:
            track = preprocess_odometry(raw, min_step_xy=cfg.min_step_xy,
                                        min_step_theta=cfg.min_step_theta)
            return ImageSequence(frames=frames), track, gt_xy, gt_th
    world = make_world(seed=seed, cfg=cfg)
    xy, th = make_trajectory(kind, n=n, step=step)
    seq, _, gt_xy, gt_th = make_sequence(world, xy, th, cfg=cfg)
    odo_xy, odo_th = noisy_odometry(
        xy, th, np.random.default_rng(seed + 1), sigma_rot=noise)
    raw = np.concatenate([
        np.arange(n, dtype=np.float64)[:, None], odo_xy,
        odo_th[:, None]], axis=1)
    # through a file of this process and a rename, so a reader in another
    # process (either package) never opens a half-written file
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, frames=seq._frames, raw=raw, gt_xy=gt_xy,
                            gt_th=gt_th)
    os.replace(tmp, path)
    track = preprocess_odometry(raw, min_step_xy=cfg.min_step_xy,
                                min_step_theta=cfg.min_step_theta)
    return seq, track, gt_xy, gt_th
