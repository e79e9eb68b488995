"""Host-side session API: the engine analogue of the reference's GUI driver.

``SlamSession`` replaces CMonoSLAMView's STEP/AUTO buttons
(MonoSLAMView.cpp:499-572): feed frames one at a time (``step``) or run to
the end of the odometry track (``run``), collecting per-frame telemetry.

Each frame is one call of ``filter.srukf.slam_step`` on device tensors;
``step_chunk`` runs k frames as a Python loop, ships their images to the
device in one copy (uint8 when lossless, cast on the device) and fetches
their telemetry in one transfer (``_pack_row``).

Host syncs per frame. The JAX engine keeps its gates on the device
(``lax.cond``); here each gate is a Python ``if`` on a device scalar, so a
normal frame reads the device four times: the motion-predict Cholesky's
repair test, the joint-update Cholesky's repair test, update_features'
store/delete flags, and the detect-when-starved trigger. A detect frame
adds one (the integration Cholesky), every extra jitter rung one more, and
a frame that stores records one per record. Removing them (CUDA graphs
with device-side gates) is queued in ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from .config import SlamConfig
from .filter.srukf import initialize, slam_step
from .filter.state import (FilterState, init_state, resolve_device,
                           torch_dtype)
from .io.dataset import ImageSequence, OdometryTrack

# Telemetry packing: the per-frame outputs of slam_step are merged into ONE
# flat f32 row on the device, so a chunk pays one device->host transfer.
_SCALAR_FIELDS = 18          # pose 4 + sqrt_cov 4 + 3 counters + redirect
#                              + health 3 + repair counters 3


def _pack_row(out: dict, M: int) -> torch.Tensor:
    f32 = torch.float32
    return torch.cat([
        out["pose"].to(f32),
        out["pose_sqrt_cov"].to(f32),
        torch.stack([out["n_map"], out["n_visible"],
                     out["n_matched"]]).to(f32),
        out["redirected"].to(f32)[None],
        out["health"].to(f32),
        out["repairs"].to(f32),
        out["lm_lid"].to(f32),
        out["lm_active"].to(f32),
        out["lm_matched"].to(f32),
        out["lm_match_px"].reshape(-1).to(f32),
        out["lm_xyz"].reshape(-1).to(f32),
    ])


def _unpack_row(row: np.ndarray, M: int) -> dict:
    k = _SCALAR_FIELDS
    return dict(
        pose=row[0:4].astype(np.float64),
        pose_sqrt_cov=row[4:8].astype(np.float64),
        n_map=row[8], n_visible=row[9], n_matched=row[10],
        redirected=row[11],
        health=row[12:15] != 0.0,
        repairs=row[15:18].astype(np.int64),
        lm_lid=row[k:k + M].astype(np.int32),
        lm_active=row[k + M:k + 2 * M] != 0.0,
        lm_matched=row[k + 2 * M:k + 3 * M] != 0.0,
        lm_match_px=row[k + 3 * M:k + 5 * M].reshape(M, 2),
        lm_xyz=row[k + 5 * M:k + 8 * M].reshape(M, 3),
    )


@dataclasses.dataclass
class FrameRecord:
    frame: int
    pose: np.ndarray
    pose_sqrt_cov: np.ndarray
    n_map: int
    n_visible: int
    n_matched: int
    redirected: bool
    wall_time: float
    #: cumulative covariance-repair counters up to this frame: minor
    #: floors / escalated (reset-grade) repairs / skipped updates
    n_repairs: int = 0
    n_escalations: int = 0
    n_skipped: int = 0


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1: checkpoint, "
        f"watchdog recovery and the backend)")


class SlamSession:
    """One SLAM run over an image sequence + odometry track.

    Runs on ``cuda`` unless ``device`` names another device (the tests pass
    ``device="cpu"``); without a device and without CUDA it raises.
    """

    def __init__(self, cfg: SlamConfig, images: ImageSequence,
                 track: OdometryTrack, max_stored: int = 64,
                 recorder=None, checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 50, watchdog=None, backend=None,
                 device=None):
        if recorder is not None:
            raise _not_ported("the run recorder")
        if checkpoint_dir is not None:
            raise _not_ported("checkpointing")
        if watchdog is not None:
            raise _not_ported("watchdog recovery")
        if backend is not None:
            raise _not_ported("the BA / pose-graph backend")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.images = images
        self.track = track
        self.counter = 1                      # m_frame.counter semantics
        self.records: List[FrameRecord] = []
        self._dtype = torch_dtype(cfg.dtype)
        #: transport images as uint8 when lossless; decided from the first
        #: frame
        self._img_u8: Optional[bool] = None
        odo = np.concatenate([track.xy, track.theta[:, None]], axis=1)
        self._odo = torch.as_tensor(odo.astype(np.dtype(cfg.dtype)),
                                    device=self.device)
        self._redirect = np.asarray(track.redirect)

        state = init_state(cfg, theta0=float(track.theta[0]),
                           max_stored=max_stored, device=self.device)
        img0 = self._to_device(
            self._prep_image(self.images.get(int(track.frame_id[0]))))
        self.state: FilterState = initialize(state, img0, cfg)

    def _prep_image(self, img: np.ndarray) -> np.ndarray:
        if self._img_u8 is None:
            self._img_u8 = bool(
                img.min() >= 0 and img.max() <= 255
                and np.all(img == np.round(img)))
        if self._img_u8:
            return np.asarray(img, dtype=np.uint8)
        return np.asarray(img, dtype=np.dtype(self.cfg.dtype))

    def _to_device(self, img: np.ndarray) -> torch.Tensor:
        """Host frame(s) -> device tensor in the filter dtype (a uint8 frame
        crosses as uint8 and is cast on the device)."""
        return torch.as_tensor(img).to(self.device).to(self._dtype)

    def _record(self, k: int, tele: dict, wall: float) -> FrameRecord:
        rec = FrameRecord(
            frame=k, pose=tele["pose"], pose_sqrt_cov=tele["pose_sqrt_cov"],
            n_map=int(tele["n_map"]), n_visible=int(tele["n_visible"]),
            n_matched=int(tele["n_matched"]),
            redirected=bool(tele["redirected"]), wall_time=wall,
            n_repairs=int(tele["repairs"][0]),
            n_escalations=int(tele["repairs"][1]),
            n_skipped=int(tele["repairs"][2]))
        self.records.append(rec)
        return rec

    def step(self) -> Optional[FrameRecord]:
        k = self.counter
        if k >= len(self.track):
            return None
        t0 = time.perf_counter()
        img = self._to_device(
            self._prep_image(self.images.get(int(self.track.frame_id[k]))))
        self.state, out = slam_step(self.state, img, self._odo[k - 1],
                                    self._odo[k], bool(self._redirect[k]),
                                    self.cfg)
        row = _pack_row(out, self.cfg.max_landmarks).cpu().numpy()
        rec = self._record(k, _unpack_row(row, self.cfg.max_landmarks),
                           time.perf_counter() - t0)
        self.counter += 1
        return rec

    def step_chunk(self, k: int) -> List[FrameRecord]:
        """Process up to ``k`` frames with one image upload and one
        telemetry fetch. Frames up to a redirection frame are single-stepped
        instead (the redirection branch itself raises: not ported)."""
        k = min(k, len(self.track) - self.counter)
        if k <= 0:
            return []
        ks = self.counter
        if self._redirect[ks]:
            rec = self.step()
            return [rec] if rec is not None else []
        nxt = np.flatnonzero(self._redirect[ks:ks + k])
        if nxt.size:
            recs = []
            for _ in range(int(nxt[0])):
                rec = self.step()
                if rec is None:
                    break
                recs.append(rec)
            return recs
        t0 = time.perf_counter()
        M = self.cfg.max_landmarks
        imgs = self._to_device(np.stack([
            self._prep_image(self.images.get(int(self.track.frame_id[i])))
            for i in range(ks, ks + k)]))
        rows = []
        for i in range(k):
            self.state, out = slam_step(
                self.state, imgs[i], self._odo[ks + i - 1], self._odo[ks + i],
                False, self.cfg)
            rows.append(_pack_row(out, M))
        rows = torch.stack(rows).cpu().numpy()
        wall = (time.perf_counter() - t0) / k
        recs = [self._record(ks + i, _unpack_row(rows[i], M), wall)
                for i in range(k)]
        self.counter += k
        return recs

    def run(self, n_frames: Optional[int] = None, chunk: int = 1,
            drop_tail: bool = False) -> np.ndarray:
        """AUTO mode: run to the end (or n_frames); returns (T, 4) poses.

        ``chunk > 1`` processes that many frames per :meth:`step_chunk`;
        ``drop_tail`` stops before an incomplete final chunk instead of
        single-stepping it."""
        n = (len(self.track) - self.counter if n_frames is None
             else n_frames)
        done = 0
        while done < n and self.counter < len(self.track):
            ks = self.counter
            full = (chunk > 1 and n - done >= chunk
                    and ks + chunk <= len(self.track)
                    and not self._redirect[ks:ks + chunk].any())
            if full:
                done += len(self.step_chunk(chunk))
                continue
            if chunk > 1 and drop_tail and not self._redirect[ks]:
                break
            if self.step() is None:
                break
            done += 1
        return self.trajectory

    @property
    def trajectory(self) -> np.ndarray:
        return np.stack([r.pose for r in self.records]) if self.records \
            else np.zeros((0, 4))

    def ate(self, gt_xy: np.ndarray) -> float:
        """RMSE of estimated vs ground-truth (x, y) per processed frame.

        ``gt_xy`` is indexed by RAW frame id (the odometry file's image
        index), so frames dropped by the min-step filter are skipped
        consistently (SLAM.cpp:419-432)."""
        ids = [int(self.track.frame_id[r.frame]) for r in self.records]
        err = self.trajectory[:, :2] - gt_xy[ids]
        return float(np.sqrt((err ** 2).sum(axis=1).mean()))
