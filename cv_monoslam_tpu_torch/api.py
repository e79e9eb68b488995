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
a frame that stores records one per record. Under ``sigma_mode="implicit"``
the motion predict factorizes nothing (its sync goes), and with
``cfg.gate_detection`` off the detect trigger is a mask on the device (its
sync goes too; ``detect_host_gate`` decides per chunk from telemetry the
host already holds). Removing them (CUDA graphs
with device-side gates) is queued in ROADMAP.md.

Per-frame host side effects (``_post_frame``) read only the telemetry the
chunk already fetched: the run recorder (``io.recording.RunRecorder``), the
watchdog, periodic checkpoints, and the keyframe backend
(``backend.session.BackendSession``), whose solvers run on their own device
tensors once per keyframe and never feed back into the filter
(``trajectory_refined`` composes their corrections afterwards). A keyframe
costs the host one upload of the window or graph and one fetch of the solve.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import List, Optional

import numpy as np
import torch

from .config import SlamConfig
from .filter.srukf import initialize, slam_step
from .filter.state import (FilterState, init_state, resolve_device,
                           torch_dtype)
from .io.dataset import ImageSequence, OdometryTrack
from .io.recording import RunRecorder
from .utils.checkpoint import load_checkpoint, save_checkpoint
from .utils.profiling import FrameTimer
from .utils.watchdog import Watchdog

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


class SlamSession:
    """One SLAM run over an image sequence + odometry track.

    Runs on ``cuda`` unless ``device`` names another device (the tests pass
    ``device="cpu"``); without a device and without CUDA it raises.
    """

    def __init__(self, cfg: SlamConfig, images: ImageSequence,
                 track: OdometryTrack, max_stored: int = 64,
                 recorder: Optional[RunRecorder] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 50,
                 watchdog: Optional[Watchdog] = None, backend=None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.images = images
        self.track = track
        self.counter = 1                      # m_frame.counter semantics
        self.records: List[FrameRecord] = []
        self.recorder = recorder
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.watchdog = watchdog
        #: a ``BackendSession`` (keyframes, window BA, pose graph), or a
        #: ``TelemetryCapture`` standing in for one
        self.backend = backend
        #: one dict per backend solve, in order (window BA or pose graph)
        self.refinements: List[dict] = []
        self.timer = FrameTimer()
        #: chunk-level detect-when-starved gating: a chunk runs the
        #: detection pipeline only when the latest match count seen is
        #: below ``min_num`` (the reference's trigger, SLAM.cpp:552-562,
        #: decided once per chunk). Off by default: single steps and
        #: ``cfg.gate_detection`` keep exact per-frame semantics;
        #: large-state configs enable it.
        self.detect_host_gate = False
        #: ``None``: each chunk's gate reads the match count at the end of
        #: the chunk before it. An int margin M selects the pipelined
        #: cadence of :meth:`run`: the gate of a chunk reads the count at
        #: the end of the chunk before the previous one (one chunk stale),
        #: and detection triggers at matched < min_num + M to absorb the
        #: staleness. M = 0 accepts the stale gate with no cushion: sound
        #: only when the config hovers far above true starvation, never at
        #: the reference-default min_num = 5 (run() warns).
        self.detect_gate_margin: Optional[int] = None
        self._last_matched = 0            # latest n_matched seen
        #: match count of a finished chunk that the pipelined cadence has
        #: not let the gate see yet
        self._deferred_matched: Optional[int] = None
        #: the detect flag of every chunk run so far
        self.chunk_detect: List[bool] = []
        self._dtype = torch_dtype(cfg.dtype)
        #: transport images as uint8 when lossless; decided from the first
        #: frame
        self._img_u8: Optional[bool] = None
        #: odometry rows (x, y, theta) in the filter dtype: on the host for
        #: the per-frame observers, on the device for the filter
        self._odo_host = np.concatenate(
            [track.xy, track.theta[:, None]], axis=1).astype(
                np.dtype(cfg.dtype))
        self._odo = torch.as_tensor(self._odo_host, device=self.device)
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

    def _post_frame(self, rec: FrameRecord, tele: dict) -> None:
        """Recording, health checks, periodic checkpoints, keyframes.

        ``tele`` is the frame's telemetry (numpy, already on the host);
        single steps and chunks both route every frame through here, so
        recording stays per frame (the reference records every frame,
        SLAM.cpp:3512-3562). A recovery after a chunk acts on the state at
        the chunk's end."""
        if self.recorder is not None:
            sc = rec.pose_sqrt_cov[:2]
            self.recorder.record_frame(
                rec.frame,
                odo_xy=self._odo_host[rec.frame, :2],
                pose=rec.pose,
                pose_cov2=np.diag(sc * sc),
                lids=tele["lm_lid"],
                xyz=tele["lm_xyz"],
                valid=tele["lm_active"],
                n_map=rec.n_map, n_visible=rec.n_visible,
                n_matched=rec.n_matched, redirected=rec.redirected,
                wall_time=rec.wall_time,
            )
        if (self.watchdog is not None
                and self.watchdog.should_check(rec.frame)):
            report = self.watchdog.check_flags(tele["health"])
            if not report.ok:
                self.state = self.watchdog.recover(
                    self.state, float(self._odo_host[rec.frame, 2]))
        if (self.checkpoint_dir is not None
                and rec.frame % self.checkpoint_every == 0):
            self.save_checkpoint()
        if self.backend is not None:
            n_loops = len(self.backend.loop_edges)
            kf = self.backend.maybe_add_telemetry(
                rec.frame, tele["pose"], self._odo_host[rec.frame],
                tele["lm_lid"], tele["lm_matched"], tele["lm_match_px"],
                tele["lm_xyz"], pose_sqrt_cov=tele["pose_sqrt_cov"],
                active=tele["lm_active"])
            if kf is not None and len(self.backend.keyframes) >= 2:
                if len(self.backend.loop_edges) > n_loops:
                    # a loop edge appeared: global pose-graph relaxation
                    # (the engine's real loop closure — the analogue of the
                    # reference's redirection splice, SLAM.cpp:948-1015)
                    out = self.backend.optimize_graph()
                else:
                    out = self.backend.refine_window()
                if out is not None:
                    self.refinements.append(out)

    def save_checkpoint(self) -> str:
        path = os.path.join(self.checkpoint_dir,
                            f"ckpt_{self.counter:06d}.npz")
        save_checkpoint(path, self.state, self.counter, self.cfg)
        return path

    @classmethod
    def resume(cls, ckpt_path: str, images: ImageSequence,
               track: OdometryTrack, **kw) -> "SlamSession":
        """Rebuild a session from a checkpoint, on the device ``kw`` names
        (``cuda`` by default, as for a new session)."""
        state, counter, cfg, _ = load_checkpoint(ckpt_path,
                                                 device=kw.get("device"))
        sess = cls(cfg, images, track, **kw)
        sess.state = state
        sess.counter = counter
        return sess

    def step(self) -> Optional[FrameRecord]:
        k = self.counter
        if k >= len(self.track):
            return None
        self.timer.start()
        img = self._to_device(
            self._prep_image(self.images.get(int(self.track.frame_id[k]))))
        self.state, out = slam_step(self.state, img, self._odo[k - 1],
                                    self._odo[k], bool(self._redirect[k]),
                                    self.cfg)
        row = _pack_row(out, self.cfg.max_landmarks).cpu().numpy()
        tele = _unpack_row(row, self.cfg.max_landmarks)
        rec = self._record(k, tele, self.timer.stop())
        self.counter += 1
        self._flush_gate()
        self._last_matched = rec.n_matched
        self._post_frame(rec, tele)
        return rec

    def _flush_gate(self) -> None:
        """Let the gate see the last finished chunk's match count."""
        if self._deferred_matched is not None:
            self._last_matched = self._deferred_matched
            self._deferred_matched = None

    def step_chunk(self, k: int, *,
                   defer_gate: bool = False) -> List[FrameRecord]:
        """Process up to ``k`` frames with one image upload and one
        telemetry fetch. Frames up to and including a redirection frame are
        single-stepped instead.

        With ``detect_host_gate`` the whole chunk runs with or without the
        detection pipeline, decided from the latest match count the gate has
        seen. ``defer_gate`` (the pipelined cadence of :meth:`run`) keeps
        this chunk's count from the gate until the next chunk has been
        decided."""
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
        detect = True
        if self.detect_host_gate:
            detect = self._last_matched < (
                self.cfg.min_num + (self.detect_gate_margin or 0))
        self.chunk_detect.append(detect)
        self._flush_gate()
        t0 = time.perf_counter()
        M = self.cfg.max_landmarks
        imgs = self._to_device(np.stack([
            self._prep_image(self.images.get(int(self.track.frame_id[i])))
            for i in range(ks, ks + k)]))
        rows = []
        for i in range(k):
            self.state, out = slam_step(
                self.state, imgs[i], self._odo[ks + i - 1], self._odo[ks + i],
                False, self.cfg, allow_detect=detect)
            rows.append(_pack_row(out, M))
        rows = torch.stack(rows).cpu().numpy()
        wall = self.timer.record(time.perf_counter() - t0, frames=k) / k
        self.counter += k
        recs = []
        for i in range(k):
            tele = _unpack_row(rows[i], M)
            recs.append(self._record(ks + i, tele, wall))
            self._post_frame(recs[-1], tele)
        if defer_gate:
            self._deferred_matched = recs[-1].n_matched
        else:
            self._last_matched = recs[-1].n_matched
        return recs

    def run(self, n_frames: Optional[int] = None, chunk: int = 1,
            drop_tail: bool = False) -> np.ndarray:
        """AUTO mode: run to the end (or n_frames); returns (T, 4) poses.

        ``chunk > 1`` processes that many frames per :meth:`step_chunk`;
        ``drop_tail`` stops before an incomplete final chunk instead of
        single-stepping it.

        Host-gated detection (``detect_host_gate``) follows the JAX
        session's cadence chunk for chunk. That session overlaps chunk
        i + 1's device work with chunk i's telemetry fetch whenever no
        watchdog and no backend is attached and either the gate is off or
        ``detect_gate_margin`` is set; the gate of chunk i + 1 then reads
        the match count at the end of chunk i - 1. Nothing is overlapped
        here (the frame loop syncs with the host anyway), but each chunk's
        detect flag is the one that cadence picks."""
        n = (len(self.track) - self.counter if n_frames is None
             else n_frames)
        stale_gate = (self.watchdog is None and self.backend is None
                      and self.detect_host_gate
                      and self.detect_gate_margin is not None)
        if (stale_gate and chunk > 1
                and self.detect_gate_margin < chunk
                and self.cfg.min_num <= self.cfg.max_new_per_frame):
            # margin below the per-chunk staleness AND a min_num small
            # enough that one starved stretch can drop the map below
            # redetection's reach (reference-default min_num=5 regime)
            warnings.warn(
                f"host-gated detection one chunk stale with margin "
                f"{self.detect_gate_margin} < chunk {chunk} at "
                f"min_num={self.cfg.min_num}: the stale gate can run "
                f"starved for up to 2*chunk frames with no cushion",
                stacklevel=2)
        done = 0
        while done < n and self.counter < len(self.track):
            ks = self.counter
            # (a window cut short by the end of the track runs as one
            # shorter chunk)
            full = (chunk > 1 and n - done >= chunk
                    and not self._redirect[ks:ks + chunk].any())
            if full:
                done += len(self.step_chunk(chunk, defer_gate=stale_gate))
                continue
            if chunk > 1 and drop_tail and not self._redirect[ks]:
                break
            if self.step() is None:
                break
            done += 1
        self._flush_gate()
        return self.trajectory

    @property
    def trajectory(self) -> np.ndarray:
        return np.stack([r.pose for r in self.records]) if self.records \
            else np.zeros((0, 4))

    @property
    def trajectory_refined(self) -> np.ndarray:
        """Trajectory with backend (BA / pose-graph) keyframe corrections.

        Each frame's filter pose is re-anchored to the latest refined
        keyframe at or before it: the filter's relative motion since that
        keyframe is composed onto the keyframe's optimized pose — the
        engine analogue of the reference splicing loop corrections back
        into the live state (SLAM.cpp:948-1015). Frames before the first
        keyframe are returned unchanged. Host numpy only."""
        traj = self.trajectory.copy()
        if self.backend is None or not self.backend.keyframes:
            return traj
        kfs = sorted(self.backend.keyframes, key=lambda f: f.frame)
        kf_frames = np.array([f.frame for f in kfs])
        for t, rec in enumerate(self.records):
            j = int(np.searchsorted(kf_frames, rec.frame, side="right")) - 1
            if j < 0:
                continue
            kf = kfs[j]
            # IMMUTABLE filter pose at keyframe time (pose0 is the BA
            # anchor and gets rebased by loop corrections — composing the
            # live filter pose against a rebased anchor double-applies
            # the correction)
            p0 = getattr(kf, "pose_filter", kf.pose0)
            pr = kf.pose                      # refined pose
            # relative SE(2) motion since the keyframe, in the kf frame
            c0, s0 = np.cos(p0[2]), np.sin(p0[2])
            d = rec.pose[[0, 1]] - p0[:2]
            rel = np.array([c0 * d[0] + s0 * d[1], -s0 * d[0] + c0 * d[1]])
            dth = rec.pose[3] - p0[2]
            cr, sr = np.cos(pr[2]), np.sin(pr[2])
            traj[t, 0] = pr[0] + cr * rel[0] - sr * rel[1]
            traj[t, 1] = pr[1] + sr * rel[0] + cr * rel[1]
            traj[t, 3] = pr[2] + dth
        return traj

    def ate(self, gt_xy: np.ndarray, refined: bool = False) -> float:
        """RMSE of estimated vs ground-truth (x, y) per processed frame
        (``refined``: of :attr:`trajectory_refined`).

        ``gt_xy`` is indexed by RAW frame id (the odometry file's image
        index), so frames dropped by the min-step filter are skipped
        consistently (SLAM.cpp:419-432)."""
        ids = [int(self.track.frame_id[r.frame]) for r in self.records]
        traj = self.trajectory_refined if refined else self.trajectory
        err = traj[:, :2] - gt_xy[ids]
        return float(np.sqrt((err ** 2).sum(axis=1).mean()))
