"""Host-side session API: the engine analogue of the reference's GUI driver.

``SlamSession`` replaces CMonoSLAMView's STEP/AUTO buttons
(MonoSLAMView.cpp:499-572): feed frames one at a time (``step``) or run to
the end of the odometry track (``run``), collecting per-frame telemetry.

Each frame is one call of ``filter.srukf.slam_step``. A chunk of k frames
has the JAX session's machinery, name for name (``cv_monoslam_tpu/api.py``):

* ``_chunk_fn(k, detect)``: on the card, k calls of ``slam_step`` plus
  ``_pack_row`` captured as ONE ``torch.cuda.CUDAGraph`` per ``(k,
  detect)`` key (the JAX package's ``jax.jit(lax.scan(...))``), every gate
  of the frame a conditional node on the device (``ops/control.py``), so a
  replay reads nothing back to the host. It reads static inputs (the
  session's state buffers, the (k, H, W) window, the k + 1 odometry rows)
  and writes static outputs (the state buffers, the (k, row) telemetry).
  A warm-up frame runs eagerly on a side stream before each capture, with
  both sides of every gate; all of a session's graphs share one memory
  pool (they never run at once). A failed capture or replay raises: there
  is no fallback.
* ``_dispatch_chunk``: the detect decision, the window into the static
  buffer, the replay, the telemetry's copy into pinned host memory behind
  an event, the next window's prefetch, the counter; no host sync.
* ``_finish_chunk``: waits on that event, unpacks the rows, runs the
  per-frame host side effects (``_post_frame``).
* ``_prefetch_images``: the next window into pinned memory and onto the
  device on a side stream while the current chunk runs.
* ``run``: dispatches chunk i + 1 before it finishes chunk i whenever no
  watchdog and no backend is attached and either the detect gate is off or
  ``detect_gate_margin`` is set (the gate then reads the match count one
  chunk stale).

The eager route (the same ``slam_step`` calls, each gate read on the host)
runs a chunk instead when the config asks for a mode the graphs do not
cover (``sigma_mode`` other than ``"full"`` / ``"implicit"``, ``update_mode``
or ``qr_mode`` other than ``"gram"``), under an ambient mesh
(``ops.linalg.AMBIENT``, the ``parallel/`` paths), on the CPU, or when the
private switch ``_graphs`` is off. Single ``step()`` calls, which also take
every redirection frame, are eager, as the JAX session single-steps them.

Per-frame host side effects (``_post_frame``) read only the telemetry the
chunk already fetched: the run recorder (``io.recording.RunRecorder``), the
watchdog, periodic checkpoints, and the keyframe backend
(``backend.session.BackendSession``), whose solvers run on their own device
tensors once per keyframe and never feed back into the filter
(``trajectory_refined`` composes their corrections afterwards). A keyframe
costs the host one upload of the window or graph and one fetch of the solve.

After a graph chunk ``state`` IS the session's static state buffers: the
next chunk overwrites them in place (clone what must be kept). A state the
caller (``resume``, a watchdog recovery) or an eager step puts there is
copied into the buffers by the next graph chunk.
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
from .ops import control
from .ops.linalg import AMBIENT
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
class _ChunkGraph:
    """One captured chunk: the graph, its static inputs (the (k, H, W)
    window in the transport dtype, the k + 1 odometry rows) and output (the
    (k, row) telemetry)."""
    graph: "torch.cuda.CUDAGraph"
    imgs: torch.Tensor
    odo: torch.Tensor
    rows: torch.Tensor


def _write_back(buf: FilterState, state: FilterState) -> None:
    """Copy ``state`` into the static buffers ``buf`` (in a capture: the
    chunk's last nodes). A field that shares storage with another buffer
    is cloned first, so no copy reads a buffer already overwritten."""
    bufs, outs = control.leaves(buf), control.leaves(state)
    ptrs = {b.untyped_storage().data_ptr() for b in bufs}
    outs = [o.clone() if o is not b and o.untyped_storage().data_ptr()
            in ptrs else o for b, o in zip(bufs, outs)]
    for b, o in zip(bufs, outs):
        if o.shape != b.shape or o.dtype != b.dtype:
            raise ValueError(f"state field {tuple(o.shape)} {o.dtype} does "
                             f"not fit its buffer {tuple(b.shape)} {b.dtype}")
        if o is not b:
            b.copy_(o)


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
        #: opt-in: keep PIPELINING while host-gated (the gate then reads the
        #: match count one chunk stale: a mid-chunk collapse could run
        #: starved for up to 2*chunk frames, which is why gating stops the
        #: pipelining by default). An int margin M re-enables it, and
        #: detection triggers at matched < min_num + M to absorb the
        #: staleness. M = 0 accepts the stale gate with no cushion: sound
        #: only when the config hovers far above true starvation, never at
        #: the reference-default min_num = 5 (run() warns).
        self.detect_gate_margin: Optional[int] = None
        self._last_matched = 0            # latest n_matched seen
        #: the detect flag of every chunk dispatched so far
        self.chunk_detect: List[bool] = []
        #: private switch: False runs every chunk by the eager route
        self._graphs = True
        #: (k, detect) -> _ChunkGraph, and each capture's seconds
        self._chunk_steps: dict = {}
        self.capture_s: dict = {}
        self._state_buf: Optional[FilterState] = None
        self._pool = None                  # the graphs' memory pool
        self._body_pool = None             # their conditional bodies' pool
        self._copy_stream = None           # the prefetch's side stream
        #: (key, device window, prefetch slot, ready event) of the window
        #: the next dispatch may take
        self._img_prefetch = None
        #: per window shape two device buffers the prefetch alternates
        #: between, each with the event after which it may be overwritten
        self._img_slots: dict = {}
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
        """One frame, eager (also every redirection frame)."""
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
        self._last_matched = rec.n_matched
        self._post_frame(rec, tele)
        return rec

    # -- the chunk machinery ------------------------------------------------

    def _window_images(self, ks: int, k: int):
        """The (k, H, W) window on the device in the transport dtype, from
        the prefetch when the previous chunk already shipped it (the
        current stream then waits on its event); returns (window, the
        prefetch slot it sits in or None)."""
        pre, self._img_prefetch = self._img_prefetch, None
        if pre is not None and pre[0] == (ks, k):
            _, dev, slot, ready = pre
            if ready is not None:
                torch.cuda.current_stream(self.device).wait_event(ready)
            return dev, slot
        host = torch.from_numpy(self._stack_window(ks, k))
        if self.device.type != "cuda":
            return host.to(self.device), None
        return host.pin_memory().to(self.device, non_blocking=True), None

    def _stack_window(self, ks: int, k: int) -> np.ndarray:
        return np.stack([
            self._prep_image(self.images.get(int(self.track.frame_id[i])))
            for i in range(ks, ks + k)])

    def _prefetch_images(self, ks: int, k: int) -> None:
        """Ship window ``[ks, ks + k)`` to the device while the chunk just
        dispatched runs: pinned host memory, then a copy on a side stream
        into one of two device buffers that alternate, behind an event."""
        host = torch.from_numpy(self._stack_window(ks, k))
        if self.device.type != "cuda":
            self._img_prefetch = ((ks, k), host.to(self.device), None, None)
            return
        pinned = host.pin_memory()
        main = torch.cuda.current_stream(self.device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        slots = self._img_slots.get(tuple(host.shape))
        if slots is None:
            # made on the main stream: the side stream waits for what the
            # main stream had queued when they were made
            made = main.record_event()
            slots = self._img_slots[tuple(host.shape)] = [
                [torch.empty(host.shape, dtype=host.dtype,
                             device=self.device), made] for _ in range(2)]
        slot = slots.pop(0)
        slots.append(slot)
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(slot[1])
            slot[0].copy_(pinned, non_blocking=True)
            ready = self._copy_stream.record_event()
        self._img_prefetch = ((ks, k), slot[0], slot, ready)

    def _graph_route(self) -> bool:
        """Chunks run as captured graphs: on the card, in the modes the
        graphs cover, without an ambient mesh, unless switched off."""
        cfg = self.cfg
        return (self._graphs and self.device.type == "cuda"
                and cfg.sigma_mode in ("full", "implicit")
                and cfg.update_mode == "gram" and cfg.qr_mode == "gram"
                and AMBIENT.get()[0] is None)

    def _chunk_fn(self, k: int, detect: bool = True):
        """``fn(state, imgs, odo) -> (state, rows)`` running k frames
        (``imgs`` the (k, H, W) window, ``odo`` its k + 1 odometry rows),
        rows the (k, row) packed telemetry. On the graph route the graph
        of key ``(k, detect)``, captured at its first use; else the eager
        loop. ``detect=False`` leaves the detection pipeline out."""
        if not self._graph_route():
            return lambda state, imgs, odo: self._frames(state, imgs, odo,
                                                         detect)
        key = (k, detect)
        if key not in self._chunk_steps:
            t0 = time.perf_counter()
            self._chunk_steps[key] = self._capture_chunk(k, detect)
            self.capture_s[key] = time.perf_counter() - t0
        g = self._chunk_steps[key]

        def replay(state, imgs, odo):
            if state is not self._state_buf:
                _write_back(self._state_buf, state)
            g.imgs.copy_(imgs)
            g.odo.copy_(odo)
            g.graph.replay()
            return self._state_buf, g.rows

        return replay

    def _frames(self, state: FilterState, imgs: torch.Tensor,
                odo: torch.Tensor, detect: bool):
        """``slam_step`` over the window ``imgs`` (its k + 1 odometry rows
        ``odo``): (the state after it, the (k, row) packed telemetry)."""
        imgs = imgs.to(self._dtype)
        rows = []
        for i in range(imgs.shape[0]):
            state, out = slam_step(state, imgs[i], odo[i], odo[i + 1], False,
                                   self.cfg, allow_detect=detect)
            rows.append(_pack_row(out, self.cfg.max_landmarks))
        return state, torch.stack(rows)

    def _capture_chunk(self, k: int, detect: bool) -> "_ChunkGraph":
        dev = self.device
        if self._state_buf is None:
            self._state_buf = control.tree_map(torch.clone, self.state)
            self._pool = torch.cuda.graph_pool_handle()
            self._body_pool = torch.cuda.MemPool()
        elif self.state is not self._state_buf:
            _write_back(self._state_buf, self.state)
        self.state = buf = self._state_buf
        H, W = self.cfg.camera.height, self.cfg.camera.width
        imgs = torch.zeros((k, H, W), device=dev, dtype=(
            torch.uint8 if self._img_u8 else self._dtype))
        odo = self._odo[:k + 1].clone()

        # warm-up: one frame, every branch, on the stream the capture uses
        # (thrown away); library handles are per stream
        side = control.capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), control.warmup():
            self._frames(buf, imgs[:1], odo[:2], detect)
        torch.cuda.current_stream(dev).wait_stream(side)

        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=side), \
                control.capture(self._body_pool):
            st, rows = self._frames(buf, imgs, odo, detect)
            _write_back(buf, st)
        return _ChunkGraph(graph=graph, imgs=imgs, odo=odo, rows=rows)

    def _dispatch_chunk(self, k: int) -> Optional[dict]:
        """Dispatch ONE k-frame chunk without waiting for its telemetry.

        Returns a pending descriptor (the telemetry still in flight) or
        None when a redirect boundary / end of track prevents a full-chunk
        dispatch. The counter advances immediately; records appear when
        :meth:`_finish_chunk` materializes."""
        k = min(k, len(self.track) - self.counter)
        if k <= 0 or self._redirect[self.counter:self.counter + k].any():
            return None
        ks = self.counter
        t0 = time.perf_counter()
        # host-gated detection cadence: the reference's detect-when-starved
        # trigger (SLAM.cpp:552-562) decided per CHUNK from the latest
        # materialized match telemetry
        detect = True
        if self.detect_host_gate:
            detect = self._last_matched < (
                self.cfg.min_num + (self.detect_gate_margin or 0))
        self.chunk_detect.append(detect)
        imgs, slot = self._window_images(ks, k)
        self.state, rows = self._chunk_fn(k, detect)(
            self.state, imgs, self._odo[ks - 1:ks + k])
        if self.device.type == "cuda":
            main = torch.cuda.current_stream(self.device)
            if slot is not None:
                slot[1] = main.record_event()      # window consumed
            host = torch.empty(rows.shape, dtype=rows.dtype,
                               pin_memory=True)
            host.copy_(rows, non_blocking=True)
            done = main.record_event()
        else:
            host, done = rows, None
        # prefetch the NEXT window's images while the device computes
        ns = ks + k
        if (ns + k <= len(self.track)
                and not self._redirect[ns:ns + k].any()):
            self._prefetch_images(ns, k)
        self.counter += k
        return dict(rows=host, done=done, ks=ks, k=k, t0=t0)

    def _finish_chunk(self, pending: dict) -> List[FrameRecord]:
        """Materialize a dispatched chunk's telemetry (wait on its event)
        and run the per-frame host side effects."""
        ks, k = pending["ks"], pending["k"]
        if pending["done"] is not None:
            pending["done"].synchronize()
        rows = pending["rows"].numpy()
        # wall time from THIS chunk's dispatch timestamp (the shared
        # FrameTimer slot is overwritten when the next chunk dispatches
        # before this one finishes in the pipelined loop)
        wall = self.timer.record(time.perf_counter() - pending["t0"],
                                 frames=k)
        M = self.cfg.max_landmarks
        recs = []
        for i in range(k):
            tele = _unpack_row(rows[i], M)
            recs.append(self._record(ks + i, tele, wall / k))
            self._post_frame(recs[-1], tele)
        if recs:
            self._last_matched = recs[-1].n_matched
        return recs

    def step_chunk(self, k: int) -> List[FrameRecord]:
        """Process up to ``k`` frames in ONE dispatch (one replay on the
        graph route). Frames up to and including a redirection frame are
        single-stepped instead.

        With ``detect_host_gate`` the whole chunk runs with or without the
        detection pipeline, decided from the latest match count seen."""
        k = min(k, len(self.track) - self.counter)
        if k <= 0:
            return []
        ks = self.counter
        # the chunk is the redirect-free branch; segment at redirection
        # frames (rare: |dtheta| > 45 deg) and single-step those
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
        pending = self._dispatch_chunk(k)
        return self._finish_chunk(pending) if pending else []

    def run(self, n_frames: Optional[int] = None, chunk: int = 1,
            drop_tail: bool = False) -> np.ndarray:
        """AUTO mode: run to the end (or n_frames); returns (T, 4) poses.

        ``chunk > 1`` runs that many frames per dispatch and PIPELINES the
        telemetry fetch: chunk i's device-to-host copy and host side
        effects overlap chunk i + 1's device work. ``drop_tail`` stops
        before an incomplete final chunk instead of single-stepping it.
        """
        n = (len(self.track) - self.counter if n_frames is None
             else n_frames)
        # pipelining defers each chunk's host side effects until the next
        # chunk is already in flight: a watchdog recovery (or a backend
        # loop closure) would then act one chunk late, and the host-gated
        # detection decision would read match telemetry up to TWO chunks
        # stale. With stateful host observers or host-gated detection,
        # finish each chunk before dispatching the next.
        pipelined = (self.watchdog is None and self.backend is None
                     and (not self.detect_host_gate
                          or self.detect_gate_margin is not None))
        if (pipelined and self.detect_host_gate
                and (self.detect_gate_margin or 0) < chunk
                and self.cfg.min_num <= self.cfg.max_new_per_frame):
            # margin below the per-chunk staleness AND a min_num small
            # enough that one starved stretch can drop the map below
            # redetection's reach (reference-default min_num=5 regime)
            warnings.warn(
                f"pipelined host-gated detection with margin "
                f"{self.detect_gate_margin} < chunk {chunk} at "
                f"min_num={self.cfg.min_num}: the stale gate can run "
                f"starved for up to 2*chunk frames with no cushion",
                stacklevel=2)
        if chunk > 1:
            done = 0          # frames with records materialized
            dispatched = 0    # frames consumed by the device
            pending = None
            while True:
                if not pipelined and pending is not None:
                    done += len(self._finish_chunk(pending))
                    pending = None
                nxt = (self._dispatch_chunk(chunk)
                       if n - dispatched >= chunk else None)
                if pending is not None:
                    done += len(self._finish_chunk(pending))
                pending = nxt
                if nxt is not None:
                    dispatched += nxt["k"]
                    continue
                # no dispatch: end of track, redirect boundary, or tail
                if dispatched < n and self.counter < len(self.track):
                    at_redirect = bool(self._redirect[self.counter])
                    if at_redirect or not drop_tail:
                        # single-step through redirects (then resume
                        # chunking) and through the odd tail
                        if self.step() is None:
                            break
                        done += 1
                        dispatched += 1
                        continue
                break
            return self.trajectory
        for _ in range(n):
            if self.step() is None:
                break
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
