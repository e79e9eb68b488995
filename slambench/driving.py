"""What every route shares: the session, the window's bookkeeping, and the
samples that ``check.py`` judges after the window.

A route (``routes/<name>.py``) defines ``Route(ctx)`` with

* ``warm()``: capture this cell's graph keys and run the path once;
* ``window(seconds, plan) -> Window``: offer frames for ``seconds`` and
  keep a :class:`Sample` at each iteration that ``plan`` (a :class:`Plan`)
  finds due;
* ``stretch() -> int``: a steady stretch of frames for the profiler (its
  frame count), run twice from one :func:`mark`, unprofiled and profiled;
* ``release()``: drop the program's state;

and holds its ``SlamSession`` as ``sess``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Ctx:
    """What a route is given."""

    cfg: object                 # the program's SlamConfig
    session: dict               # the configuration's session attributes
    traffic: dict
    seq: object                 # the program's ImageSequence of the lap
    track: object               # the program's OdometryTrack
    frames: np.ndarray          # (n, H, W) uint8, the lap
    device: torch.device


@dataclasses.dataclass
class Sample:
    """Consecutive frames the check compares (one dispatch: a chunk, or one
    step): the program's state before the first, its outputs of every
    frame, and its state after the last."""

    frame: int                  # odometry row of the first frame
    images: List[np.ndarray]    # (H, W) uint8, one a frame
    allow_detect: bool
    before: object              # FilterState on the host
    teles: List[dict]           # each frame's outputs (numpy)
    later: object               # FilterState on the host, after the last


@dataclasses.dataclass
class Window:
    frames: int                 # frames recorded in the window
    attempted: int              # frames handed to the session
    failed: int
    wall_s: float
    latencies_s: Optional[List[float]] = None
    samples: List[Sample] = dataclasses.field(default_factory=list)
    first_frame: int = 0        # odometry row of the window's first frame
    health: dict = dataclasses.field(default_factory=dict)


def steady_host() -> None:
    """One thread of torch work on the host: a run's host path does not
    share the cores with the library's idle worker threads."""
    torch.set_num_threads(1)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def to_host(state):
    """A copy of a program state on the host (the graph route's state is
    its static buffers, which the next replay overwrites)."""
    from cv_monoslam_tpu_torch.ops import control

    return control.tree_map(lambda t: t.detach().to("cpu", copy=True), state)


def state_tele(state, M: int) -> dict:
    """A frame's outputs as its telemetry row has them, from the state
    after it (``api._pack_row``'s fields)."""
    lm = state.lm
    S = state.S
    sq = torch.sqrt(torch.clamp(torch.einsum("ij,ij->j", S[:, -4:],
                                             S[:, -4:]), min=0.0))
    return dict(pose=state.x[-4:].numpy().astype(np.float64),
                pose_sqrt_cov=sq.numpy().astype(np.float64),
                lm_lid=lm.lid.numpy(), lm_active=lm.active.numpy(),
                lm_matched=(lm.matched & lm.active).numpy(),
                lm_match_px=lm.match_px.numpy(),
                lm_xyz=lm.xyz.numpy(),
                repairs=np.array([int(state.n_repairs),
                                  int(state.n_escalations),
                                  int(state.n_skipped)]),
                n_map=int(lm.active.sum()),
                n_matched=int((lm.matched & lm.active).sum()))


def mark(sess) -> tuple:
    """The session where it stands: a copy of its state on the device, its
    frame counter and the match count its host gate reads."""
    from cv_monoslam_tpu_torch.ops import control

    return (control.tree_map(torch.clone, sess.state), sess.counter,
            sess._last_matched)


def rewind(sess, at: tuple) -> None:
    """Put the session back where :func:`mark` found it (its next replay
    copies the state into the graphs' buffers)."""
    from cv_monoslam_tpu_torch.ops import control

    state, sess.counter, sess._last_matched = at
    sess.state = control.tree_map(torch.clone, state)


def health(records, before=None) -> dict:
    """Failed frames and the health counts of ``records`` (PERF.md §2): a
    frame fails with no finite pose, or when it counts an escalated repair
    or a skipped update (its cumulative counters rise over those of the
    frame before it, ``before`` for the first)."""
    failed = 0
    esc = skip = 0
    prev_e = prev_s = None
    if before is not None:
        prev_e, prev_s = before.n_escalations, before.n_skipped
    matched = []
    for r in records:
        bad = not np.all(np.isfinite(r.pose))
        if prev_e is not None and (r.n_escalations > prev_e
                                   or r.n_skipped > prev_s):
            bad = True
            esc += r.n_escalations - prev_e
            skip += r.n_skipped - prev_s
        prev_e, prev_s = r.n_escalations, r.n_skipped
        failed += bad
        matched.append(r.n_matched)
    return dict(failed=failed, escalations=esc, skipped=skip,
                peak_matched=max(matched, default=0),
                mean_matched=float(np.mean(matched)) if matched else 0.0)


def ate(records, track, gt_xy: np.ndarray) -> float:
    """RMSE of (x, y) against the lap's true positions."""
    if not records:
        return float("nan")
    ids = np.array([int(track.frame_id[r.frame]) for r in records])
    traj = np.stack([r.pose[:2] for r in records])
    return float(np.sqrt(((traj - gt_xy[ids]) ** 2).sum(axis=1).mean()))


class Plan:
    """When the window keeps a sample for the check: ``check.samples``
    moments drawn from the seed, one in each of as many equal parts of the
    window's first ``SPAN``, so the samples spread over the whole window.
    A route asks :meth:`due` once an iteration; a moment that passes while
    an iteration runs is taken at the next one."""

    SPAN = 0.9

    def __init__(self, traffic: dict, seed: int, seconds: float):
        n = int(traffic["check"]["samples"])
        u = np.random.default_rng([seed, 2]).uniform(size=n)
        self.at = list((np.arange(n) + u) / n * self.SPAN * seconds)
        self.taken = 0

    def due(self, elapsed: float) -> bool:
        if self.taken < len(self.at) and elapsed >= self.at[self.taken]:
            self.taken += 1
            return True
        return False


def clock() -> float:
    return time.perf_counter()
