"""Backend telemetry capture + replay.

The backend (keyframes, loop closure, pose graph, window BA) consumes
only per-frame telemetry and never feeds corrections back into the
filter (api.SlamSession: corrections touch Keyframe.pose, the refined
trajectory is composed post-hoc). That makes backend configuration a
pure function of the telemetry stream — so A/B experiments over backend
knobs (e.g. the window-BA apply gate) need ONE filter run: capture the
stream, then replay it through as many BackendSession variants as needed.
A replay on the device the live backend ran on reproduces it exactly.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..config import SlamConfig
from .session import BackendSession


class TelemetryCapture:
    """Stands in for a BackendSession inside SlamSession, recording every
    ``maybe_add_telemetry`` call (and performing no backend work)."""

    def __init__(self):
        self.calls: List[tuple] = []
        # the api consults these before deciding to refine; keep them
        # empty so capture adds zero backend compute to the timed run
        self.keyframes: list = []
        self.loop_edges: list = []

    def maybe_add_telemetry(self, frame, pose4, odo, lid, matched,
                            match_px, xyz, pose_sqrt_cov=None,
                            active=None):
        self.calls.append(tuple(
            np.array(a, copy=True) if a is not None else None
            for a in (frame, pose4, odo, lid, matched, match_px, xyz,
                      pose_sqrt_cov, active)))
        return None


def replay(calls, cfg: SlamConfig, *, ba_apply_gate: Optional[float] = None,
           backend_kwargs: Optional[dict] = None, device=None):
    """Feed a captured telemetry stream through a fresh BackendSession,
    mirroring api.SlamSession's refine-on-keyframe policy exactly.

    ``ba_apply_gate=inf`` disables window-BA commits (graph-only);
    ``device`` is the BackendSession's (``cuda`` unless named). Returns
    ``(backend, refinements)``.
    """
    if ba_apply_gate is not None:
        cfg = dataclasses.replace(cfg, ba_apply_gate=ba_apply_gate)
    be = BackendSession(cfg, device=device, **(backend_kwargs or {}))
    refinements = []
    for (frame, pose4, odo, lid, matched, match_px, xyz, psc,
         active) in calls:
        n_loops = len(be.loop_edges)
        kf = be.maybe_add_telemetry(int(frame), pose4, odo, lid, matched,
                                    match_px, xyz, pose_sqrt_cov=psc,
                                    active=active)
        if kf is not None and len(be.keyframes) >= 2:
            if len(be.loop_edges) > n_loops:
                out = be.optimize_graph()
            else:
                out = be.refine_window()
            if out is not None:
                refinements.append(out)
    return be, refinements
