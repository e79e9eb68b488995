"""Failure detection + recovery.

  * :func:`health_check` — one pass over the filter state: NaN/Inf anywhere,
    sqrt-factor diagonal collapse or blow-up, pose runaway. It runs in every
    frame's telemetry.
  * :class:`Watchdog` — host-side policy: on failure, either restore the
    last good checkpoint or re-initialize the filter the way the
    reference's redirection reset does (SLAM.cpp:1395-1419), preserving the
    stored-feature table so the map survives the reset.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import SlamConfig
from ..filter.state import FilterState, init_state, replace


@dataclasses.dataclass
class HealthReport:
    ok: bool
    finite: bool
    s_diag_ok: bool
    pose_ok: bool

    @classmethod
    def from_flags(cls, flags: np.ndarray) -> "HealthReport":
        finite, s_ok, pose_ok = (bool(x) for x in np.asarray(flags))
        return cls(ok=finite and s_ok and pose_ok, finite=finite,
                   s_diag_ok=s_ok, pose_ok=pose_ok)


def health_check(state: FilterState, cfg: SlamConfig,
                 pose_limit: float = 1e3,
                 s_diag_max: float = 1e4) -> torch.Tensor:
    """Returns bool[3] = (all finite, S diag sane, pose bounded)."""
    finite = torch.isfinite(state.x).all() & torch.isfinite(state.S).all()
    d = torch.abs(torch.diagonal(state.S))
    s_ok = torch.all(d < s_diag_max) & (torch.max(d) > 0)
    pose_ok = torch.all(torch.abs(state.x[-4:-1]) < pose_limit)
    return torch.stack([finite, s_ok, pose_ok])


class Watchdog:
    """Host-side failure policy.

    check_every: frames between health checks. Without ``restore_fn`` a
    failure re-initializes a robot-only state with the stored table
    preserved (redirection-reset semantics); a checkpoint restore callback
    may be supplied instead.
    """

    def __init__(self, cfg: SlamConfig, check_every: int = 10,
                 restore_fn: Optional[Callable[[], FilterState]] = None):
        self.cfg = cfg
        self.check_every = check_every
        self.restore_fn = restore_fn
        self.n_checks = 0
        self.n_failures = 0
        self.last_report: Optional[HealthReport] = None

    def should_check(self, frame: int) -> bool:
        return frame % self.check_every == 0

    def check(self, state: FilterState) -> HealthReport:
        return self.check_flags(health_check(state, self.cfg).cpu().numpy())

    def check_flags(self, flags: np.ndarray) -> HealthReport:
        """Record a report from flags already computed in the step (the
        ``health`` telemetry field) — no extra device work."""
        self.n_checks += 1
        report = HealthReport.from_flags(flags)
        self.last_report = report
        if not report.ok:
            self.n_failures += 1
        return report

    def recover(self, state: FilterState, theta_odo: float) -> FilterState:
        """Restore from checkpoint if available, else a hard reset: fresh
        robot-only state (SLAM.cpp:1395-1419) on the failed state's device,
        carrying over only the *finite* stored-feature records — unlike
        redirect_reset, the diverged landmarks are NOT snapshotted, so the
        poison doesn't survive the reset."""
        if self.restore_fn is not None:
            return self.restore_fn()
        sd = state.stored
        fresh = init_state(self.cfg, theta0=float(theta_odo),
                           max_stored=sd.valid.shape[0],
                           device=state.x.device)
        finite = (torch.isfinite(sd.state).all(dim=1)
                  & torch.isfinite(sd.sr).all(dim=(1, 2)))
        return replace(fresh, stored=replace(sd, valid=finite & sd.valid),
                       next_id=state.next_id, frame=state.frame)
