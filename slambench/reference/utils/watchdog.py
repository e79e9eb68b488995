"""The health flags a frame reports (the port's ``utils/watchdog.py``)."""

from __future__ import annotations

import torch

from ..config import SlamConfig
from ..filter.state import FilterState


def health_check(state: FilterState, cfg: SlamConfig,
                 pose_limit: float = 1e3,
                 s_diag_max: float = 1e4) -> torch.Tensor:
    """Returns bool[3] = (all finite, S diag sane, pose bounded)."""
    finite = torch.isfinite(state.x).all() & torch.isfinite(state.S).all()
    d = torch.abs(torch.diagonal(state.S))
    s_ok = torch.all(d < s_diag_max) & (torch.max(d) > 0)
    pose_ok = torch.all(torch.abs(state.x[-4:-1]) < pose_limit)
    return torch.stack([finite, s_ok, pose_ok])
