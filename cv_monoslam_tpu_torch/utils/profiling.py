"""Tracing / profiling (SURVEY.md §5).

The reference has per-frame wall-clock TickMeter timers surfaced in the UI
(SLAM.cpp:122-151, MonoSLAMView.cpp:92-93). Here:

  * :class:`FrameTimer` — the same per-frame + cumulative timers;
  * :class:`StageTimer` — named per-stage accumulators (the reference's
    commented-out per-stage timing lines, SLAM.cpp:89-111, made real);
  * :func:`trace` — context manager around ``torch.profiler`` that writes a
    Chrome trace (open in Perfetto or ``chrome://tracing``).

CUDA work is queued, not run, when a call returns: :class:`StageTimer`
synchronizes with the device at both ends of a stage so the interval holds
the stage's device work; for per-kernel device times use :func:`trace`.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


class FrameTimer:
    """Per-frame + cumulative wall clock (SLAM.cpp:122-151 semantics)."""

    def __init__(self):
        self.frame_time = 0.0
        self.total_time = 0.0
        self.n_frames = 0
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        self.frame_time = time.perf_counter() - self._t0
        self.total_time += self.frame_time
        self.n_frames += 1
        return self.frame_time

    def record(self, elapsed: float, frames: int = 1) -> float:
        """Account an externally-measured interval (pipelined chunk loops
        carry their own dispatch timestamps — the single ``_t0`` slot
        would be overwritten by the next chunk's ``start``)."""
        self.frame_time = elapsed
        self.total_time += elapsed
        self.n_frames += frames
        return elapsed

    @property
    def mean_time(self) -> float:
        return self.total_time / max(self.n_frames, 1)


def _sync(device) -> None:
    import torch

    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class StageTimer:
    """Named stage accumulators: ``with stages.time("predict"): ...``

    ``device``: a CUDA device to synchronize with before and after each
    stage (two host syncs per stage); ``None`` or a CPU device times the
    host only."""

    def __init__(self, device=None):
        self.device = device
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str) -> Iterator[None]:
        _sync(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(self.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Profiler trace of the host and, when there is one, the CUDA device:
    writes ``<logdir>/trace.json`` (Chrome trace format)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
