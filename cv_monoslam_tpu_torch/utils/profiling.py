"""Tracing (SURVEY.md §5): spans and counters of the host path, and the
Chrome trace of a profiled run.

The reference has per-frame wall-clock TickMeter timers surfaced in the UI
(SLAM.cpp:122-151, MonoSLAMView.cpp:92-93). Here:

  * :func:`span` ``(name, frame=None)`` — a context manager around a piece
    of the host path. With no ``torch.profiler`` running it only adds to
    per-process totals: count, total ns and self ns (total less the spans
    opened inside it), and, per enclosing span, the ns spent under it; the
    clock is ``time.perf_counter_ns``. While a profiler runs it is
    ``torch.profiler.record_function(name)`` instead (``frame``, the
    frame's or its chunk's first frame's counter, as its ``args``), a
    ``user_annotation`` in the trace on the device's clock, and the totals
    do not move;
  * :func:`count` ``(name, n=1)`` — a counter, likewise left alone while a
    profiler runs;
  * :func:`totals` reads both, :func:`reset` zeroes them (every new
    ``SlamSession`` does), :func:`report` prints them a frame;
  * :func:`trace` — context manager around ``torch.profiler`` that writes a
    Chrome trace (open in Perfetto or ``chrome://tracing``).

The device side of a frame is timed by the stage marks captured into its
graph (``ops.vision.stage_mark``, read by ``ops.vision.stage_times``).

A span site costs two clock reads and a few attribute updates when no
profiler runs: each name's span object is made once and reused, so a site
allocates nothing that outlives it. The spans of one process nest as one
stack: they are for the thread that drives the session.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional

import torch.autograd.profiler as _profiler

_clock = time.perf_counter_ns


class _Span:
    """One name's span: its totals, and its state while open."""

    __slots__ = ("name", "owner", "count", "total_ns", "self_ns", "under",
                 "frame", "t0", "child_ns", "record", "open")

    def __init__(self, name: str, owner: Optional["_Span"] = None):
        self.name = name
        #: the span whose totals this one adds to (itself, but for a name
        #: opened again inside itself)
        self.owner = self if owner is None else owner
        self.count = self.total_ns = self.self_ns = 0
        #: enclosing span's name -> ns spent directly under it
        self.under: Dict[str, int] = {}
        self.frame = None
        self.t0 = self.child_ns = 0
        self.record = None
        self.open = False

    def __enter__(self) -> "_Span":
        self.open = True
        if _profiler._is_profiler_enabled:
            self.record = _profiler.record_function(
                self.name, None if self.frame is None else str(self.frame))
            self.record.__enter__()
            return self
        self.child_ns = 0
        _OPEN.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dt = _clock() - self.t0
        self.open = False
        if self.record is not None:
            record, self.record = self.record, None
            record.__exit__(exc_type, exc, tb)
            return
        _OPEN.pop()
        o = self.owner
        o.count += 1
        o.total_ns += dt
        o.self_ns += dt - self.child_ns
        if _OPEN:
            parent = _OPEN[-1]
            parent.child_ns += dt
            under = o.under
            under[parent.name] = under.get(parent.name, 0) + dt


_SPANS: Dict[str, _Span] = {}
_OPEN: List[_Span] = []
_COUNTS: Dict[str, int] = {}


def span(name: str, frame: Optional[int] = None) -> _Span:
    """``with span(name, frame):`` — see the module docstring."""
    s = _SPANS.get(name)
    if s is None:
        s = _SPANS[name] = _Span(name)
    elif s.open:                      # the same name nested in itself
        s = _Span(name, owner=s)
    s.frame = frame
    return s


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (unless a profiler runs)."""
    if not _profiler._is_profiler_enabled:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def totals() -> dict:
    """``{"spans": {name: {"count", "total_ns", "self_ns", "under"}},
    "counters": {name: n}}`` since the last :func:`reset`; ``under`` maps
    each enclosing span's name to the ns spent directly under it."""
    return {"spans": {n: dict(count=s.count, total_ns=s.total_ns,
                              self_ns=s.self_ns, under=dict(s.under))
                      for n, s in _SPANS.items() if s.count},
            "counters": dict(_COUNTS)}


def reset() -> None:
    """Zero every span's totals and every counter."""
    for s in _SPANS.values():
        s.count = s.total_ns = s.self_ns = 0
        s.under.clear()
    _COUNTS.clear()


def report(stage_times: Optional[dict] = None) -> str:
    """The totals as a table, a frame (the ``frames`` counter): each span's
    calls, total and self ms, each counter, and the device's stage times
    (``ops.vision.stage_times``) when given."""
    t = totals()
    frames = t["counters"].get("frames", 0)
    per = 1.0 / max(frames, 1)
    lines = [f"host spans over {frames} frames, ms a frame:",
             f"  {'span':<18}{'calls':>9}{'total':>10}{'self':>10}"]
    for name, s in sorted(t["spans"].items(),
                          key=lambda kv: -kv[1]["total_ns"]):
        lines.append(f"  {name:<18}{s['count']:>9}"
                     f"{s['total_ns'] * per / 1e6:>10.4f}"
                     f"{s['self_ns'] * per / 1e6:>10.4f}")
    if not t["spans"]:
        lines.append("  (none: a profiler ran, the spans are in its trace)")
    lines.append("counters: " + ", ".join(
        f"{k} {v}" for k, v in sorted(t["counters"].items())))
    if stage_times and stage_times.get("frames"):
        n = stage_times["frames"]
        lines.append(f"device stages over {n} marked frames, ms a frame: "
                     + ", ".join(f"{k} {v / n / 1e6:.4f}"
                                 for k, v in stage_times.items()
                                 if k != "frames"))
    return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Profiler trace of the host and, when there is one, the CUDA device:
    writes ``<logdir>/trace.json`` (Chrome trace format), with the spans as
    ``user_annotation`` events and the stage marks as kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
