"""What the program measures of itself, read in the traced process after
the stretch: the host spans and counters of
``cv_monoslam_tpu_torch/utils/profiling.py`` (``totals()``), the device's
stage times (``ops/vision.stage_times``), and the stage marks
(``stage_mark_<stage>_kernel``) among a profiled trace's device operations.

The totals are the process's since the session was made: its warm-up, the
window and the unprofiled stretch; the host spans and counters stand still
while a profiler runs. The stage times count the profiled stretch's replays
too, and there the profiler stretches them: a replayed graph is fed to the
card node by node by its own ``cudaGraphLaunch``, which the profiler slows
(at M = 32 a 32-frame replay takes 0.2 s, four times its unprofiled time).
So the profiled stretch's marks, read from the trace, are taken out of the
stage times, and what is left are the card's unprofiled frames, the frames
the ``frames`` counter counts. Every reader gives None where the program
keeps none of these (a checkout from before them, or the CPU), so a metric
built on it leaves the line.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

MARK = "stage_mark_"


def totals() -> Optional[dict]:
    """``profiling.totals()``, or None."""
    try:
        from cv_monoslam_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "totals", None)
    return read() if read is not None else None


def stage_times() -> Optional[dict]:
    """``vision.stage_times`` of the current card (ns a stage, frames), or
    None where no frame was marked."""
    import torch

    try:
        from cv_monoslam_tpu_torch.ops import vision
    except ImportError:
        return None
    read = getattr(vision, "stage_times", None)
    if read is None or not torch.cuda.is_available():
        return None
    st = read(torch.device("cuda", torch.cuda.current_device()))
    return st if st and st.get("frames") else None


def mark_stage(name: str) -> Optional[str]:
    """The stage of a stage mark's kernel name, or None for another op."""
    i = name.find(MARK)
    if i < 0:
        return None
    rest = name[i + len(MARK):]
    j = rest.find("_kernel")
    return rest[:j] if j > 0 else None


def marks(t) -> List[Tuple[str, float, float]]:
    """(stage, start, end) of every stage mark in the trace ``t``."""
    out = []
    for name, a, b in t.device:
        stage = mark_stage(name)
        if stage is not None:
            out.append((stage, a, b))
    return out


def traced_stages(t) -> Dict[str, float]:
    """Each stage's ns in the trace ``t`` as the accumulators count it (the
    time from the previous mark to the stage's own; ``start`` closes none)
    and ``frames``, its ``telemetry`` marks."""
    out: Dict[str, float] = {"frames": 0}
    prev = None
    for stage, a, _ in marks(t):
        if stage != "start" and prev is not None:
            out[stage] = out.get(stage, 0.0) + (a - prev) * 1e3
        out["frames"] += stage == "telemetry"
        prev = a
    return out


def unprofiled_stages(t) -> Optional[dict]:
    """The stage times less the profiled stretch's (``traced_stages``):
    ns a stage and ``frames`` over the unprofiled frames; None where no
    frame was marked unprofiled."""
    st = stage_times()
    if st is None:
        return None
    traced = traced_stages(t)
    out = {k: v - traced.get(k, 0.0) for k, v in st.items()}
    return out if out["frames"] > 0 else None


def stage_ms_per_frame(t, *stages: str) -> Optional[float]:
    """The device time of ``stages`` an unprofiled marked frame, in ms."""
    st = unprofiled_stages(t)
    if st is None:
        return None
    return sum(st[s] for s in stages) / st["frames"] / 1e6


def span_ms_per_frame(t, outer: str, *inner: str) -> Optional[float]:
    """Host span ``outer``'s total less the ``inner`` spans opened
    directly inside it, a recorded frame (the ``frames`` counter), in ms;
    None where the trace ``t`` saw no device (the spans timed the eager
    route off the card)."""
    tot = totals()
    if not tot or not t.device:
        return None
    spans, frames = tot["spans"], tot["counters"].get("frames", 0)
    if outer not in spans or not frames:
        return None
    ns = spans[outer]["total_ns"] - sum(
        spans.get(n, {}).get("under", {}).get(outer, 0) for n in inner)
    return ns / frames / 1e6


def outside_graph_ms_per_frame(t) -> Optional[float]:
    """The session's host wall time a frame (its outermost spans, graph
    captures left out but the wait before each kept) less the in-graph
    time a frame (every stage of the unprofiled marked frames, from each
    replay's ``start`` to its last mark), in ms: the host path, the copies
    and the waits between replays."""
    tot, st = totals(), unprofiled_stages(t)
    if not tot or st is None:
        return None
    spans = tot["spans"]
    frames = tot["counters"].get("frames", 0)
    if not frames:
        return None
    wall = sum(s["total_ns"] - sum(s["under"].values())
               for s in spans.values())
    cap = spans.get("slam.capture")
    if cap is not None:
        waited = spans.get("slam.wait", {}).get("under", {}).get(
            "slam.capture", 0)
        wall -= cap["total_ns"] - waited
    inside = sum(v for k, v in st.items() if k != "frames")
    return (wall - inside * frames / st["frames"]) / frames / 1e6


def replays(t) -> List[Tuple[float, float]]:
    """(start, end) of each replay in the trace ``t``: from its ``start``
    mark's start to the end of the last mark before the next ``start``."""
    out, cur = [], None
    for stage, a, b in marks(t):
        if stage == "start":
            if cur is not None and cur[1] is not None:
                out.append(tuple(cur))
            cur = [a, None]
        elif cur is not None:
            cur[1] = b
    if cur is not None and cur[1] is not None:
        out.append(tuple(cur))
    return out


def busy_within(t, spans: List[Tuple[float, float]]) -> float:
    """Device-busy time (the union of ``t``'s device operations) inside
    the intervals ``spans``, in us."""
    merged = []
    for _, a, b in sorted(t.device, key=lambda s: s[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    ends = [m[1] for m in merged]
    busy = 0.0
    for a, b in spans:
        i = bisect.bisect_right(ends, a)
        while i < len(merged) and merged[i][0] < b:
            busy += min(b, merged[i][1]) - max(a, merged[i][0])
            i += 1
    return busy
