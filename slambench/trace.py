"""The traced stretch: ``torch.profiler`` over a steady stretch of the run,
read from its Chrome trace into what the per-layer metrics take.

Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events (a replayed CUDA graph's kernels appear one by one);
host activity is the trace's operators, runtime and driver calls and
annotations (the profiler's own buffer flushes are left out). Times are in microseconds as
the trace gives them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import tempfile
from typing import Callable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the host's own work (not the profiler's buffer flushes)
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
#: an idle gap shorter than this is a launch's own latency, not a wait
GAP_US = 10.0


@dataclasses.dataclass
class Trace:
    frames: int                          # frames in the traced stretch
    window_us: float                     # the traced stretch's wall time
    #: (name, start, end) of every device operation, in start order
    device: List[Tuple[str, float, float]]
    #: (name, start, end) of the host's events
    host: List[Tuple[str, float, float]]
    #: the wall time a frame of the same frames run unprofiled (us)
    wall_us_per_frame: float
    M: int                               # the configuration's landmarks

    def busy_us(self) -> float:
        return union_us([(a, b) for _, a, b in self.device])

    def kernel_us(self, match: Callable[[str], bool]) -> List[float]:
        return [b - a for n, a, b in self.device if match(n)]


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def record(run_stretch: Callable[[], int], sync: Callable[[], None],
           clock: Callable[[], float]) -> Tuple[int, float, dict]:
    """Profile ``run_stretch()``; returns (frames, wall seconds, the Chrome
    trace as parsed JSON)."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = clock()
        frames = run_stretch()
        sync()
        wall = clock() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    return frames, wall, doc


def parse(doc: dict, frames: int, wall_s: float, wall_us_per_frame: float,
          M: int) -> Trace:
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        span = (e.get("name", ""), float(e["ts"]),
                float(e["ts"]) + float(e["dur"]))
        if e.get("cat") in DEVICE_CATS:
            dev.append(span)
        elif e.get("cat") in HOST_CATS:
            host.append(span)
    dev.sort(key=lambda s: s[1])
    return Trace(frames=frames, window_us=wall_s * 1e6, device=dev,
                 host=host, wall_us_per_frame=wall_us_per_frame, M=M)


def breakdown(t: Trace, top: int = 10) -> dict:
    """The device operations that took most time (seconds by name) and the
    idle gaps over ``GAP_US`` by what the host was doing at their middle
    (the innermost host event there), both the ``top`` largest."""
    by_name = {}
    for n, a, b in t.device:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], None
    for _, a, b in t.device:
        if end is not None and a - end > GAP_US:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    host = sorted(t.host, key=lambda s: s[1])
    by_host = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner = [h for h in host if h[1] <= mid <= h[2]]
        name = (min(inner, key=lambda h: h[2] - h[1])[0] if inner
                else "host outside any traced event")
        by_host[name] = by_host.get(name, 0.0) + (b - a)
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, us * 1e-6] for n, us in ops],
            "idle_gaps": [[n, us * 1e-6] for n, us in idle]}


def median(values: List[float]) -> float:
    return statistics.median(values)
