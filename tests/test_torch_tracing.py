"""The port's tracing: spans and counters of the host path
(``utils/profiling.py``), the session's spans, counters and wall times
(``api.SlamSession``), and the order of the stage marks a frame captures
(``ops/vision.stage_mark``; on the CPU they do nothing, so the mark function
is replaced by one that logs).
"""

import json
import sys
import time

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler

from cv_monoslam_tpu_torch.api import SlamSession
from cv_monoslam_tpu_torch.config import SlamConfig
from cv_monoslam_tpu_torch.io import fixtures as tfix
from cv_monoslam_tpu_torch.ops import vision
from cv_monoslam_tpu_torch.utils import profiling

KW = dict(max_landmarks=16, max_new_per_frame=4, max_detections=32,
          dtype="float64")
NORMAL = ["motion", "measure", "associate", "update", "maintain", "detect",
          "telemetry"]


@pytest.fixture(autouse=True)
def _fresh_totals():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def arc():
    return tfix.load("bench1_arc")


def _session(arc, **attrs):
    seq, track, _, _ = arc
    sess = SlamSession(SlamConfig(**KW), seq, track, device="cpu")
    for k, v in attrs.items():
        setattr(sess, k, v)
    return sess


def test_nested_spans_total_and_self_time(monkeypatch):
    """Self time is total less the spans opened inside; ``under`` keeps
    the time spent directly under each enclosing span; counters add."""
    now = [0]

    def clock():
        now[0] += 10
        return now[0]

    monkeypatch.setattr(profiling, "_clock", clock)
    for _ in range(2):
        with profiling.span("outer", 5):          # enter at 10, 60
            with profiling.span("inner", 5):      # 20 .. 30
                pass
            with profiling.span("inner"):         # 40 .. 50
                profiling.count("hits", 2)
    profiling.count("hits")
    t = profiling.totals()
    assert t["spans"]["outer"] == dict(count=2, total_ns=2 * 50,
                                       self_ns=2 * 30, under={})
    assert t["spans"]["inner"] == dict(count=4, total_ns=40, self_ns=40,
                                       under={"outer": 40})
    assert t["counters"] == {"hits": 5}
    with pytest.raises(ValueError):
        with profiling.span("outer"):
            raise ValueError("still counted")
    t = profiling.totals()
    assert t["spans"]["outer"]["count"] == 3
    assert not profiling._OPEN
    with profiling.span("outer"):
        with profiling.span("outer"):             # a name inside itself
            pass
    assert profiling.totals()["spans"]["outer"]["count"] == 5
    profiling.reset()
    assert profiling.totals() == {"spans": {}, "counters": {}}


def test_spans_are_user_annotations_under_a_profiler(tmp_path):
    """While a profiler runs a span is ``record_function``: a
    ``user_annotation`` in the Chrome trace, nested as opened; the totals
    and counters do not move."""
    with profiling.span("before"):
        pass
    profiling.count("frames", 3)
    held = profiling.totals()
    with profiling.trace(str(tmp_path)):
        with profiling.span("slam.dispatch", 7):
            with profiling.span("slam.replay", 7):
                torch.ones(4, 4) @ torch.ones(4, 4)
            profiling.count("frames", 4)
    assert profiling.totals() == held
    assert not profiling._OPEN
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ann = {e["name"]: e for e in events
           if e.get("cat") == "user_annotation"}
    assert {"slam.dispatch", "slam.replay"} <= set(ann)
    outer, inner = ann["slam.dispatch"], ann["slam.replay"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_no_profiler_call_and_no_allocation_without_a_profiler(monkeypatch):
    """With no profiler running a span site makes no ``record_function``
    and leaves nothing allocated behind it."""
    def refuse(*a, **k):
        raise AssertionError("record_function made with no profiler")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    for _ in range(10):                            # names made once
        with profiling.span("slam.dispatch", 1):
            with profiling.span("slam.replay", 1):
                profiling.count("frames")
    before = sys.getallocatedblocks()
    for i in range(2000):
        with profiling.span("slam.dispatch", i):
            with profiling.span("slam.replay", i):
                profiling.count("frames")
    assert sys.getallocatedblocks() - before < 16
    t = profiling.totals()
    assert t["spans"]["slam.replay"]["count"] == 2010
    assert t["counters"]["frames"] == 2010


def test_run_in_chunks_records_spans_and_counters(arc):
    """``run(chunk=4)`` with the host gate: one ``slam.run`` holding every
    dispatch and finish; ``frames`` is the records and the detect and
    tracking chunks are ``chunk_detect``'s; a new session zeroes it all."""
    sess = _session(arc, detect_host_gate=True, detect_gate_margin=0)
    profiling.count("stale")
    sess = _session(arc, detect_host_gate=True, detect_gate_margin=0)
    assert profiling.totals()["counters"] == {}
    sess.run(n_frames=8, chunk=4)
    t = profiling.totals()
    c, s = t["counters"], t["spans"]
    assert c["frames"] == len(sess.records) == 8
    assert c["chunks_detect"] == sum(sess.chunk_detect)
    assert c.get("chunks_track", 0) == len(sess.chunk_detect) - sum(
        sess.chunk_detect)
    assert len(sess.chunk_detect) == 2
    assert "pinned_buffers" not in c and "captures" not in c   # the CPU
    assert s["slam.run"]["count"] == 1
    for name in ("slam.dispatch", "slam.finish"):
        assert s[name]["count"] == 2
        assert s[name]["under"] == {"slam.run": s[name]["total_ns"]}
    for name in ("slam.window", "slam.replay", "slam.fetch"):
        assert s[name]["count"] == 2
        assert set(s[name]["under"]) == {"slam.dispatch"}
    # each dispatch ships the next window, past n_frames too
    assert s["slam.prefetch"]["count"] == 2
    assert set(s["slam.frames_host"]["under"]) == {"slam.finish"}
    assert "slam.wait" not in s and "slam.step" not in s
    run = s["slam.run"]
    assert run["self_ns"] == run["total_ns"] - sum(
        s[n]["under"].get("slam.run", 0) for n in s)
    assert s["slam.replay"]["total_ns"] > 0.5 * run["total_ns"]


def test_step_records_spans_and_counters(arc):
    """``step()``: upload, replay and the frame's host side under
    ``slam.step``, one a frame; a lone step counts its own wall time."""
    sess = _session(arc)
    recs = [sess.step() for _ in range(3)]
    t = profiling.totals()
    c, s = t["counters"], t["spans"]
    assert c == {"frames": 3}
    assert s["slam.step"]["count"] == 3 and s["slam.step"]["under"] == {}
    for name in ("slam.upload", "slam.replay", "slam.fetch",
                 "slam.frames_host"):
        assert s[name]["count"] == 3
        assert set(s[name]["under"]) == {"slam.step"}
    step_s = s["slam.step"]["total_ns"] * 1e-9
    assert sum(r.wall_time for r in recs) <= step_s


def test_marks_order_of_normal_and_redirect_frames(arc, monkeypatch):
    """A window opens with ``start``; a normal frame marks motion ...
    detect then telemetry, detection allowed or not; a redirect frame
    ``reset``, ``detect``, ``telemetry``."""
    log = []
    monkeypatch.setattr(vision, "stage_mark",
                        lambda dev, stage: log.append(stage))
    sess = _session(arc)
    k = sess.counter
    imgs = sess._to_device(sess._stack_window(k, 2))
    odo = sess._odo[k - 1:k + 2]
    for detect in (True, False):
        log.clear()
        state, rows = sess._frames(sess.state, imgs, odo, detect)
        assert rows.shape[0] == 2
        assert log == ["start"] + NORMAL * 2
    log.clear()
    sess._frames(sess.state, imgs[:1], odo[:2], True, redirect=True)
    assert log == ["start", "reset", "detect", "telemetry"]
    log.clear()
    sess.run(n_frames=4, chunk=4)
    assert log == ["start"] + NORMAL * 4


def test_marks_do_nothing_off_the_card(arc):
    """On the CPU a mark launches nothing and there are no stage times."""
    dev = torch.device("cpu")
    for stage in ("start",) + vision.STAGES:
        vision.stage_mark(dev, stage)
    assert vision.stage_times(dev) is None
    vision.reset_stage_times(dev)


@pytest.mark.parametrize("chunk", [4, 1])
def test_wall_times_sum_to_the_run(arc, chunk):
    """In a run, a record's wall time is the time since the previous
    materialization over the frames materialized with it: pipelined chunks
    count nothing twice and the records sum to the run's wall time."""
    sess = _session(arc)
    t0 = time.perf_counter()
    sess.run(n_frames=6, chunk=chunk)
    wall = time.perf_counter() - t0
    walls = np.array([r.wall_time for r in sess.records])
    assert len(walls) == 6 and np.all(walls > 0)
    assert walls.sum() <= wall
    assert walls.sum() >= 0.95 * wall - 0.005
    if chunk > 1:
        # the chunk's frames share its time, the tail steps their own
        assert len(set(walls[:4])) == 1 and walls[4] != walls[5]
