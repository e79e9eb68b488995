"""The per-layer metrics read from the program's own measurements
(``slambench/program.py``): the stage times, the host spans and counters,
and the stage marks of a profiled trace, on hand-built values; and nothing
where the program keeps none."""

import pytest

from slambench import harness, program, trace

M_STAGES = ("motion", "measure", "associate", "update", "maintain",
            "detect", "telemetry")


def _mark(stage, a):
    return (f"(anonymous namespace)::stage_mark_{stage}_kernel(long long*)",
            a, a + 1.0)


def _replay(t0, frames):
    """One replay's device ops: ``start``, then per frame a kernel of 10 us
    and the frame's marks, 2 us apart."""
    ops, t = [_mark("start", t0)], t0 + 2.0
    for _ in range(frames):
        ops.append(("some_kernel", t, t + 10.0))
        t += 12.0
        for s in M_STAGES:
            ops.append(_mark(s, t))
            t += 2.0
    return ops, t


def _trace(device, frames, wall_us):
    return trace.Trace(frames=frames, window_us=1e3, device=device, host=[],
                       wall_us_per_frame=wall_us, M=32)


def _two_replays():
    """Two replays of two frames, 20 us apart: each spans 53 us from its
    start mark's start to its last mark's end, 15 marks of 1 us and 2
    kernels of 10 us busy inside it."""
    a, end = _replay(0.0, 2)
    b, _ = _replay(end + 20.0, 2)
    return a + b


def test_mark_stage_names():
    assert program.mark_stage(_mark("detect", 0.0)[0]) == "detect"
    assert program.mark_stage("stage_mark_start_kernel") == "start"
    assert program.mark_stage("warp_ncc_score_map_kernel<17, 21, 21>") is None


def test_replays_and_busy_within():
    t = _trace(_two_replays(), frames=4, wall_us=100.0)
    reps = program.replays(t)
    assert len(reps) == 2
    assert [b - a for a, b in reps] == [53.0, 53.0]
    assert program.busy_within(t, reps) == pytest.approx(2 * 35.0)


def test_graph_idle_pct():
    t = _trace(_two_replays(), frames=4, wall_us=100.0)
    got = harness.metric("graph_idle_pct.replay").read(t, {})
    assert got == pytest.approx(100.0 * (1 - 35.0 / 53.0))
    assert harness.metric("graph_idle_pct.replay").read(
        _trace([("some_kernel", 0.0, 5.0)], 4, 100.0), {}) is None


#: the accumulators over 10 unprofiled frames and the 4 traced ones
STAGES = dict(motion=2e6, measure=1e6, associate=4e6, update=8e6,
              maintain=5e5, detect=3e6, telemetry=1e5, reset=0, frames=10)


def _with_traced(stages, t):
    """``stages`` (over the unprofiled frames) plus the trace's marks."""
    traced = program.traced_stages(t)
    return {k: v + traced.get(k, 0.0) for k, v in stages.items()}


def test_traced_stages_are_the_accumulators_arithmetic():
    t = _trace(_two_replays(), frames=4, wall_us=40.0)
    tr = program.traced_stages(t)
    assert tr["frames"] == 4
    # each frame: motion from the previous mark's start (start: 2 + 12 =
    # 14 us, then 12 + 2), every other mark 2 us after the one before
    assert tr["motion"] == pytest.approx((14.0 + 14.0) * 2 * 1e3)
    for s in M_STAGES[1:]:
        assert tr[s] == pytest.approx(4 * 2.0 * 1e3)


@pytest.mark.parametrize("name", ["outside_graph_ms_per_frame.replay",
                                  "outside_graph_ms_per_frame.live"])
def test_outside_graph(monkeypatch, name):
    """The outermost spans' wall, captures out but their waits in, less
    the unprofiled in-graph time, a frame."""
    t = _trace(_two_replays(), frames=4, wall_us=40.0)
    monkeypatch.setattr(program, "stage_times",
                        lambda: _with_traced(STAGES, t))
    monkeypatch.setattr(program, "totals", lambda: TOTALS)
    inside = sum(v for k, v in STAGES.items() if k != "frames") / 10
    wall = (900e6 + 50e6 + 0) - (150e6 - 30e6)     # run, dispatch outside it
    got = harness.metric(name).read(t, {})
    assert got == pytest.approx((wall / 1000 - inside) / 1e6)
    monkeypatch.setattr(program, "stage_times", lambda: None)
    assert harness.metric(name).read(t, {}) is None


@pytest.mark.parametrize("name,ns", [
    ("predict_ms_per_frame.replay", 3e6),
    ("associate_ms_per_frame.replay", 4e6),
    ("update_ms_per_frame.replay", 8e6),
    ("maintain_ms_per_frame.replay", 5e5),
    ("detect_ms_per_frame.replay", 3e6),
])
def test_stage_metrics(monkeypatch, name, ns):
    """The unprofiled frames' stage times: the profiled stretch's marks,
    as the trace holds them, taken out."""
    t = _trace(_two_replays(), frames=4, wall_us=40.0)
    monkeypatch.setattr(program, "stage_times",
                        lambda: _with_traced(STAGES, t))
    assert harness.metric(name).read(t, {}) == pytest.approx(ns / 10 / 1e6)
    monkeypatch.setattr(program, "stage_times", lambda: None)
    assert harness.metric(name).read(t, {}) is None


TOTALS = {"spans": {
    "slam.run": dict(count=1, total_ns=900e6, self_ns=1e6, under={}),
    "slam.dispatch": dict(count=50, total_ns=300e6, self_ns=20e6,
                          under={"slam.run": 250e6}),
    "slam.step": dict(count=40, total_ns=200e6, self_ns=10e6,
                      under={"slam.run": 200e6}),
    "slam.wait": dict(count=90, total_ns=150e6, self_ns=150e6,
                      under={"slam.step": 80e6, "slam.finish": 40e6,
                             "slam.capture": 30e6}),
    "slam.capture": dict(count=3, total_ns=150e6, self_ns=120e6,
                         under={"slam.dispatch": 100e6,
                                "slam.step": 50e6})},
    "counters": {"frames": 1000, "chunks_detect": 20}}


@pytest.mark.parametrize("name,ms", [
    ("dispatch_ms_per_frame.replay", (300e6 - 100e6) / 1000 / 1e6),
    ("step_host_ms_per_frame.live", (200e6 - 80e6 - 50e6) / 1000 / 1e6),
])
def test_span_metrics(monkeypatch, name, ms):
    t = _trace(_two_replays(), frames=4, wall_us=40.0)
    monkeypatch.setattr(program, "totals", lambda: TOTALS)
    assert harness.metric(name).read(t, {}) == pytest.approx(ms)
    # spans of a run that saw no device: the eager route off the card
    assert harness.metric(name).read(_trace([], 4, 40.0), {}) is None
    for empty in (None, {"spans": {}, "counters": {}}):
        monkeypatch.setattr(program, "totals", lambda: empty)
        assert harness.metric(name).read(t, {}) is None


def test_readers_find_nothing_off_the_card(monkeypatch):
    """Off the card the program keeps no stage times; its totals are read
    as they are."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert program.stage_times() is None
    assert program.stage_ms_per_frame(_trace([], 4, 40.0), "detect") is None
    assert isinstance(program.totals(), dict)
