"""PyTorch port: the config-1 frame loop end to end vs the JAX engine.

Both sessions run the first 24 frames of the frozen ``bench1_arc`` fixture
at the config-1 capacities in float64 on the CPU, chunked by 8. On the CPU
the JAX session's ``vision_backend="auto"`` takes its XLA path (grouped-conv
NCC, gather bilinear), so this holds the port's plain vision versions
against those; ``test_torch_vision.py`` holds them against the Pallas
kernels in interpret mode.

Tolerance: per-frame map size and match count equal (no discrete decision
may flip), pose max |diff| <= 1e-6.

Config 4 (the keyframe backend behind ``SlamSession(backend=)``) is held the
same way on the first 48 frames of ``bench4_lap`` in float64: equal per-frame
map / matches, keyframes, loop edges and refinements; pose and refined pose
<= 1e-6 up to the first frame whose integration Cholesky takes a
roundoff-decided jitter rung in one package only, <= 2e-4 after it (see the
test); and the live backend equals capture + replay exactly. Run as a script
(``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_slice.py``) this
file prints the JAX engine's float32 CPU numbers on all 119 frames.

Two more sessions are held the same way: the implicit large-state path with
host-gated detection on 16 frames of ``bench3_grid`` at M = 48 (both gate
cadences; the per-chunk detect flags must be the JAX session's), and config
1 on 24 frames of ``bench1_arc`` with a redirection frame forced at frame 12
(no committed fixture holds one).
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from cv_monoslam_tpu.api import SlamSession as JaxSession
from cv_monoslam_tpu.config import SlamConfig as JaxConfig
from cv_monoslam_tpu.io import fixtures as jfix
from cv_monoslam_tpu_torch.api import SlamSession
from cv_monoslam_tpu_torch.config import SlamConfig
from cv_monoslam_tpu_torch.io import fixtures as tfix

ROOT = os.path.join(os.path.dirname(__file__), "..")
KW = dict(max_landmarks=32, max_new_per_frame=8, max_detections=48,
          dtype="float64")


def test_slice_follows_jax_engine_24_frames():
    jseq, jtrack, _, _ = jfix.load("bench1_arc")
    tseq, ttrack, _, _ = tfix.load("bench1_arc")
    np.testing.assert_array_equal(ttrack.frame_id, jtrack.frame_id)
    js = JaxSession(JaxConfig(**KW), jseq, jtrack)
    js.run(n_frames=24, chunk=8)
    ts = SlamSession(SlamConfig(**KW), tseq, ttrack, device="cpu")
    ts.run(n_frames=24, chunk=8)
    assert len(ts.records) == len(js.records) == 24
    for a, b in zip(ts.records, js.records):
        assert (a.frame, a.n_map, a.n_matched) == \
            (b.frame, b.n_map, b.n_matched)
        assert (a.n_repairs, a.n_escalations, a.n_skipped) == \
            (b.n_repairs, b.n_escalations, b.n_skipped)
    assert np.abs(ts.trajectory - js.trajectory).max() <= 1e-6
    assert min(r.n_matched for r in ts.records) > 0


def test_import_loads_no_jax():
    """The port and its session API import neither JAX nor anything of the
    JAX package (whose name is a prefix of the port's)."""
    code = (
        "import sys\n"
        "import cv_monoslam_tpu_torch, cv_monoslam_tpu_torch.api\n"
        "import cv_monoslam_tpu_torch.utils.checkpoint\n"
        "import cv_monoslam_tpu_torch.utils.watchdog\n"
        "import cv_monoslam_tpu_torch.utils.profiling\n"
        "import cv_monoslam_tpu_torch.backend.ba\n"
        "import cv_monoslam_tpu_torch.backend.pose_graph\n"
        "import cv_monoslam_tpu_torch.backend.session\n"
        "import cv_monoslam_tpu_torch.backend.replay\n"
        "import cv_monoslam_tpu_torch.cli, cv_monoslam_tpu_torch.__main__\n"
        "import cv_monoslam_tpu_torch.viz\n"
        "import cv_monoslam_tpu_torch.io.recording\n"
        "import cv_monoslam_tpu_torch.io.synthetic\n"
        "import cv_monoslam_tpu_torch.io.video\n"
        "import cv_monoslam_tpu_torch.parallel.mesh\n"
        "import cv_monoslam_tpu_torch.parallel.launch\n"
        "import cv_monoslam_tpu_torch.parallel.dist_chol\n"
        "import cv_monoslam_tpu_torch.parallel.dist_ba\n"
        "import cv_monoslam_tpu_torch.parallel.spmd\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'cv_monoslam_tpu' or m.startswith('cv_monoslam_tpu.')]\n"
        "print(','.join(bad))\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, (out.stdout, out.stderr)


def test_session_without_device_raises_on_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    seq, track, _, _ = tfix.load("bench1_arc")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlamSession(SlamConfig(**KW), seq, track)


IMPLICIT_KW = dict(max_landmarks=48, max_new_per_frame=16, max_detections=96,
                   min_num=24, gate_detection=False, sigma_mode="implicit",
                   min_step_xy=0.005, dtype="float64")


def _assert_same_records(ts, js, n):
    assert len(ts.records) == len(js.records) == n
    for a, b in zip(ts.records, js.records):
        assert (a.frame, a.n_map, a.n_matched, a.redirected) == \
            (b.frame, b.n_map, b.n_matched, b.redirected)
        assert (a.n_repairs, a.n_escalations, a.n_skipped) == \
            (b.n_repairs, b.n_escalations, b.n_skipped)
    assert np.abs(ts.trajectory - js.trajectory).max() <= 1e-6


@pytest.mark.parametrize("margin", [None, 0])
def test_implicit_slice_follows_jax_engine_16_frames(margin):
    """``margin=None``: each chunk's gate reads the chunk just finished.
    ``margin=0``: the JAX session dispatches chunk i + 1 before it finishes
    chunk i, so that gate reads the end of chunk i - 1; the port must pick
    the same flags without overlapping anything."""
    jseq, jtrack, _, _ = jfix.load("bench3_grid", min_step_xy=0.005)
    tseq, ttrack, _, _ = tfix.load("bench3_grid", min_step_xy=0.005)
    np.testing.assert_array_equal(ttrack.frame_id, jtrack.frame_id)
    js = JaxSession(JaxConfig(**IMPLICIT_KW), jseq, jtrack)
    jflags = []
    real = js._chunk_fn

    def spy(k, detect=True):
        jflags.append(bool(detect))
        return real(k, detect)

    js._chunk_fn = spy
    ts = SlamSession(SlamConfig(**IMPLICIT_KW), tseq, ttrack, device="cpu")
    for sess in (js, ts):
        sess.detect_host_gate = True
        sess.detect_gate_margin = margin
        with warnings.catch_warnings():
            warnings.simplefilter("error")        # min_num > max_new: silent
            sess.run(n_frames=16, chunk=4)
    _assert_same_records(ts, js, 16)
    assert ts.chunk_detect == jflags
    assert ts.chunk_detect == ([True, True, False, False] if margin == 0
                               else [True, False, False, False])
    assert max(r.n_matched for r in ts.records) >= 24


def test_stale_gate_warns_at_small_min_num():
    """The JAX session's warning: a one-chunk-stale gate with no cushion at
    a ``min_num`` one starved stretch can undercut."""
    seq, track, _, _ = tfix.load("bench1_arc")
    sess = SlamSession(SlamConfig(**KW), seq, track, device="cpu")
    sess.detect_host_gate = True
    sess.detect_gate_margin = 0
    with pytest.warns(UserWarning, match="stale gate"):
        sess.run(n_frames=4, chunk=4)
    assert len(sess.records) == 4


def test_redirect_slice_follows_jax_engine_24_frames():
    jseq, jtrack, _, _ = jfix.load("bench1_arc")
    tseq, ttrack, _, _ = tfix.load("bench1_arc")
    jtrack.redirect[12] = True
    ttrack.redirect[12] = True
    js = JaxSession(JaxConfig(**KW), jseq, jtrack)
    js.run(n_frames=24, chunk=8)
    ts = SlamSession(SlamConfig(**KW), tseq, ttrack, device="cpu")
    ts.run(n_frames=24, chunk=8)
    _assert_same_records(ts, js, 24)
    assert [r.frame for r in ts.records if r.redirected] == [12]
    assert int(ts.state.lm.is_loop.sum()) == \
        int(np.asarray(js.state.lm.is_loop).sum())
    assert min(r.n_matched for r in ts.records[12:]) > 0


@pytest.mark.parametrize("change", [
    dict(dist_chol_panel=64),
    dict(dist_chol_panel=64, sigma_mode="implicit")])
def test_unported_modes_raise(change):
    """No mode raises any more: a session with a panel width and no ambient
    mesh runs the single-device factorization, frame for frame the same as
    one without (``parallel.set_mesh`` makes it distributed; the tests of
    that are tests/test_torch_dist_chol.py)."""
    seq, track, _, _ = tfix.load("bench1_arc")
    poses = []
    for extra in (change, {k: v for k, v in change.items()
                           if k != "dist_chol_panel"}):
        sess = SlamSession(SlamConfig(**{**KW, **extra}), seq, track,
                           device="cpu")
        sess.run(n_frames=4, chunk=4)
        poses.append(sess.trajectory)
    np.testing.assert_array_equal(poses[0], poses[1])


SMALL_KW = dict(max_landmarks=8, max_new_per_frame=4, max_detections=24,
                dtype="float64")


@pytest.mark.parametrize("change", [
    dict(update_mode="batched"), dict(qr_mode="cholqr2"),
    dict(qr_mode="householder", update_mode="batched")])
def test_equivalent_modes_follow_the_default_session(change):
    """``batched`` is the same posterior as ``gram`` and ``cholqr2`` /
    ``householder`` the same factor as the Gram shortcut, up to roundoff:
    6 frames at M = 8 in float64, equal map / matches, pose <= 1e-6."""
    seq, track, _, _ = tfix.load("bench1_arc")
    ref = SlamSession(SlamConfig(**SMALL_KW), seq, track, device="cpu")
    ref.run(n_frames=6)
    got = SlamSession(SlamConfig(**{**SMALL_KW, **change}), seq, track,
                      device="cpu")
    got.run(n_frames=6)
    assert [(r.n_map, r.n_matched) for r in got.records] == \
        [(r.n_map, r.n_matched) for r in ref.records]
    assert np.abs(got.trajectory - ref.trajectory).max() <= 1e-6
    assert min(r.n_matched for r in got.records) > 0


@pytest.mark.parametrize("downdate", ["hyperbolic", "gmw"])
def test_sequential_mode_runs_in_a_session(downdate):
    """The reference-faithful mode double-counts information by design (at
    this width it starts losing matches after a few frames, in the JAX
    engine too), so the session is held to running and to tracking its
    first frames; ``test_torch_filter.py`` holds the update itself against
    the JAX package."""
    seq, track, gt_xy, _ = tfix.load("bench1_arc")
    sess = SlamSession(
        SlamConfig(**{**SMALL_KW, "update_mode": "sequential",
                      "downdate_mode": downdate}),
        seq, track, device="cpu")
    sess.run(n_frames=4)
    assert len(sess.records) == 4 and np.isfinite(sess.trajectory).all()
    assert [r.n_matched for r in sess.records[:3]] == [4, 4, 6]
    assert bool(torch.isfinite(sess.state.S).all())
    assert sess.ate(gt_xy) < 0.05


# -- config 4: the keyframe backend behind SlamSession(backend=) ----------------

LAP_KW = dict(max_landmarks=16, max_new_per_frame=4, max_detections=32,
              keyframe_every=5, ba_window=4)


def _lap_sessions(n_frames, dtype="float64"):
    """The port's session with a live backend and with capture + replay on
    the first ``n_frames`` frames of ``bench4_lap`` at config 4's width."""
    from cv_monoslam_tpu_torch.backend.replay import TelemetryCapture, replay
    from cv_monoslam_tpu_torch.backend.session import BackendSession

    seq, track, gt_xy, _ = tfix.load("bench4_lap")
    cfg = SlamConfig(**LAP_KW, dtype=dtype)
    live = SlamSession(cfg, seq, track, device="cpu",
                       backend=BackendSession(cfg, device="cpu"))
    live.run(n_frames=n_frames, chunk=8)
    cap = TelemetryCapture()
    filt = SlamSession(cfg, seq, track, device="cpu", backend=cap)
    filt.run(n_frames=n_frames, chunk=8)
    be, refinements = replay(cap.calls, cfg, device="cpu")
    return live, filt, be, refinements, gt_xy


@pytest.fixture(scope="module")
def lap48():
    return _lap_sessions(48)


def test_backend_slice_follows_jax_engine_48_frames(lap48):
    from cv_monoslam_tpu.backend.session import \
        BackendSession as JaxBackendSession

    ts, _, _, _, gt_xy = lap48
    jseq, jtrack, jgt, _ = jfix.load("bench4_lap")
    jcfg = JaxConfig(**LAP_KW, dtype="float64")
    js = JaxSession(jcfg, jseq, jtrack, backend=JaxBackendSession(jcfg))
    js.run(n_frames=48, chunk=8)
    # Feature integration's first jitter rung is decided by roundoff in
    # either package (tests/test_torch_filter.py::
    # test_add_features_matches_jax) and this starved run integrates on most
    # frames: one such frame shifts S by 1e-6 of its scale and the pose by
    # ~1e-5 from there on. So: pose <= 1e-6 on every frame up to the first
    # one where the minor-repair counts differ (at least 24 frames, four
    # keyframes), <= 2e-4 after it; every discrete result equal throughout.
    assert len(ts.records) == len(js.records) == 48
    for a, b in zip(ts.records, js.records):
        assert (a.frame, a.n_map, a.n_matched, a.redirected) == \
            (b.frame, b.n_map, b.n_matched, b.redirected)
        assert (a.n_escalations, a.n_skipped) == \
            (b.n_escalations, b.n_skipped) == (0, 0)
    same = [a.n_repairs == b.n_repairs
            for a, b in zip(ts.records, js.records)]
    n_same = same.index(False) if False in same else 48
    assert n_same >= 24
    assert abs(ts.records[-1].n_repairs - js.records[-1].n_repairs) <= 2

    def close(got, want):
        d = np.abs(got - want).max(axis=1)
        assert d[:n_same].max() <= 1e-6 and d.max() <= 2e-4, d

    close(ts.trajectory, js.trajectory)
    tb, jb = ts.backend, js.backend
    assert [k.frame for k in tb.keyframes] == [k.frame for k in jb.keyframes]
    assert len(tb.keyframes) >= 8
    assert [(i, j) for i, j, _, _ in tb.loop_edges] == \
        [(i, j) for i, j, _, _ in jb.loop_edges]
    assert [e.get("reason") for e in tb.edge_log] == \
        [e.get("reason") for e in jb.edge_log]
    for a, b in zip(tb.keyframes, jb.keyframes):
        np.testing.assert_array_equal(a.lids, b.lids)
        np.testing.assert_array_equal(a.map_lids, b.map_lids)
        tol = 1e-6 if a.frame <= n_same else 2e-4
        assert np.abs(a.pose - b.pose).max() <= tol
    assert len(ts.refinements) == len(js.refinements) > 0
    for a, b in zip(ts.refinements, js.refinements):
        assert a["frames"] == b["frames"] and a["applied"] == b["applied"]
        tol = 1e-6 if a["frames"][-1] <= n_same else 2e-4
        np.testing.assert_allclose(a["poses"], b["poses"], rtol=0, atol=tol)
        np.testing.assert_allclose(a["rmse_after"], b["rmse_after"],
                                   rtol=0, atol=1e3 * tol)
    close(ts.trajectory_refined, js.trajectory_refined)
    assert abs(ts.ate(gt_xy, refined=True)
               - js.ate(jgt, refined=True)) <= 2e-4
    assert abs(ts.ate(gt_xy) - js.ate(jgt)) <= 2e-4
    assert ts.timer.n_frames == 48 and ts.timer.mean_time > 0


def test_live_backend_equals_capture_and_replay_exactly(lap48):
    """The replay module's promise: the backend never feeds the filter, so
    one captured run replayed is the live run, bit for bit."""
    live, filt, be, refinements, gt_xy = lap48
    np.testing.assert_array_equal(live.trajectory, filt.trajectory)
    lb = live.backend
    assert [k.frame for k in lb.keyframes] == [k.frame for k in be.keyframes]
    assert [(i, j) for i, j, _, _ in lb.loop_edges] == \
        [(i, j) for i, j, _, _ in be.loop_edges]
    for a, b in zip(lb.keyframes, be.keyframes):
        for f in ("pose", "pose0", "pose_filter", "xyz", "map_xyz"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert len(live.refinements) == len(refinements)
    for a, b in zip(live.refinements, refinements):
        np.testing.assert_array_equal(a.get("poses", a.get("nodes")),
                                      b.get("poses", b.get("nodes")))
    assert filt.refinements == [] and filt.backend.keyframes == []
    filt.backend, filt.refinements = be, refinements
    np.testing.assert_array_equal(filt.trajectory_refined,
                                  live.trajectory_refined)
    assert filt.ate(gt_xy, refined=True) == live.ate(gt_xy, refined=True)
    # before the first keyframe nothing is re-anchored
    first = lb.keyframes[0].frame
    n0 = sum(r.frame < first for r in live.records)
    np.testing.assert_array_equal(live.trajectory_refined[:n0],
                                  live.trajectory[:n0])


def test_backend_stops_the_stale_gate_cadence():
    """The JAX session stops pipelining when a backend is attached, so with
    a margin set the gate still reads the chunk just finished: the flags of
    the ``margin=None`` cadence, not the one-chunk-stale ones (see
    ``test_implicit_slice_follows_jax_engine_16_frames``), and no
    stale-gate warning."""
    from cv_monoslam_tpu_torch.backend.replay import TelemetryCapture

    seq, track, _, _ = tfix.load("bench3_grid", min_step_xy=0.005)
    flags = {}
    for name, backend in (("none", None), ("capture", TelemetryCapture())):
        sess = SlamSession(SlamConfig(**IMPLICIT_KW), seq, track,
                           device="cpu", backend=backend)
        sess.detect_host_gate = True
        sess.detect_gate_margin = 0
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            sess.run(n_frames=16, chunk=4)
        flags[name] = sess.chunk_detect
    assert flags["none"] == [True, True, False, False]
    assert flags["capture"] == [True, False, False, False]
    assert len(backend.calls) == 16


def jax_cpu_float32_numbers():
    """The JAX engine on all of ``bench4_lap`` at config 4's width, float32
    on the CPU, as ``bench.py``'s ``bench_backend`` runs it: the constants
    ``chip_smoke.py`` prints beside the card's numbers."""
    from cv_monoslam_tpu.backend.replay import TelemetryCapture, replay

    seq, track, gt_xy, _ = jfix.load("bench4_lap")
    cfg = JaxConfig(**LAP_KW)
    cap = TelemetryCapture()
    sess = JaxSession(cfg, seq, track, backend=cap)
    sess.run(chunk=8)
    out = dict(frames=len(sess.records), ate_filter=float(sess.ate(gt_xy)),
               repairs=sess.records[-1].n_repairs,
               escalations=sess.records[-1].n_escalations,
               skipped=sess.records[-1].n_skipped)
    be, refinements = replay(cap.calls, cfg)
    sess.backend, sess.refinements = be, refinements
    out["ate_refined"] = float(sess.ate(gt_xy, refined=True))
    be_g, _ = replay(cap.calls, cfg, ba_apply_gate=3.0)
    sess.backend = be_g
    out["ate_window_gate3"] = float(sess.ate(gt_xy, refined=True))
    out.update(keyframes=len(be.keyframes),
               loop_edges=[(i, j) for i, j, _, _ in be.loop_edges])
    return out


if __name__ == "__main__":
    import json

    print(json.dumps(jax_cpu_float32_numbers()))
