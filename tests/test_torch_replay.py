"""PyTorch port: ``backend.replay`` vs the JAX package.

One telemetry stream is captured from the port's float64 filter over all 119
tracked frames of the frozen ``bench4_lap`` fixture at config 4's width (the
backend never feeds the filter, so the stream is the same whatever backend
is attached), and replayed through a fresh ``BackendSession`` of each
package, at the shipped window-BA gate (inf) and at gate 3.0. Held: equal
keyframes, loop edges ``(i, j)``, edge-log paths / inlier counts / reasons,
pending and validated places, refinement count and which solves applied;
every keyframe pose, landmark set, loop measurement, solved pose and the
refined trajectory composed from either backend to 1e-6 (float64 solvers on
identical inputs; only roundoff differs).
"""

import pytest
from test_torch_backend import _assert_same_backend, _close

from cv_monoslam_tpu.backend import replay as jreplay
from cv_monoslam_tpu.config import SlamConfig as JaxConfig
from cv_monoslam_tpu_torch.api import SlamSession
from cv_monoslam_tpu_torch.backend import replay as treplay
from cv_monoslam_tpu_torch.config import SlamConfig
from cv_monoslam_tpu_torch.io import fixtures as tfix

LAP_KW = dict(max_landmarks=16, max_new_per_frame=4, max_detections=32,
              keyframe_every=5, ba_window=4, dtype="float64")


@pytest.fixture(scope="module")
def captured():
    """Telemetry of the port's float64 filter over all of ``bench4_lap``."""
    seq, track, gt_xy, _ = tfix.load("bench4_lap")
    cap = treplay.TelemetryCapture()
    sess = SlamSession(SlamConfig(**LAP_KW), seq, track, backend=cap,
                       device="cpu")
    sess.run(chunk=8)
    assert len(cap.calls) == len(sess.records) == len(track) - 1
    assert sess.refinements == []
    return cap.calls, sess, gt_xy


@pytest.mark.parametrize("gate", [None, 3.0])
def test_replay_matches_jax(captured, gate):
    calls, sess, gt_xy = captured
    jb, jref = jreplay.replay(calls, JaxConfig(**LAP_KW), ba_apply_gate=gate)
    tb, tref = treplay.replay(calls, SlamConfig(**LAP_KW),
                              ba_apply_gate=gate, device="cpu")
    _assert_same_backend(tb, jb)
    assert len(tb.keyframes) >= 15 and len(tb.loop_edges) >= 1
    assert len(tref) == len(jref)
    for a, b in zip(tref, jref):
        assert sorted(a) == sorted(b)
        if "max_z" in a:
            assert a["applied"] == b["applied"] and a["frames"] == b["frames"]
            _close(a["poses"], b["poses"], rtol=0, atol=1e-6)
            _close(a["max_z"], b["max_z"], rtol=1e-5, atol=1e-6)
        else:
            assert a["n_loop_edges"] == b["n_loop_edges"]
            _close(a["nodes"], b["nodes"], rtol=0, atol=1e-6)
    ts, js = tb.summary(tref), jb.summary(jref)
    for k in ("keyframes", "loop_edges", "edge_candidates", "rejected",
              "ba_solves", "ba_applied", "graph_solves"):
        assert ts[k] == js[k], k
    if gate is None:
        assert ts["ba_applied"] == 0          # the shipped gate is inf
    # the refined trajectory composed from either backend
    sess.backend = tb
    t_ref, ate_t = sess.trajectory_refined, sess.ate(gt_xy, refined=True)
    sess.backend = jb
    _close(t_ref, sess.trajectory_refined, rtol=0, atol=1e-6)
    _close(ate_t, sess.ate(gt_xy, refined=True), rtol=0, atol=1e-6)
    sess.backend = None
