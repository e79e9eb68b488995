"""PyTorch port: the config-1 frame loop end to end vs the JAX engine.

Both sessions run the first 24 frames of the frozen ``bench1_arc`` fixture
at the config-1 capacities in float64 on the CPU, chunked by 8. On the CPU
the JAX session's ``vision_backend="auto"`` takes its XLA path (grouped-conv
NCC, gather bilinear), so this holds the port's plain vision versions
against those; ``test_torch_vision.py`` holds them against the Pallas
kernels in interpret mode.

Tolerance: per-frame map size and match count equal (no discrete decision
may flip), pose max |diff| <= 1e-6.

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
    dict(update_mode="batched"), dict(update_mode="sequential"),
    dict(qr_mode="cholqr2"), dict(dist_chol_panel=64),
    dict(dist_chol_panel=64, sigma_mode="implicit")])
def test_unported_modes_raise(change):
    seq, track, _, _ = tfix.load("bench1_arc")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sess = SlamSession(SlamConfig(**{**KW, **change}), seq, track,
                           device="cpu")
        sess.step()


@pytest.mark.parametrize("arg", ["recorder", "backend"])
def test_unported_session_arguments_raise(arg):
    seq, track, _, _ = tfix.load("bench1_arc")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SlamSession(SlamConfig(**KW), seq, track, device="cpu",
                    **{arg: object()})
