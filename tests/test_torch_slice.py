"""PyTorch port: the config-1 frame loop end to end vs the JAX engine.

Both sessions run the first 24 frames of the frozen ``bench1_arc`` fixture
at the config-1 capacities in float64 on the CPU, chunked by 8. On the CPU
the JAX session's ``vision_backend="auto"`` takes its XLA path (grouped-conv
NCC, gather bilinear), so this holds the port's plain vision versions
against those; ``test_torch_vision.py`` holds them against the Pallas
kernels in interpret mode.

Tolerance: per-frame map size and match count equal (no discrete decision
may flip), pose max |diff| <= 1e-6.
"""

import os
import subprocess
import sys

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


@pytest.mark.parametrize("change", [
    dict(sigma_mode="implicit"), dict(update_mode="batched"),
    dict(update_mode="sequential")])
def test_unported_modes_raise(change):
    seq, track, _, _ = tfix.load("bench1_arc")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sess = SlamSession(SlamConfig(**{**KW, **change}), seq, track,
                           device="cpu")
        sess.step()


def test_redirect_frame_raises():
    seq, track, _, _ = tfix.load("bench1_arc")
    track.redirect[2] = True
    sess = SlamSession(SlamConfig(**KW), seq, track, device="cpu")
    sess.step()
    with pytest.raises(NotImplementedError, match="redirect"):
        sess.step()
