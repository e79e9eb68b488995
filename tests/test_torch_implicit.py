"""PyTorch port: the implicit large-state path, stage by stage, vs the JAX
package on a carried state.

A JAX engine with ``sigma_mode="implicit"`` is run (jitted) on the frozen
``bench3_grid`` fixture for a few frames at M = 12, so the map is real and
four slots stay inactive. The JAX state and cache entering each stage are
carried across as numpy arrays (``convert.state_from_arrays``); both
packages then run the same stage on the same inputs, float64 on the CPU.

Tolerance: 1e-8 absolute + 1e-9 relative on float fields (pixels ~1e2,
states ~1, Gram entries <= ~1), exact on integer and boolean fields. The
linearization ``h_lin`` (entries up to ~1e3 pixels per unit state, from a
10 x 10 solve whose matrix carries a 1e-9 relative floor) is held to 1e-6
absolute + 1e-7 relative. Where a factor comes from a Cholesky of a matrix
that is singular in exact arithmetic (feature integration), the factor is
held through its covariance S^T S to 4e-6 and the minor-repair counter
within one rung, as in ``test_torch_filter.py``.

Config 3 at full width (M = 576, D = 3460) is too slow for this suite in
float64; ``chip_smoke.py`` runs it on the card. Its reference numbers are the
JAX engine's on the same 80 frames of ``bench3_grid`` in float32 on a CPU,
produced by ``PYTHONPATH=. python tests/test_torch_implicit.py`` (about 2.5 minutes):
peak map 576, peak matched 515, 59 minor repairs, 0 escalated, 0 skipped,
chunk detect flags T F F F F T T F T T.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_monoslam_tpu.config import SlamConfig as JaxConfig
from cv_monoslam_tpu.filter import lifecycle as jlife
from cv_monoslam_tpu.filter import measurement as jmeas
from cv_monoslam_tpu.filter import srukf as jsrukf
from cv_monoslam_tpu.filter import state as jstate
from cv_monoslam_tpu.filter.motion import motion_predict as j_motion_predict
from cv_monoslam_tpu.filter.update import kalman_update as j_kalman_update
from cv_monoslam_tpu.frontend.matching import \
    data_association as j_data_association
from cv_monoslam_tpu.geometry import camera as jcam
from cv_monoslam_tpu.geometry import transforms as jtf
from cv_monoslam_tpu.io import fixtures as jfix
from cv_monoslam_tpu_torch.config import SlamConfig
from cv_monoslam_tpu_torch.convert import state_from_arrays, state_to_arrays
from cv_monoslam_tpu_torch.filter import lifecycle as tlife
from cv_monoslam_tpu_torch.filter.measurement import measurement_predict
from cv_monoslam_tpu_torch.filter.motion import motion_predict
from cv_monoslam_tpu_torch.filter.state import PredictCache
from cv_monoslam_tpu_torch.filter.update import kalman_update

KW = dict(max_landmarks=12, max_new_per_frame=4, max_detections=32,
          min_num=8, gate_detection=False, sigma_mode="implicit",
          min_step_xy=0.005, dtype="float64")
JCFG = JaxConfig(**KW)
TCFG = SlamConfig(**KW)

#: config 3 as ``bench.py`` runs it (``bench_large``), in both packages' terms
CONFIG3 = dict(max_landmarks=576, max_new_per_frame=64, max_detections=768,
               update_mode="gram", qr_mode="gram", sigma_mode="implicit",
               gate_detection=False, min_dist=10.0, min_num=480,
               n_initial_raws=768, n_process_raws=768, min_step_xy=0.005)


def _carry(jax_state):
    return state_from_arrays(state_to_arrays(jax_state), device="cpu")


def _t(a):
    return torch.as_tensor(np.array(a))


def _cache(jc):
    return PredictCache(
        sigma=None, sigma_pix=None, pred=_t(jc.pred),
        g_pred=None if jc.g_pred is None else _t(jc.g_pred),
        h_lin=None if jc.h_lin is None else _t(jc.h_lin))


def _close(got, want, name, rtol=1e-9, atol=1e-8):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=name)


def _assert_arrays_close(g, w, skip=()):
    assert set(g) == set(w)
    for k in w:
        if k in skip:
            continue
        if np.issubdtype(w[k].dtype, np.floating):
            _close(g[k], w[k], k)
        else:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _assert_state_close(got, want, skip=()):
    _assert_arrays_close(state_to_arrays(got), state_to_arrays(want), skip)


def _gram(s):
    s = np.asarray(s)
    return s.T @ s


@pytest.fixture(scope="module")
def run():
    """JAX intermediates of frame 4 (after 3 full frames on bench3_grid)."""
    seq, track, _, _ = jfix.load("bench3_grid", min_step_xy=0.005)
    odo = np.concatenate([track.xy, track.theta[:, None]], axis=1)
    imgs = [seq.get(int(track.frame_id[k])).astype(np.float64)
            for k in range(5)]
    s = jax.tree_util.tree_map(
        jnp.asarray, jstate.init_state(JCFG, theta0=float(track.theta[0])))
    s = jax.jit(lambda st, im: jsrukf.initialize(st, im, JCFG))(
        s, jnp.asarray(imgs[0]))
    step = jax.jit(lambda st, im, op, oc: jsrukf.slam_step(
        st, im, op, oc, False, JCFG)[0])
    for k in (1, 2, 3):
        s = step(s, jnp.asarray(imgs[k]), odo[k - 1], odo[k])
    k = 4
    r = dict(img=imgs[k], odo_prev=odo[k - 1], odo_cur=odo[k], s0=s)
    r["s1"], r["c1"] = j_motion_predict(s, jnp.asarray(odo[k - 1]),
                                        jnp.asarray(odo[k]), JCFG)
    r["s2"], r["c2"] = jmeas.measurement_predict(r["s1"], r["c1"], JCFG)
    r["s3"] = j_data_association(r["s2"], jnp.asarray(imgs[k]), JCFG)
    r["s4"] = j_kalman_update(r["s3"], r["c2"], JCFG)
    r["s5"] = jlife.update_features(r["s4"], JCFG)
    n_active = int(np.asarray(s.lm.active).sum())
    assert 0 < n_active < JCFG.max_landmarks      # inactive slots exist
    assert int(np.asarray(r["s3"].lm.matched).sum()) > 0
    return r


def test_motion_predict_implicit_matches_jax(run):
    st, cache = motion_predict(_carry(run["s0"]), _t(run["odo_prev"]),
                               _t(run["odo_cur"]), TCFG)
    _assert_state_close(st, run["s1"])
    assert cache.sigma is None and cache.sigma_pix is None
    _close(cache.g_pred, run["c1"].g_pred, "g_pred", atol=1e-12)
    # S is left stale: the predicted covariance lives in g_pred only
    np.testing.assert_array_equal(st.S.numpy(), np.asarray(run["s0"].S))


def _border_state(run):
    """s1 with one active landmark's anchor shifted along world x to the
    last position whose mean pixel is still inside the projection margin:
    some of its sigma points then leave the image and come back as the
    (0, 0) sentinel."""
    arrays = state_to_arrays(run["s1"])
    slot = int(np.flatnonzero(arrays["lm.active"])[0])
    x0 = arrays["x"]
    shifts = np.linspace(0.0, 4.0, 4001)
    feats = np.tile(x0[6 * slot:6 * slot + 6], (shifts.size, 1))
    feats[:, 0] += shifts
    rcw = jtf.yaw_matrix(jnp.asarray(x0[-1])).T
    hlw = jtf.state_to_world(jnp.asarray(feats), jnp.asarray(x0[-4:-1]))
    px = np.asarray(jcam.project(JCFG.camera,
                                 jnp.einsum("ij,kj->ki", rcw, hlw)))
    dead = np.all(px == 0.0, axis=-1)
    assert not dead[0] and dead.any()
    arrays["x"][6 * slot] += shifts[int(np.argmax(dead)) - 1]
    return arrays, slot


def test_measurement_predict_reduced_matches_jax(run, monkeypatch):
    """Includes a landmark at the image border, so the sentinel guard
    replaces dead sigma points, and four inactive slots."""
    arrays, slot = _border_state(run)
    js = jstate.replace(run["s1"], x=jnp.asarray(arrays["x"]))
    seen = []
    real = jmeas.cam_mod.project

    def spy(cam, hlr, *a):
        seen.append(np.asarray(real(cam, hlr, *a)))
        return real(cam, hlr, *a)

    monkeypatch.setattr(jmeas.cam_mod, "project", spy)
    want_s, want_c = jmeas.measurement_predict_reduced(js, run["c1"], JCFG)
    monkeypatch.undo()
    pix = seen[0][slot]                                   # (21, 2)
    dead = np.all(pix == 0.0, axis=-1)
    assert not dead[0] and dead[1:].any()       # the guard has work to do

    st, cache = measurement_predict(
        state_from_arrays(arrays, device="cpu"), _cache(run["c1"]), TCFG)
    _assert_state_close(st, want_s)
    _close(cache.pred, want_c.pred, "pred")
    _close(cache.h_lin, want_c.h_lin, "h_lin", rtol=1e-7, atol=1e-6)
    assert bool(st.lm.visible[slot])
    assert int(st.lm.visible.sum()) > 1
    assert not bool(st.lm.active.all())
    assert np.isfinite(cache.h_lin.numpy()).all()


def test_measurement_predict_reduced_failed_factor_is_zeroed(run):
    """A landmark whose 10 x 10 marginal is not PD: JAX's batched Cholesky
    returns NaN for that matrix only and the stage zeroes it; the port keys
    off the per-matrix ``info`` of ``cholesky_ex``."""
    g = np.array(run["c1"].g_pred)
    slot = int(np.flatnonzero(np.asarray(run["s1"].lm.active))[0])
    g[6 * slot, 6 * slot] = -1.0
    jc = dataclasses.replace(run["c1"], g_pred=jnp.asarray(g))
    want_s, want_c = jmeas.measurement_predict_reduced(run["s1"], jc, JCFG)
    st, cache = measurement_predict(_carry(run["s1"]), _cache(jc), TCFG)
    _assert_state_close(st, want_s)
    _close(cache.h_lin, want_c.h_lin, "h_lin", rtol=1e-7, atol=1e-6)
    assert float(cache.h_lin[slot].abs().max()) == 0.0


def test_stages_without_a_predicted_gram_match_jax(run):
    """Both stages also take a cache that carries no ``g_pred`` and then
    form the covariance blocks from ``state.S`` itself."""
    c1 = dataclasses.replace(run["c1"], g_pred=None)
    want_s, want_c = jmeas.measurement_predict_reduced(run["s1"], c1, JCFG)
    st, cache = measurement_predict(_carry(run["s1"]), _cache(c1), TCFG)
    _assert_state_close(st, want_s)
    _close(cache.h_lin, want_c.h_lin, "h_lin", rtol=1e-7, atol=1e-6)

    c2 = dataclasses.replace(run["c2"], g_pred=None)
    want = j_kalman_update(run["s3"], c2, JCFG)
    got = kalman_update(_carry(run["s3"]), _cache(c2), TCFG)
    _assert_state_close(got, want, skip=("S",))
    _close(_gram(got.S), _gram(want.S), "S^T S", atol=1e-10)


def _update_case(run, case):
    s3, c2 = run["s3"], run["c2"]
    if case == "no_match":
        s3 = jstate.replace(s3, lm=jstate.replace(
            s3.lm, matched=jnp.zeros_like(s3.lm.matched)))
    elif case == "unrepairable":
        # an indefinite predicted Gram: every rung of the ladder fails
        c2 = dataclasses.replace(c2, g_pred=-10.0 * c2.g_pred)
    elif case == "unrepairable_no_match":
        s3 = jstate.replace(s3, lm=jstate.replace(
            s3.lm, matched=jnp.zeros_like(s3.lm.matched)))
        c2 = dataclasses.replace(c2, g_pred=-10.0 * c2.g_pred)
    return s3, c2


@pytest.mark.parametrize("case", ["matched", "no_match", "unrepairable",
                                  "unrepairable_no_match"])
def test_update_gram_implicit_matches_jax(run, case):
    s3, c2 = _update_case(run, case)
    want = j_kalman_update(s3, c2, JCFG)
    got = kalman_update(_carry(s3), _cache(c2), TCFG)
    _assert_state_close(got, want, skip=("S",))
    _close(_gram(got.S), _gram(want.S), "S^T S", atol=1e-10)
    before = int(np.asarray(s3.n_skipped))
    if case.startswith("unrepairable"):
        # skipped counts ~ok whether or not anything matched, and S falls
        # back to the stale pre-motion factor
        assert int(got.n_skipped) == before + 1
        assert int(got.n_escalations) == int(s3.n_escalations) + 1
        np.testing.assert_array_equal(got.S.numpy(), np.asarray(s3.S))
        np.testing.assert_array_equal(got.x.numpy(), np.asarray(s3.x))
    else:
        assert int(got.n_skipped) == before
        assert np.abs(got.S.numpy() - np.asarray(s3.S)).max() > 0
    if case == "no_match":
        np.testing.assert_array_equal(got.x.numpy(), np.asarray(s3.x))


def test_update_raises_for_dist_chol_panel(run):
    """A panel width without an ambient mesh raises nothing and is ignored,
    as in the JAX package: the update is the single-device one bit for bit
    (the distributed factorization itself: tests/test_torch_dist_chol.py)."""
    cfg = SlamConfig(**{**KW, "dist_chol_panel": 64})
    got = kalman_update(_carry(run["s3"]), _cache(run["c2"]), cfg)
    want = kalman_update(_carry(run["s3"]), _cache(run["c2"]),
                         SlamConfig(**KW))
    np.testing.assert_array_equal(got.S.numpy(), want.S.numpy())
    np.testing.assert_array_equal(got.x.numpy(), want.x.numpy())


def _candidates(run):
    """Four candidate corners for the free slots of s5, two of them
    invalid."""
    corners = np.array([[200.0, 150.0], [420.5, 300.25], [0.0, 0.0],
                        [333.0, 90.0]])
    valid = np.array([True, True, False, False])
    return corners, valid


@pytest.mark.parametrize("fold", [True, False])
def test_integrate_implicit_matches_jax(run, fold):
    """Through the sqrt fold (default) and through the refactorizing
    fallback; S_new after the fold is not triangular, by design."""
    kw = {**KW, "integrate_fold": fold}
    jcfg, tcfg = JaxConfig(**kw), SlamConfig(**kw)
    corners, valid = _candidates(run)
    s, img = run["s5"], run["img"]
    want = jlife.integrate_features(s, jnp.asarray(img), jnp.asarray(corners),
                                    jnp.asarray(valid), jcfg)
    got = tlife.integrate_features(_carry(s), _t(img), _t(corners),
                                   _t(valid), tcfg)
    g, w = state_to_arrays(got), state_to_arrays(want)
    np.testing.assert_allclose(_gram(g["S"]), _gram(w["S"]), rtol=0,
                               atol=4e-6)
    assert abs(int(g["n_repairs"]) - int(w["n_repairs"])) <= 1
    _assert_arrays_close(g, w, skip=("S", "n_repairs"))
    assert int(got.lm.active.sum()) == int(s.lm.active.sum()) + 2
    lower = np.abs(np.tril(g["S"], -1)).max()
    assert (lower > 0) == fold


def jax_config3_reference():
    """The JAX engine on config 3 as ``bench.py`` drives it (two warm-up
    chunks of 8, then 64 frames in chunks of 8), float32 on the CPU: the
    counters ``chip_smoke.py`` holds the port to."""
    from cv_monoslam_tpu.api import SlamSession as JaxSession

    seq, track, gt_xy, _ = jfix.load("bench3_grid", min_step_xy=0.005)
    sess = JaxSession(JaxConfig(**CONFIG3), seq, track)
    flags = []
    real = sess._chunk_fn

    def spy(k, detect=True):
        flags.append(bool(detect))
        return real(k, detect)

    sess._chunk_fn = spy
    sess.detect_host_gate = True
    sess.step_chunk(8)
    sess._last_matched = sess.cfg.min_num
    sess.step_chunk(8)
    sess._last_matched = sess.records[-1].n_matched
    sess.detect_gate_margin = 0
    n0 = len(sess.records)
    sess.run(n_frames=64, chunk=8, drop_tail=True)
    recs = sess.records
    return dict(frames=len(recs) - n0, ate_m=sess.ate(gt_xy),
                peak_map=max(r.n_map for r in recs),
                peak_matched=max(r.n_matched for r in recs),
                repairs=recs[-1].n_repairs,
                escalations=recs[-1].n_escalations,
                skipped=recs[-1].n_skipped, detect_flags=flags,
                n_map=[r.n_map for r in recs],
                n_matched=[r.n_matched for r in recs],
                finite=bool(np.isfinite(sess.trajectory).all()))


if __name__ == "__main__":
    print(json.dumps(jax_config3_reference()))
    sys.exit(0)
