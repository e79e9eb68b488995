"""PyTorch port: each filter stage vs the JAX package on a carried state.

A JAX engine is run (jitted) on the frozen ``bench1_arc`` fixture (a few
frames, so the map is real), and the JAX state and sigma cache entering
each stage are carried across to the port as numpy arrays
(``convert.state_from_arrays``). Both packages then run the same stage on
the same inputs, float64 on the CPU, and every field of the outputs is
compared.

Tolerance: 1e-8 absolute + 1e-9 relative on float fields (pixels ~1e2,
states ~1, factors ~1e-3..1), exact on integer and boolean fields — the
stages compute the same float64 arithmetic through different libraries,
so only roundoff differs, and no discrete decision may flip (except the
one roundoff-decided repair rung of feature integration, see
``test_add_features_matches_jax``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_monoslam_tpu.config import SlamConfig as JaxConfig
from cv_monoslam_tpu.filter import lifecycle as jlife
from cv_monoslam_tpu.filter import srukf as jsrukf
from cv_monoslam_tpu.filter import state as jstate
from cv_monoslam_tpu.filter.measurement import \
    measurement_predict as j_measurement_predict
from cv_monoslam_tpu.filter.motion import motion_predict as j_motion_predict
from cv_monoslam_tpu.filter.update import kalman_update as j_kalman_update
from cv_monoslam_tpu.frontend.matching import \
    data_association as j_data_association
from cv_monoslam_tpu.io import fixtures as jfix
from cv_monoslam_tpu_torch.config import SlamConfig
from cv_monoslam_tpu_torch.convert import state_from_arrays, state_to_arrays
from cv_monoslam_tpu_torch.filter import lifecycle as tlife
from cv_monoslam_tpu_torch.filter import srukf as tsrukf
from cv_monoslam_tpu_torch.filter.measurement import (chol2x2_upper,
                                                      measurement_predict)
from cv_monoslam_tpu_torch.filter.motion import motion_predict
from cv_monoslam_tpu_torch.filter.state import PredictCache
from cv_monoslam_tpu_torch.filter.update import kalman_update
from cv_monoslam_tpu_torch.frontend.matching import data_association

KW = dict(max_landmarks=8, max_new_per_frame=4, max_detections=24,
          dtype="float64")
JCFG = JaxConfig(**KW)
TCFG = SlamConfig(**KW)


def _carry(jax_state):
    return state_from_arrays(state_to_arrays(jax_state), device="cpu")


def _cache(jc):
    return PredictCache(sigma=torch.as_tensor(np.array(jc.sigma)),
                        sigma_pix=torch.as_tensor(np.array(jc.sigma_pix)),
                        pred=torch.as_tensor(np.array(jc.pred)))


def _assert_state_close(got, want):
    _assert_arrays_close(state_to_arrays(got), state_to_arrays(want))


def _assert_arrays_close(g, w):
    assert set(g) == set(w)
    for k in w:
        if np.issubdtype(w[k].dtype, np.floating):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-9, atol=1e-8,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(scope="module")
def run():
    """JAX intermediates of frame 4 (after 3 full frames on bench1_arc)."""
    seq, track, _, _ = jfix.load("bench1_arc")
    odo = np.concatenate([track.xy, track.theta[:, None]], axis=1)
    imgs = [seq.get(int(track.frame_id[k])).astype(np.float64)
            for k in range(5)]
    s0 = jax.tree_util.tree_map(
        jnp.asarray, jstate.init_state(JCFG, theta0=float(track.theta[0])))
    s = jax.jit(lambda st, im: jsrukf.initialize(st, im, JCFG))(
        s0, jnp.asarray(imgs[0]))
    r = dict(init_in=s0, init_out=s, img0=imgs[0])
    step = jax.jit(lambda st, im, op, oc: jsrukf.slam_step(
        st, im, op, oc, False, JCFG)[0])
    for k in (1, 2, 3):
        s = step(s, jnp.asarray(imgs[k]), odo[k - 1], odo[k])
    k = 4
    r.update(img=imgs[k], odo_prev=odo[k - 1], odo_cur=odo[k], s0=s)
    r["s1"], r["c1"] = j_motion_predict(s, jnp.asarray(odo[k - 1]),
                                        jnp.asarray(odo[k]), JCFG)
    r["s2"], r["c2"] = j_measurement_predict(r["s1"], r["c1"], JCFG)
    r["s3"] = j_data_association(r["s2"], jnp.asarray(imgs[k]), JCFG)
    r["s4"] = j_kalman_update(r["s3"], r["c2"], JCFG)
    r["s5"] = jlife.update_features(r["s4"], JCFG)
    # a matched landmark predicted at the border: deleted AND stored
    arrays = state_to_arrays(r["s4"])
    live = arrays["lm.active"] & arrays["lm.matched"]
    r["slot"] = slot = int(np.flatnonzero(live)[0])
    arrays["lm.pred"][slot] = [5.0, 100.0]
    r["s4b_arrays"] = arrays
    r["s5b"] = jlife.update_features(dataclasses.replace(
        r["s4"], lm=dataclasses.replace(
            r["s4"].lm, pred=jnp.asarray(arrays["lm.pred"]))), JCFG)
    return r


def test_initialize_matches_jax(run):
    got = tsrukf.initialize(_carry(run["init_in"]),
                            torch.as_tensor(run["img0"]), TCFG)
    _assert_state_close(got, run["init_out"])
    assert int(got.lm.active.sum()) > 0


def test_motion_predict_matches_jax(run):
    st, cache = motion_predict(_carry(run["s0"]),
                               torch.as_tensor(run["odo_prev"]),
                               torch.as_tensor(run["odo_cur"]), TCFG)
    _assert_state_close(st, run["s1"])
    np.testing.assert_allclose(cache.sigma.numpy(),
                               np.asarray(run["c1"].sigma), rtol=1e-9,
                               atol=1e-10)


def test_measurement_predict_matches_jax(run):
    st, cache = measurement_predict(_carry(run["s1"]), _cache(run["c1"]),
                                    TCFG)
    _assert_state_close(st, run["s2"])
    np.testing.assert_allclose(cache.sigma_pix.numpy(),
                               np.asarray(run["c2"].sigma_pix), rtol=1e-9,
                               atol=1e-8)
    np.testing.assert_allclose(cache.pred.numpy(),
                               np.asarray(run["c2"].pred), rtol=1e-9,
                               atol=1e-8)
    assert int(st.lm.visible.sum()) > 0


def test_data_association_matches_jax(run):
    st = data_association(_carry(run["s2"]), torch.as_tensor(run["img"]),
                          TCFG)
    _assert_state_close(st, run["s3"])
    assert int(st.lm.matched.sum()) > 0


def test_kalman_update_matches_jax(run):
    st = kalman_update(_carry(run["s3"]), _cache(run["c2"]), TCFG)
    _assert_state_close(st, run["s4"])


def test_update_features_matches_jax(run):
    _assert_state_close(tlife.update_features(_carry(run["s4"]), TCFG),
                        run["s5"])


def test_update_features_delete_and_store_match_jax(run):
    """A matched landmark predicted at the border is deleted AND stored:
    exercises fold_delete's refactorization and store_features."""
    got = tlife.update_features(
        state_from_arrays(run["s4b_arrays"], device="cpu"), TCFG)
    _assert_state_close(got, run["s5b"])
    slot = run["slot"]
    assert not bool(got.lm.active[slot])
    assert int(got.stored.valid.sum()) == 1


def test_add_features_matches_jax(run):
    """On the state with a freed slot (the delete test's), so a new
    feature is integrated.

    The integration Gram is singular in exact arithmetic: a new landmark's
    position rows copy the robot's, so each one adds three zero eigenvalues
    (about -1e-15 after roundoff in float64). Whether the clean Cholesky
    succeeds or takes the 1x jitter rung is then decided by roundoff, in
    either package. So here the factor is held through its covariance
    S^T S, to 4e-6 absolute (the jitter rung shifts the equilibrated
    diagonal by 1e-6 of a unit scale; covariance entries here are <= ~1),
    and n_repairs within one rung; every other field as in the other
    tests."""
    img, s = run["img"], run["s5b"]
    want = jax.jit(lambda st, im: jsrukf.add_features(
        st, im, JCFG, should_add=True))(s, jnp.asarray(img))
    got = tsrukf.add_features(_carry(s), torch.as_tensor(img), TCFG,
                              should_add=True)
    g, w = state_to_arrays(got), state_to_arrays(want)
    np.testing.assert_allclose(g["S"].T @ g["S"], w["S"].T @ w["S"],
                               rtol=0, atol=4e-6)
    assert abs(int(g["n_repairs"]) - int(w["n_repairs"])) <= 1
    for k in ("S", "n_repairs"):
        g[k] = w[k]
    _assert_arrays_close(g, w)
    assert int(got.next_id) > int(s.next_id)             # features added


def test_chol2x2_upper_inverts_gram():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(20, 2, 5))
    g = torch.as_tensor(np.einsum("mis,mjs->mij", a, a))
    s = chol2x2_upper(g)
    torch.testing.assert_close(s.transpose(-1, -2) @ s, g, rtol=1e-12,
                               atol=1e-12)
    assert float(s[:, 1, 0].abs().max()) == 0.0


# -- the other update modes, on the cases of tests/test_sigma_update.py ----------

UCFG = dict(max_landmarks=4, dtype="float64")


def _update_case(matched_slots, seed, s_scale=0.1):
    """A synthetic sigma cloud with a linear pixel map per slot, as
    ``tests/test_sigma_update.py::make_cache`` builds it; numpy arrays."""
    from cv_monoslam_tpu.filter.sigma import generate_sigma, ut_weights

    cfg = JaxConfig(**UCFG)
    rng = np.random.default_rng(seed)
    D, M = cfg.state_dim, cfg.max_landmarks
    na = D + 5
    S0 = np.linalg.qr(rng.normal(size=(D, D)) * s_scale)[1]
    x0 = rng.normal(size=D)
    w = ut_weights(na, cfg)
    S_aug = np.zeros((na, na))
    S_aug[:D, :D] = S0
    S_aug[D:D + 3, D:D + 3] = np.eye(3) * 0.01
    sig = np.asarray(generate_sigma(
        jnp.asarray(np.concatenate([x0, np.zeros(5)])), jnp.asarray(S_aug),
        w.gamma))
    Hs = rng.normal(size=(M, 2, D)) * 0.5
    pix = np.einsum("mij,js->mis", Hs, sig[:D])
    pred = pix @ np.asarray(w.mean_weights(jnp.float64))
    matched = np.zeros(M, bool)
    matched[matched_slots] = True
    z = pred + rng.normal(size=pred.shape) * 0.5
    # the innovation sqrt factors the sequential mode reads (upper 2 x 2)
    dz = w.wi_sr * (pix[:, :, 1:] - pix[:, :, :1])
    pyy = np.einsum("mis,mjs->mij", dz, dz) + \
        cfg.sigma_measure ** 2 * np.eye(2)
    si = np.stack([np.linalg.cholesky(p).T for p in pyy])
    return dict(x=x0, S=S0, sigma=sig, pix=pix, pred=pred, z=z,
                matched=matched, si=si)


def _run_update(case, **mode):
    jcfg, tcfg = JaxConfig(**UCFG, **mode), SlamConfig(**UCFG, **mode)
    js = jstate.init_state(jcfg)
    js = jstate.replace(
        js, x=jnp.asarray(case["x"]), S=jnp.asarray(case["S"]),
        lm=jstate.replace(
            js.lm, matched=jnp.asarray(case["matched"]),
            active=jnp.ones(4, bool), pred=jnp.asarray(case["pred"]),
            match_px=jnp.asarray(case["z"]), si=jnp.asarray(case["si"])))
    jc = jstate.PredictCache(sigma=jnp.asarray(case["sigma"]),
                             sigma_pix=jnp.asarray(case["pix"]),
                             pred=jnp.asarray(case["pred"]))
    want = j_kalman_update(js, jc, jcfg)
    got = kalman_update(_carry(js), _cache(jc), tcfg)
    return got, want


@pytest.mark.parametrize("mode", [
    dict(update_mode="batched"),
    dict(update_mode="sequential"),
    dict(update_mode="sequential", downdate_mode="gmw")],
    ids=["batched", "sequential", "sequential-gmw"])
@pytest.mark.parametrize("slots", [[0, 2], [1], []],
                         ids=["two", "one", "none"])
def test_kalman_update_other_modes_match_jax(mode, slots):
    """float64, 1e-8: the state, and the factor through S^T S and |S|
    (a QR's R is unique up to row signs)."""
    case = _update_case(slots, seed=3 + len(slots))
    got, want = _run_update(case, **mode)
    g, w = state_to_arrays(got), state_to_arrays(want)
    np.testing.assert_allclose(g["x"], w["x"], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(g["S"].T @ g["S"], w["S"].T @ w["S"],
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.abs(g["S"]), np.abs(w["S"]), rtol=1e-7,
                               atol=1e-8)
    if not slots:                      # no match: an exact no-op
        np.testing.assert_array_equal(g["x"], case["x"])
        np.testing.assert_array_equal(g["S"], case["S"])
    for k in ("x", "S"):
        g[k] = w[k]
    _assert_arrays_close(g, w)


def test_batched_update_matches_dense_conditional():
    """The joint QR-Schur result is the dense conditional Gaussian, and
    corrupting an unmatched slot's deviations changes nothing."""
    from cv_monoslam_tpu.filter.sigma import ut_weights

    case = _update_case([0, 2], seed=11)
    got, _ = _run_update(case, update_mode="batched")
    cfg = JaxConfig(**UCFG)
    D = cfg.state_dim
    w = ut_weights(D + 5, cfg)
    A = w.wi_sr * (case["sigma"][:D, 1:] - case["sigma"][:D, :1]).T
    rows = [0, 1, 4, 5]
    pix = case["pix"].reshape(8, -1)
    Z = w.wi_sr * (pix[rows, 1:] - pix[rows, :1]).T
    Pyy = Z.T @ Z + cfg.sigma_measure ** 2 * np.eye(4)
    K = (A.T @ Z) @ np.linalg.inv(Pyy)
    nu = (case["z"] - case["pred"])[[0, 2]].reshape(-1)
    np.testing.assert_allclose(got.x.numpy(), case["x"] + K @ nu, atol=1e-8)
    P = got.S.numpy().T @ got.S.numpy()
    np.testing.assert_allclose(P, A.T @ A - K @ Pyy @ K.T, atol=1e-8)
    assert np.linalg.eigvalsh(P).min() > -1e-10
    bad = dict(case, pix=case["pix"].copy())
    bad["pix"][1] += 1000.0
    bad["pix"][3] -= 777.0
    got2, _ = _run_update(bad, update_mode="batched")
    np.testing.assert_allclose(got2.x.numpy(), got.x.numpy(), atol=1e-8)
