"""PyTorch port: the redirect branch vs the JAX package on a carried state.

A JAX engine is run (jitted) on the frozen ``bench1_arc`` fixture for three
frames at M = 8, and the state is carried across as numpy arrays
(``convert.state_from_arrays``). Both packages then run each function of the
redirect branch on the same inputs, float64 on the CPU.

Tolerance: 1e-8 absolute + 1e-9 relative on float fields, exact on integer
and boolean fields. ``add_features(is_redirect=True)`` integrates new
features through a Cholesky of a Gram that is singular in exact arithmetic,
so there the factor is held through S^T S to 4e-6 and the minor-repair
counter within one rung (see ``test_torch_filter.py``).

No committed fixture holds a redirection frame, so the slice-level test
(``test_torch_slice.py``) and ``chip_smoke.py`` force ``track.redirect[k]``
on ``bench1_arc``; the heading does not change there, so the stored
landmarks project onto their own corners and come back as loop re-adds.
``PYTHONPATH=. python tests/test_torch_redirect.py`` prints what the JAX
engine gives on the first 48 frames with ``redirect[24]`` forced, the counts
the card's run is held to: in float32 and in float64 alike, map size 5 after
the branch, 5 landmarks back with ``is_loop``, 4 records left valid in the
stored table (older border deletions out of view), 1 redirected record, mean
matches 5.0 over the frames after it.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_monoslam_tpu.config import SlamConfig as JaxConfig
from cv_monoslam_tpu.filter import lifecycle as jlife
from cv_monoslam_tpu.filter import srukf as jsrukf
from cv_monoslam_tpu.filter import state as jstate
from cv_monoslam_tpu.io import fixtures as jfix
from cv_monoslam_tpu_torch.config import SlamConfig
from cv_monoslam_tpu_torch.convert import state_from_arrays, state_to_arrays
from cv_monoslam_tpu_torch.filter import lifecycle as tlife
from cv_monoslam_tpu_torch.filter import srukf as tsrukf

KW = dict(max_landmarks=8, max_new_per_frame=4, max_detections=24,
          dtype="float64")
JCFG = JaxConfig(**KW)
TCFG = SlamConfig(**KW)


def _carry(jax_state):
    return state_from_arrays(state_to_arrays(jax_state), device="cpu")


def _assert_arrays_close(g, w, skip=()):
    assert set(g) == set(w)
    for k in w:
        if k in skip:
            continue
        if np.issubdtype(w[k].dtype, np.floating):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-9, atol=1e-8,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _assert_state_close(got, want, skip=()):
    _assert_arrays_close(state_to_arrays(got), state_to_arrays(want), skip)


@pytest.fixture(scope="module")
def run():
    """JAX state after 3 frames on bench1_arc, its redirect reset, and a
    crowded variant of the reset state with only two free slots."""
    seq, track, _, _ = jfix.load("bench1_arc")
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
    assert int(np.asarray(s.lm.active).sum()) >= 4
    r = dict(s=s, img=imgs[4], odo_prev=odo[3], odo_cur=odo[4])
    r["reset"] = jlife.redirect_reset(s, jnp.asarray(odo[4][2]), JCFG)
    arrays = state_to_arrays(r["reset"])
    arrays["lm.active"][:6] = True
    r["crowded"] = arrays
    return r


def test_redirect_reset_matches_jax(run):
    got = tlife.redirect_reset(_carry(run["s"]),
                               torch.as_tensor(run["odo_cur"][2]), TCFG)
    _assert_state_close(got, run["reset"])
    n = int(np.asarray(run["s"].lm.active).sum())
    assert int(got.stored.valid.sum()) == n
    assert not bool(got.lm.active.any())
    assert float(got.x[-1]) == run["odo_cur"][2]


def test_project_stored_matches_jax(run):
    got = tlife.project_stored(_carry(run["reset"]), TCFG)
    want = np.asarray(jlife.project_stored(run["reset"], JCFG))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-8)
    assert (want != 0).any()


def _crowded_jax(run):
    template = run["reset"]
    return jstate.replace(template, lm=jstate.replace(
        template.lm, active=jnp.asarray(run["crowded"]["lm.active"])))


@pytest.mark.parametrize("case", ["all_free", "more_than_free", "none_set"])
def test_readd_stored_matches_jax(run, case):
    """Stored records come back in table order, each into the first slot
    free after the previous one was filled; with more set entries than free
    slots the rest stay valid in the table."""
    js = run["reset"] if case != "more_than_free" else _crowded_jax(run)
    mask = np.asarray(js.stored.valid).copy()
    if case == "none_set":
        mask[:] = False
    n_set = int(mask.sum())
    n_free = int((~np.asarray(js.lm.active)).sum())
    want = jlife.readd_stored(js, jnp.asarray(mask), JCFG)
    got = tlife.readd_stored(_carry(js), torch.as_tensor(mask), TCFG)
    _assert_state_close(got, want)
    back = min(n_set, n_free)
    assert int(got.lm.is_loop.sum()) == back
    assert int(got.stored.valid.sum()) == \
        int(np.asarray(js.stored.valid).sum()) - back
    if case == "more_than_free":
        assert n_set > n_free == 2 and int(got.stored.valid.sum()) > 0


def test_add_features_redirect_matches_jax(run):
    """Loop-point detection on the reset state: corners near a stored
    feature's projected pixel re-add that feature, the rest are new."""
    img, s = run["img"], run["reset"]
    want = jax.jit(lambda st, im: jsrukf.add_features(
        st, im, JCFG, is_redirect=True, should_add=True))(s, jnp.asarray(img))
    got = tsrukf.add_features(_carry(s), torch.as_tensor(img), TCFG,
                              is_redirect=True, should_add=True)
    g, w = state_to_arrays(got), state_to_arrays(want)
    np.testing.assert_allclose(g["S"].T @ g["S"], w["S"].T @ w["S"],
                               rtol=0, atol=4e-6)
    assert abs(int(g["n_repairs"]) - int(w["n_repairs"])) <= 1
    _assert_arrays_close(g, w, skip=("S", "n_repairs"))
    assert int(got.lm.is_loop.sum()) > 0                 # loop re-adds
    assert int(got.lm.active.sum()) > 0


def test_slam_step_redirect_branch_matches_jax(run):
    s, img = run["s"], run["img"]
    want_s, want_o = jax.jit(lambda st, im, op, oc: jsrukf.slam_step(
        st, im, op, oc, True, JCFG))(s, jnp.asarray(img), run["odo_prev"],
                                     run["odo_cur"])
    got_s, got_o = tsrukf.slam_step(
        _carry(s), torch.as_tensor(img), torch.as_tensor(run["odo_prev"]),
        torch.as_tensor(run["odo_cur"]), True, TCFG)
    assert bool(got_o["redirected"]) and bool(want_o["redirected"])
    g, w = state_to_arrays(got_s), state_to_arrays(want_s)
    np.testing.assert_allclose(g["S"].T @ g["S"], w["S"].T @ w["S"],
                               rtol=0, atol=4e-6)
    assert abs(int(g["n_repairs"]) - int(w["n_repairs"])) <= 1
    _assert_arrays_close(g, w, skip=("S", "n_repairs"))
    for k in ("n_map", "n_matched", "n_visible"):
        assert int(got_o[k]) == int(want_o[k])
    assert int(got_s.frame) == int(s.frame) + 1


def jax_redirect_reference(dtype: str, n_frames: int = 48, at: int = 24):
    """The JAX engine at the config-1 capacities on the first ``n_frames``
    frames of bench1_arc with ``redirect[at]`` forced: the three counts
    ``chip_smoke.py`` expects on the redirect frame."""
    from cv_monoslam_tpu.api import SlamSession as JaxSession

    seq, track, _, _ = jfix.load("bench1_arc")
    track.redirect[at] = True
    cfg = JaxConfig(max_landmarks=32, max_new_per_frame=8, max_detections=48,
                    dtype=dtype)
    sess = JaxSession(cfg, seq, track)
    sess.run(n_frames=at - 1, chunk=1)
    rec = sess.step()
    assert rec.redirected and rec.frame == at
    out = dict(dtype=dtype, n_map=rec.n_map,
               n_loop=int(np.asarray(sess.state.lm.is_loop).sum()),
               stored_valid=int(np.asarray(sess.state.stored.valid).sum()))
    sess.run(n_frames=n_frames - at, chunk=1)
    after = [r.n_matched for r in sess.records[at:]]
    out.update(redirected=sum(r.redirected for r in sess.records),
               matched_mean_after=float(np.mean(after)),
               frames=len(sess.records))
    return out


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    for dt in ("float32", "float64"):
        print(json.dumps(jax_redirect_reference(dt)))
    sys.exit(0)
