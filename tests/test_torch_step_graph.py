"""PyTorch port: what a step graph and a non-default mode's chunk graph hold,
on the CPU.

On the card ``SlamSession.step()`` replays a captured graph of one frame,
the redirect branch's too, and every update / QR mode takes the graph
route; a capture fails on any host read. Here, float64 against the JAX
package, each piece runs under ``ops.host_reads.no_host_reads()`` (the
gates' sanctioned reads, ``control.host_bool``, pass):

* ``readd_stored`` on fixed shapes, against the JAX scan: more records than
  free slots, none set, all set; exact (it only moves values);
* ``kalman_update`` in ``batched``, ``sequential`` and ``sequential`` +
  ``gmw`` after a warm call, against JAX at 1e-8 (the cases of
  ``test_torch_filter.py``); the sequential loop reads each of its M gates
  once;
* ``qr_r`` in ``householder`` and ``cholqr2`` after a warm call, against JAX:
  R^T R and |R| at 1e-10 (a QR's R is unique up to row signs);
* ``slam_step`` on a redirect frame, against JAX at
  ``test_torch_redirect.py``'s tolerances;
* the session's routing: ``step()`` of a redirection frame runs the
  redirect branch through ``_chunk_fn(1, True, True)``; ``_graph_route``
  no longer looks at the modes;
* (``slow``, the JAX sessions compile for ~10-30 s each) a session per
  non-default mode at M = 8 for 4 frames by ``step()``: every discrete
  telemetry field equal to the JAX session's, poses to 1e-8.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_monoslam_tpu import ops as jops
from cv_monoslam_tpu.config import SlamConfig as JaxConfig
from cv_monoslam_tpu.filter import lifecycle as jlife
from cv_monoslam_tpu.filter import srukf as jsrukf
from cv_monoslam_tpu.filter import state as jstate
from cv_monoslam_tpu.filter.update import kalman_update as j_kalman_update
from cv_monoslam_tpu_torch import ops as tops
from cv_monoslam_tpu_torch.api import SlamSession
from cv_monoslam_tpu_torch.config import SlamConfig
from cv_monoslam_tpu_torch.convert import state_from_arrays, state_to_arrays
from cv_monoslam_tpu_torch.filter import lifecycle as tlife
from cv_monoslam_tpu_torch.filter import srukf as tsrukf
from cv_monoslam_tpu_torch.filter.update import kalman_update
from cv_monoslam_tpu_torch.io import fixtures as tfix
from cv_monoslam_tpu_torch.ops import control
from cv_monoslam_tpu_torch.ops.host_reads import no_host_reads

from test_torch_filter import UCFG, _cache, _update_case
from test_torch_redirect import (JCFG, TCFG, _assert_arrays_close,
                                 run)  # noqa: F401  (a fixture)


def _carry(jax_state):
    return state_from_arrays(state_to_arrays(jax_state), device="cpu")


# -- readd_stored ------------------------------------------------------------


def _stored_state(n_free: int, seed: int):
    """A JAX state at M = 8 with ``n_free`` inactive slots, a random x and
    S, and a stored table of K = 12 valid records with random contents."""
    rng = np.random.default_rng(seed)
    cfg = JaxConfig(max_landmarks=8, dtype="float64")
    s = jstate.init_state(cfg, max_stored=12)
    D, K = cfg.state_dim, 12
    active = np.ones(8, bool)
    active[rng.choice(8, n_free, replace=False)] = False
    sd = s.stored
    p = sd.init_patch.shape[-1]
    stored = jstate.replace(
        sd, valid=jnp.ones(K, bool),
        lid=jnp.asarray(100 + np.arange(K), jnp.int32),
        state=jnp.asarray(rng.normal(size=(K, 6))),
        sr=jnp.asarray(np.triu(rng.normal(size=(K, 6, 6)))),
        init_pixel=jnp.asarray(rng.normal(size=(K, 2))),
        init_trans=jnp.asarray(rng.normal(size=(K, 3))),
        init_theta=jnp.asarray(rng.normal(size=K)),
        init_patch=jnp.asarray(rng.normal(size=(K, p, p)), jnp.float32),
        xyz=jnp.asarray(rng.normal(size=(K, 3))))
    lm = jstate.replace(
        s.lm, active=jnp.asarray(active),
        lid=jnp.asarray(rng.integers(0, 50, 8), jnp.int32),
        n_predict=jnp.asarray(rng.integers(1, 9, 8), jnp.int32),
        visible=jnp.asarray(active), matched=jnp.asarray(active))
    return cfg, jstate.replace(
        s, x=jnp.asarray(rng.normal(size=D)),
        S=jnp.asarray(np.triu(rng.normal(size=(D, D)))), lm=lm,
        stored=stored)


@pytest.mark.parametrize("case", ["more_than_free", "none_set", "all_set"])
def test_readd_stored_fixed_shapes_match_jax(case):
    """Exact: the r-th set record into the r-th free slot, the records
    beyond the free slots left valid; no host read."""
    n_free = 3 if case == "more_than_free" else 8
    cfg, js = _stored_state(n_free, seed=len(case))
    mask = np.zeros(12, bool)
    if case == "more_than_free":
        mask[[1, 4, 5, 9, 11]] = True
    elif case == "all_set":
        mask[:8] = True
    want = jlife.readd_stored(js, jnp.asarray(mask), cfg)
    ts = _carry(js)
    with no_host_reads():
        got = tlife.readd_stored(ts, torch.as_tensor(mask),
                                 SlamConfig(max_landmarks=8,
                                            dtype="float64"))
    g, w = state_to_arrays(got), state_to_arrays(want)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    back = min(int(mask.sum()), n_free)
    assert int(got.lm.is_loop.sum()) == back
    assert int(got.stored.valid.sum()) == 12 - back


# -- the update and QR modes ------------------------------------------------------


@pytest.mark.parametrize("mode", [
    dict(update_mode="batched"),
    dict(update_mode="sequential"),
    dict(update_mode="sequential", downdate_mode="gmw")],
    ids=["batched", "sequential", "sequential-gmw"])
def test_kalman_update_modes_read_nothing_but_their_gates(mode, monkeypatch):
    """1e-8 against JAX (as ``test_torch_filter.py``); under the guard
    after a warm call; the sequential loop's M gates, one host read each,
    and nothing else."""
    case = _update_case([0, 2], seed=5)
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
    kalman_update(_carry(js), _cache(jc), tcfg)             # warm call
    ts, tc = _carry(js), _cache(jc)
    reads = []
    real = control.host_bool
    monkeypatch.setattr(control, "host_bool",
                        lambda p: reads.append(1) or real(p))
    with no_host_reads():
        got = kalman_update(ts, tc, tcfg)
    assert len(reads) == (4 if mode["update_mode"] == "sequential" else 0)
    g, w = state_to_arrays(got), state_to_arrays(want)
    np.testing.assert_allclose(g["x"], w["x"], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(g["S"].T @ g["S"], w["S"].T @ w["S"],
                               rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("mode", ["householder", "cholqr2"])
def test_qr_r_modes_read_nothing(mode):
    a = np.random.default_rng(3).normal(size=(40, 12)) * np.logspace(0, -2, 12)
    ta = torch.as_tensor(a)
    tops.qr_r(ta, mode)                                     # warm call
    with no_host_reads():
        got = tops.qr_r(ta, mode)
    got = got.numpy()
    want = np.asarray(jops.qr_r(jnp.asarray(a), mode))
    np.testing.assert_allclose(got.T @ got, want.T @ want, rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=1e-10,
                               atol=1e-12)


# -- the redirect branch ----------------------------------------------------------


def test_slam_step_redirect_frame_reads_nothing(run):
    """The redirect branch (snapshot, reset, loop re-adds, re-detection)
    under the guard, against JAX at ``test_torch_redirect.py``'s
    tolerances (S through S^T S to 4e-6, the minor-repair counter within
    one rung)."""
    s, img = run["s"], run["img"]
    want_s, want_o = jax.jit(lambda st, im, op, oc: jsrukf.slam_step(
        st, im, op, oc, True, JCFG))(s, jnp.asarray(img), run["odo_prev"],
                                     run["odo_cur"])
    args = (torch.as_tensor(img), torch.as_tensor(run["odo_prev"]),
            torch.as_tensor(run["odo_cur"]))
    tsrukf.slam_step(_carry(s), *args, True, TCFG)          # warm call
    ts = _carry(s)
    with no_host_reads():
        got_s, got_o = tsrukf.slam_step(ts, *args, True, TCFG)
    g, w = state_to_arrays(got_s), state_to_arrays(want_s)
    np.testing.assert_allclose(g["S"].T @ g["S"], w["S"].T @ w["S"],
                               rtol=0, atol=4e-6)
    assert abs(int(g["n_repairs"]) - int(w["n_repairs"])) <= 1
    _assert_arrays_close(g, w, skip=("S", "n_repairs"))
    assert int(got_s.lm.is_loop.sum()) > 0
    for k in ("n_map", "n_matched", "n_visible", "redirected"):
        assert int(got_o[k]) == int(want_o[k])


# -- the session's routing --------------------------------------------------------


SESSION_KW = dict(max_landmarks=8, max_new_per_frame=4, max_detections=24,
                  dtype="float64")


def test_step_of_a_redirection_frame_takes_the_redirect_key(monkeypatch):
    """``step()`` asks ``_chunk_fn`` for one frame with the frame's redirect
    flag (the key of its graph on the card) and records what that frame's
    eager run gives; on the CPU ``_chunk_fn`` is the eager loop."""
    seq, track, _, _ = tfix.load("bench1_arc")
    track.redirect[2] = True
    sess = SlamSession(SlamConfig(**SESSION_KW), seq, track, device="cpu")
    keys = []
    real = SlamSession._chunk_fn

    def chunk_fn(self, k, detect=True, redirect=False):
        keys.append((k, detect, redirect))
        return real(self, k, detect, redirect)

    monkeypatch.setattr(SlamSession, "_chunk_fn", chunk_fn)
    state1 = control.tree_map(torch.clone, sess.state)
    recs = [sess.step(), sess.step()]
    assert keys == [(1, True, False), (1, True, True)]
    assert [r.redirected for r in recs] == [False, True]
    s, out = tsrukf.slam_step(
        state1, torch.as_tensor(seq.get(int(track.frame_id[1])),
                                dtype=torch.float64),
        sess._odo[0], sess._odo[1], False, sess.cfg)
    assert recs[0].n_map == int(out["n_map"])
    np.testing.assert_array_equal(recs[0].pose,
                                  out["pose"].numpy().astype(np.float32))


@pytest.mark.parametrize("mode", [
    dict(update_mode="sequential", downdate_mode="gmw", qr_mode="householder"),
    dict(update_mode="batched", qr_mode="cholqr2")])
def test_graph_route_takes_every_mode(mode):
    """On the card every update / QR mode takes the graph route; the CPU,
    the private switch and a ``gloo`` mesh do not (a stub session)."""
    for device, graphs, want in (("cuda", True, True), ("cpu", True, False),
                                 ("cuda", False, False)):
        sess = types.SimpleNamespace(_graphs=graphs,
                                     cfg=SlamConfig(**mode),
                                     device=torch.device(device))
        assert SlamSession._graph_route(sess) == want


# -- sessions in the non-default modes against the JAX session ---------------------


@pytest.mark.slow
@pytest.mark.parametrize("mode", [
    dict(update_mode="sequential"),
    dict(update_mode="sequential", downdate_mode="gmw", qr_mode="householder"),
    dict(update_mode="batched", qr_mode="householder"),
    dict(qr_mode="cholqr2")],
    ids=["sequential", "sequential-gmw-householder", "batched-householder",
         "gram-cholqr2"])
def test_session_modes_match_jax(mode):
    """3 frames of ``bench1_arc`` at M = 8 by ``step()``, without subpixel
    refinement: map, visible, matched and redirect telemetry equal on every
    frame; the first frame's pose to 1e-5, the next two to 1e-3. Both
    packages match in float32 (the frames' NCC), which moves a pose by
    ~1e-6 on the first frame; the sequential modes' double counting of
    information amplifies that to ~4e-4 by the third (the parent commit
    gives the same differences). The repair counters are not compared: they
    count jitter rungs that roundoff decides (in ``cholqr2`` mode the JAX
    session takes one per frame, the port none)."""
    from cv_monoslam_tpu.api import SlamSession as JaxSession
    from cv_monoslam_tpu.io import fixtures as jfix

    kw = dict(SESSION_KW, subpixel_match=False, **mode)
    jseq, jtrack, _, _ = jfix.load("bench1_arc")
    j = JaxSession(JaxConfig(**kw), jseq, jtrack)
    j.run(n_frames=3, chunk=1)
    seq, track, _, _ = tfix.load("bench1_arc")
    t = SlamSession(SlamConfig(**kw), seq, track, device="cpu")
    t.run(n_frames=3, chunk=1)
    assert len(t.records) == len(j.records) == 3
    for i, (a, b) in enumerate(zip(t.records, j.records)):
        for k in ("frame", "n_map", "n_visible", "n_matched", "redirected"):
            assert getattr(a, k) == getattr(b, k), k
        np.testing.assert_allclose(a.pose, b.pose, rtol=0,
                                   atol=1e-5 if i == 0 else 1e-3)


@pytest.mark.parametrize("qr_mode", ["gram", "householder", "cholqr2"])
def test_fold_delete_returns_tensors_in_every_qr_mode(qr_mode):
    """``update_features`` takes ``fold_delete`` under a ``control.cond``,
    whose captured form copies the branch's outputs into tensors: the
    repair level too is a device tensor in every QR mode."""
    cfg = SlamConfig(max_landmarks=4, dtype="float64", qr_mode=qr_mode)
    rng = np.random.default_rng(6)
    D = cfg.state_dim
    x = torch.as_tensor(rng.normal(size=D))
    S = torch.as_tensor(np.triu(rng.normal(size=(D, D))) + 3 * np.eye(D))
    delete = torch.tensor([False, True, False, False])
    tlife.fold_delete(x, S, delete, cfg)          # builds its constants
    with no_host_reads():
        out = tlife.fold_delete(x, S, delete, cfg)
    assert len(control.leaves(out)) == 3
    assert out[2].dtype == torch.int32 and out[2].dim() == 0
