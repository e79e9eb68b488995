"""PyTorch port: the keyframe backend vs the JAX package.

The same numpy inputs (made from a seed) go through the JAX function and
its counterpart in the port, on the CPU:

* ``project_smooth`` and the BA residual Jacobians vs ``jax.jacfwd``:
  float64, 1e-9 absolute (pixels ~1e2..1e3, Jacobian entries up to ~1e3).
* ``_obs_blocks`` (all seven outputs), ``ba_solve`` (poses, landmarks, the
  cost of every iteration) and ``reprojection_rmse`` on the problems of
  ``tests/test_backend.py``, empty slots included: float64 to 1e-8 relative
  (+1e-8 absolute), float32 to 1e-3 relative of each output's largest entry.
* ``pose_graph_solve`` on the drifted square with one loop edge: 1e-8.
* ``BackendSession`` fed the synthetic keyframe streams of
  ``tests/test_loop_closure.py`` through both packages: equal keyframe
  count, equal loop edges ``(i, j)``, equal edge-log reasons, ``rel`` and
  every keyframe pose to 1e-6 after ``optimize_graph`` and after
  ``refine_window``, node eviction at ``max_nodes`` included.
``replay`` of a captured telemetry stream through both packages is held in
``tests/test_torch_replay.py`` (a file of its own, so that the test workers
can run the two side by side).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_monoslam_tpu.backend import ba as jba
from cv_monoslam_tpu.backend import pose_graph as jpg
from cv_monoslam_tpu.backend import session as jsession
from cv_monoslam_tpu.config import CameraConfig as JaxCamera
from cv_monoslam_tpu.config import SlamConfig as JaxConfig
from cv_monoslam_tpu.geometry import camera as jcam
from cv_monoslam_tpu_torch.backend import ba as tba
from cv_monoslam_tpu_torch.backend import pose_graph as tpg
from cv_monoslam_tpu_torch.backend import replay as treplay
from cv_monoslam_tpu_torch.backend import session as tsession
from cv_monoslam_tpu_torch.config import CameraConfig, SlamConfig
from cv_monoslam_tpu_torch.geometry import camera as tcam

JCFG = JaxConfig(dtype="float64", ba_iters=8,
                 camera=JaxCamera(width=640, height=480))
TCFG = SlamConfig(dtype="float64", ba_iters=8,
                  camera=CameraConfig(width=640, height=480))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, rtol=1e-8, atol=1e-8, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


# -- camera ----------------------------------------------------------------

def test_project_smooth_and_jacobian_match_jax():
    rng = np.random.default_rng(0)
    hlr = np.stack([rng.uniform(-1.5, 1.5, 40), rng.uniform(-1.2, 1.2, 40),
                    rng.uniform(2.0, 4.0, 40)], axis=1)
    hlr[0] = [0.3, -0.2, 0.0]             # the |Z| < 1e-9 guard
    hlr[1] = [0.0, 0.0, 3.0]              # the optical axis (ru -> 1e-9)
    want = jcam.project_smooth(JCFG.camera, jnp.asarray(hlr))
    got = tcam.project_smooth(TCFG.camera, _t(hlr))
    _close(got[2:], want[2:], rtol=0, atol=1e-9)
    _close(got[:2], want[:2], rtol=1e-12, atol=1e-9)
    jw = jax.vmap(jax.jacfwd(
        lambda h: jcam.project_smooth(JCFG.camera, h)))(jnp.asarray(hlr[1:]))
    jg = torch.func.vmap(torch.func.jacfwd(
        lambda h: tcam.project_smooth(TCFG.camera, h[None])[0]))(_t(hlr[1:]))
    _close(jg, jw, rtol=0, atol=1e-9)
    assert jg.shape == (39, 2, 3) and bool(torch.isfinite(jg).all())
    # the derivatives written out by hand: the same numbers, both dtypes
    # (under torch.func a 0-dim tensor times a Python number would promote
    # its tangent to float64, hence h[None] above)
    eye = torch.eye(3, dtype=torch.float64).expand(40, 3, 3)
    pix, dpix = tcam.project_smooth_jvp(TCFG.camera, _t(hlr), eye)
    _close(pix, got, rtol=0, atol=1e-12)
    _close(dpix[1:], jw, rtol=0, atol=1e-9)
    assert bool((dpix[0, :, 2] == 0).all())       # the guarded Z: no slope
    p32, d32 = tcam.project_smooth_jvp(TCFG.camera, _t(hlr).float()[2:],
                                       eye.float()[2:])
    assert p32.dtype == d32.dtype == torch.float32
    _close(d32, np.asarray(jw)[1:], rtol=2e-4, atol=2e-3)


# -- bundle adjustment -------------------------------------------------------

def _make_problem(rng, W=5, L=12, noise=0.0, perturb=0.0):
    """The window of ``tests/test_backend.py`` as numpy arrays."""
    poses_gt = np.stack([0.08 * np.arange(W), 0.02 * np.arange(W),
                         0.05 * np.arange(W)], axis=1)
    lms_gt = np.stack([rng.uniform(-0.4, 0.8, L), rng.uniform(-0.4, 0.6, L),
                       np.full(L, 3.0) + rng.uniform(-0.1, 0.1, L)], axis=1)
    px = tba.project_planar(_t(poses_gt)[:, None], _t(lms_gt)[None],
                            TCFG).numpy()
    mask = ((px[..., 0] > 20) & (px[..., 0] < 620)
            & (px[..., 1] > 20) & (px[..., 1] < 460))
    obs = np.where(mask[..., None],
                   px + rng.normal(0, noise, px.shape), 0.0)
    odo_rel = np.zeros((W - 1, 3))
    for w in range(W - 1):
        c, s = np.cos(poses_gt[w, 2]), np.sin(poses_gt[w, 2])
        d = poses_gt[w + 1, :2] - poses_gt[w, :2]
        odo_rel[w] = [c * d[0] + s * d[1], -s * d[0] + c * d[1],
                      poses_gt[w + 1, 2] - poses_gt[w, 2]]
    poses0 = poses_gt + perturb * rng.normal(size=poses_gt.shape)
    poses0[0] = poses_gt[0]
    lms0 = lms_gt + 3 * perturb * rng.normal(size=lms_gt.shape)
    arrays = dict(poses=poses0, landmarks=lms0, obs=obs, obs_mask=mask,
                  odo_rel=odo_rel, kf_mask=np.ones(W, bool),
                  lm_mask=mask.sum(0) >= 2)
    return arrays, poses_gt, lms_gt


def _problems(arrays, dtype):
    def cast(a):
        return a.astype(dtype) if a.dtype.kind == "f" else a

    a = {k: cast(v) for k, v in arrays.items()}
    return (jba.BAProblem(**{k: jnp.asarray(v) for k, v in a.items()}),
            tba.BAProblem(**{k: _t(v) for k, v in a.items()}))


def _ba_cases():
    cases = {}
    arrays, _, _ = _make_problem(np.random.default_rng(0), perturb=0.02)
    cases["perturbed"] = arrays
    arrays, _, _ = _make_problem(np.random.default_rng(1), noise=0.5,
                                 perturb=0.03)
    cases["noisy"] = arrays
    arrays, _, _ = _make_problem(np.random.default_rng(2), perturb=0.02)
    arrays = dict(arrays)
    arrays["kf_mask"] = arrays["kf_mask"].copy()
    arrays["kf_mask"][-1] = False
    arrays["lm_mask"] = arrays["lm_mask"].copy()
    arrays["lm_mask"][6:] = False
    arrays["landmarks"] = arrays["landmarks"].copy()
    arrays["landmarks"][8:] = 0.0         # unfilled slots sit at Z = 0
    rng = np.random.default_rng(3)
    arrays["prior_poses"] = arrays["poses"] + 0.01 * rng.normal(size=(5, 3))
    arrays["prior_iw"] = np.full((5, 3), 1.0 / 0.05 ** 2)
    cases["empty_slots_and_priors"] = arrays
    return cases


BA_CASES = _ba_cases()


def test_project_planar_matches_jax():
    arrays = BA_CASES["perturbed"]
    want = jax.vmap(lambda p: jax.vmap(
        lambda x: jba.project_planar(p, x, JCFG))(
            jnp.asarray(arrays["landmarks"])))(jnp.asarray(arrays["poses"]))
    got = tba.project_planar(_t(arrays["poses"])[:, None],
                             _t(arrays["landmarks"])[None], TCFG)
    _close(got, want, rtol=0, atol=1e-9)


def test_ba_jacobians_match_jax_jacfwd():
    arrays = BA_CASES["perturbed"]
    args = (arrays["poses"], arrays["landmarks"], arrays["obs"])
    r, jp, jl = jba._res_jac(*[jnp.asarray(a) for a in args], JCFG)
    r2, jp2, jl2 = tba._res_jac(*[_t(a) for a in args], TCFG)
    for g, w in ((r2, r), (jp2, jp), (jl2, jl)):
        _close(g, w, rtol=0, atol=1e-9)
    _close(tba._residuals(*[_t(a) for a in args], TCFG), r, rtol=0,
           atol=1e-9)
    assert jp2.shape == (5, 12, 2, 3) and jl2.shape == (5, 12, 2, 3)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(BA_CASES))
def test_obs_blocks_match_jax(case, dtype):
    jp, tp = _problems(BA_CASES[case], dtype)
    jcfg = dataclasses.replace(JCFG, dtype=dtype)
    tcfg = dataclasses.replace(TCFG, dtype=dtype)
    want = jba._obs_blocks(jp.poses, jp.landmarks, jp.obs, jp.obs_mask,
                           jp.kf_mask, jp.lm_mask, jcfg, 1.0, 1e-4)
    got = tba._obs_blocks(tp.poses, tp.landmarks, tp.obs, tp.obs_mask,
                          tp.kf_mask, tp.lm_mask, tcfg, 1.0, 1e-4)
    assert len(got) == len(want) == 7
    names = ("U", "Hred", "bp", "Vinv", "Wc", "bl", "cost")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        assert np.isfinite(w).all() and bool(torch.isfinite(g).all()), name
        scale = max(float(np.abs(w).max()), 1.0)
        if dtype == "float64":
            _close(g, w, rtol=1e-8, atol=1e-8 * scale, msg=name)
        else:
            _close(g, w, rtol=0, atol=1e-3 * scale, msg=name)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(BA_CASES))
def test_ba_solve_matches_jax(case, dtype):
    jp, tp = _problems(BA_CASES[case], dtype)
    jcfg = dataclasses.replace(JCFG, dtype=dtype)
    tcfg = dataclasses.replace(TCFG, dtype=dtype)
    wp, wl, wc = jba.ba_solve(jp, jcfg)
    gp, gl, gc = tba.ba_solve(tp, tcfg)
    assert gc.shape == (8,) and gp.dtype == getattr(torch, dtype)
    if dtype == "float64":
        _close(gp, wp)
        _close(gl, wl)
        _close(gc, wc, rtol=1e-8, atol=1e-8)
        _close(tba.reprojection_rmse(gp, gl, tp, tcfg),
               jba.reprojection_rmse(wp, wl, jp, jcfg))
    else:
        _close(gp, wp, rtol=1e-3, atol=1e-3)
        _close(gl, wl, rtol=1e-3, atol=3e-3)
        _close(gc[0], np.asarray(wc)[0], rtol=1e-3)
        _close(tba.reprojection_rmse(gp, gl, tp, tcfg),
               jba.reprojection_rmse(wp, wl, jp, jcfg), rtol=1e-3,
               atol=1e-2)
    _close(tba.reprojection_rmse(tp.poses, tp.landmarks, tp, tcfg),
           jba.reprojection_rmse(jp.poses, jp.landmarks, jp, jcfg),
           rtol=1e-8 if dtype == "float64" else 1e-3)
    if case == "empty_slots_and_priors":
        # unfilled keyframe / landmark slots are exact no-ops
        np.testing.assert_array_equal(gp.numpy()[-1], tp.poses.numpy()[-1])
        np.testing.assert_array_equal(gl.numpy()[6:],
                                      tp.landmarks.numpy()[6:])
        assert bool(torch.isfinite(gp).all() and torch.isfinite(gl).all())


def test_ba_recovers_perturbed_geometry():
    arrays, poses_gt, lms_gt = _make_problem(np.random.default_rng(0),
                                             perturb=0.02)
    _, prob = _problems(arrays, "float64")
    r0 = float(tba.reprojection_rmse(prob.poses, prob.landmarks, prob, TCFG))
    poses, lms, costs = tba.ba_solve(prob, TCFG)
    r1 = float(tba.reprojection_rmse(poses, lms, prob, TCFG))
    assert r0 > 1.0 and r1 < 1e-3
    np.testing.assert_allclose(poses.numpy(), poses_gt, atol=1e-3)
    m = arrays["lm_mask"]
    np.testing.assert_allclose(lms.numpy()[m], lms_gt[m], atol=5e-3)
    assert float(costs[-1]) < float(costs[0])


# -- pose graph ----------------------------------------------------------------

def _square_graph():
    n = 9
    nodes_gt = np.zeros((n, 3))
    steps = [(0.5, 0), (0.5, 0), (0, 0.5), (0, 0.5),
             (-0.5, 0), (-0.5, 0), (0, -0.5), (0, -0.5)]
    for i, (dx, dy) in enumerate(steps):
        nodes_gt[i + 1] = nodes_gt[i] + [dx, dy, 0]
    nodes0 = nodes_gt + np.arange(n)[:, None] * np.array([0.02, 0.015, 0.01])
    N, E = 12, 16
    nodes = np.zeros((N, 3))
    nodes[:n] = nodes0
    node_mask = np.zeros(N, bool)
    node_mask[:n] = True
    eij = np.zeros((E, 2), np.int32)
    erel = np.zeros((E, 3))
    ew = np.zeros((E, 3))
    emask = np.zeros(E, bool)
    for i in range(n - 1):
        eij[i] = (i, i + 1)
        erel[i] = nodes_gt[i + 1] - nodes_gt[i]
        ew[i] = (100.0, 100.0, 400.0)
        emask[i] = True
    eij[n - 1] = (0, 8)
    ew[n - 1] = (1e4, 1e4, 4e4)
    emask[n - 1] = True
    return dict(nodes=nodes, edges_ij=eij, edges_rel=erel, edges_w=ew,
                edge_mask=emask, node_mask=node_mask), nodes0, nodes_gt


def test_edge_jacobians_match_jax_jacfwd():
    rng = np.random.default_rng(4)
    pi, pj, rel = rng.normal(size=(3, 20, 3))
    ji = jax.vmap(jax.jacfwd(jpg._edge_residual, argnums=0))(
        jnp.asarray(pi), jnp.asarray(pj), jnp.asarray(rel))
    jj = jax.vmap(jax.jacfwd(jpg._edge_residual, argnums=1))(
        jnp.asarray(pi), jnp.asarray(pj), jnp.asarray(rel))
    r = jax.vmap(jpg._edge_residual)(jnp.asarray(pi), jnp.asarray(pj),
                                     jnp.asarray(rel))
    gi, gj = tpg._edge_jacobians(_t(pi), _t(pj))
    _close(gi, ji, rtol=0, atol=1e-9)
    _close(gj, jj, rtol=0, atol=1e-9)
    _close(tpg._edge_residual(_t(pi), _t(pj), _t(rel)), r, rtol=0,
           atol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_pose_graph_solve_matches_jax_and_closes_loop(dtype):
    arrays, nodes0, nodes_gt = _square_graph()
    a = {k: (v.astype(dtype) if v.dtype.kind == "f" else v)
         for k, v in arrays.items()}
    want, wc = jpg.pose_graph_solve(
        jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in a.items()}), iters=15)
    got, gc = tpg.pose_graph_solve(
        tpg.PoseGraph(**{k: _t(v) for k, v in a.items()}), iters=15)
    tol = 1e-8 if dtype == "float64" else 1e-3
    _close(got, want, rtol=tol, atol=tol)
    _close(gc[:3], np.asarray(wc)[:3], rtol=tol, atol=tol)
    opt = got.numpy()
    assert np.linalg.norm(nodes0[8, :2] - nodes0[0, :2]) > 0.1
    assert np.linalg.norm(opt[8, :2] - opt[0, :2]) < 0.02
    e0 = np.linalg.norm(nodes0[:9, :2] - nodes_gt[:9, :2], axis=1).mean()
    e1 = np.linalg.norm(opt[:9, :2] - nodes_gt[:9, :2], axis=1).mean()
    assert e1 < 0.5 * e0
    np.testing.assert_array_equal(opt[9:], 0.0)       # empty nodes untouched


# -- BackendSession on synthetic keyframe streams ---------------------------------

class _Pkg:
    """One package's backend: the same stream is fed to both."""

    def __init__(self, mod, cfg_cls, **kw):
        self.mod = mod
        self.cfg = cfg_cls(dtype="float64", ba_window=2)
        self.kw = kw

    def backend(self, **kw):
        return self.mod.BackendSession(self.cfg, loop_min_sep=3,
                                       **{**self.kw, **kw})


PKGS = (_Pkg(jsession, JaxConfig), _Pkg(tsession, SlamConfig, device="cpu"))


def _history(pkg, n_old=4, **kw):
    rng = np.random.default_rng(11)
    bs = pkg.backend(**kw)
    lms = np.stack([rng.uniform(-0.5, 0.5, 8), rng.uniform(-0.5, 0.5, 8),
                    np.full(8, 3.0)], axis=1)
    px = rng.uniform(100, 500, (8, 2))
    for w in range(n_old):
        pose = np.array([0.05 * w, 0.0, 0.02 * w])
        bs.keyframes.append(pkg.mod.Keyframe(
            frame=w, pose=pose, odo=pose, lids=np.arange(1, 9),
            pixels=px + w, xyz=lms.copy(), pose_sigma=np.full(3, 0.05)))
    return bs, lms


def _revisit(pkg, frame, lids0, lms, dth, t, thin=None):
    c, s = np.cos(dth), np.sin(dth)
    drifted = lms.copy()
    drifted[:, 0] = c * lms[:, 0] - s * lms[:, 1] + t[0]
    drifted[:, 1] = s * lms[:, 0] + c * lms[:, 1] + t[1]
    pose = np.array([t[0], t[1], dth])
    kf = pkg.mod.Keyframe(
        frame=frame, pose=pose, odo=pose, lids=np.arange(lids0, lids0 + 8),
        pixels=np.full((8, 2), 300.0), xyz=drifted,
        pose_sigma=np.full(3, 0.05))
    if thin is not None:
        kf.map_xyz = kf.map_xyz[:thin]
        kf.map_lids = kf.map_lids[:thin]
    return kf


def _far(pkg, frame, lid0, pose, seed):
    return pkg.mod.Keyframe(
        frame=frame, pose=pose, odo=pose, lids=np.arange(lid0, lid0 + 8),
        pixels=np.full((8, 2), 300.0),
        xyz=np.tile(pose, (8, 1))
        + np.random.default_rng(seed).normal(0, 0.3, (8, 3)),
        pose_sigma=np.full(3, 0.05))


def _stream_single(pkg):
    bs, lms = _history(pkg)
    bs._add(_revisit(pkg, 10, 100, lms, 0.05, np.array([0.12, -0.08])))
    return bs


def _stream_inconsistent(pkg):
    bs, lms = _history(pkg)
    bs._add(_revisit(pkg, 10, 100, lms, 0.05, np.array([0.12, -0.08])))
    bs._add(_revisit(pkg, 11, 200, lms, 0.05, np.array([-0.2, 0.25])))
    return bs


def _stream_consistent(pkg):
    bs, lms = _history(pkg)
    bs._add(_revisit(pkg, 10, 100, lms, 0.05, np.array([0.12, -0.08])))
    bs._add(_revisit(pkg, 11, 200, lms, 0.06, np.array([0.13, -0.07])))
    return bs


def _stream_thin(pkg):
    bs, lms = _history(pkg)
    bs._add(_revisit(pkg, 10, 100, lms, 0.05, np.array([0.12, -0.08])))
    bs._add(_revisit(pkg, 11, 200, lms, 0.06, np.array([0.16, -0.05]),
                     thin=5))
    return bs


def _stream_wrong_transform(pkg):
    bs, lms = _history(pkg)
    bs._add(_revisit(pkg, 10, 100, lms, 0.05, np.array([0.12, -0.08])))
    bs._add(_revisit(pkg, 11, 200, lms, 0.9, np.array([-0.8, 0.7]), thin=5))
    return bs


def _stream_validated(pkg):
    bs, lms = _history(pkg)
    bs._add(_revisit(pkg, 10, 100, lms, 0.05, np.array([0.12, -0.08])))
    bs._add(_revisit(pkg, 11, 200, lms, 0.06, np.array([0.13, -0.07])))
    bs._add(_revisit(pkg, 12, 300, lms, 0.07, np.array([0.14, -0.06])))
    return bs


def _stream_fast_path_expires(pkg):
    bs, lms = _history(pkg)
    bs._add(_revisit(pkg, 10, 100, lms, 0.05, np.array([0.12, -0.08])))
    bs._add(_revisit(pkg, 11, 200, lms, 0.06, np.array([0.13, -0.07])))
    for w in range(4):
        bs.keyframes.append(_far(pkg, 20 + w, 500 + 8 * w,
                                 np.array([5.0 + 0.05 * w, 5.0, 0.0]), w))
    bs._add(_revisit(pkg, 30, 300, lms, 0.07, np.array([0.14, -0.06])))
    return bs


def _stream_eviction(pkg):
    """Node eviction at ``max_nodes``: loop edges, pending sightings and the
    validated map are reindexed, the oldest keyframe goes."""
    bs, lms = _history(pkg, n_old=5, max_nodes=7)
    bs._add(_revisit(pkg, 10, 100, lms, 0.05, np.array([0.12, -0.08])))
    bs._add(_revisit(pkg, 11, 200, lms, 0.06, np.array([0.13, -0.07])))
    assert len(bs.keyframes) == 7 and len(bs.loop_edges) == 2
    bs._add(_revisit(pkg, 12, 300, lms, 0.07, np.array([0.14, -0.06])))
    bs._add(_far(pkg, 20, 900, np.array([7.0, 7.0, 0.0]), 9))
    assert len(bs.keyframes) == 7
    return bs


def _stream_geometric_single_commit(pkg):
    rng = np.random.default_rng(5)
    bs = pkg.mod.BackendSession(pkg.cfg, loop_min_sep=3,
                                loop_pair_radius=0.3, loop_confirm=1,
                                **pkg.kw)
    lms = np.stack([rng.uniform(-0.5, 0.5, 8), rng.uniform(-0.5, 0.5, 8),
                    np.full(8, 3.0)], axis=1)
    for w in range(4):
        pose = np.array([0.05 * w, 0.0, 0.02 * w])
        bs.keyframes.append(pkg.mod.Keyframe(
            frame=w, pose=pose, odo=pose, lids=np.arange(1, 9),
            pixels=np.full((8, 2), 300.0), xyz=lms.copy(),
            pose_sigma=np.full(3, 0.01)))
    bs._add(_revisit(pkg, 10, 100, lms, 0.05, np.array([0.12, -0.08])))
    return bs


STREAMS = dict(
    single=(_stream_single, 0),
    inconsistent=(_stream_inconsistent, 0),
    consistent=(_stream_consistent, 2),
    thin_map=(_stream_thin, 2),
    wrong_transform=(_stream_wrong_transform, 0),
    validated=(_stream_validated, 3),
    fast_path_expires=(_stream_fast_path_expires, 2),
    eviction=(_stream_eviction, None),
    geometric_single_commit=(_stream_geometric_single_commit, 1),
)


def _assert_same_backend(tb, jb, tol=1e-6):
    assert len(tb.keyframes) == len(jb.keyframes)
    assert [k.frame for k in tb.keyframes] == [k.frame for k in jb.keyframes]
    assert [(i, j) for i, j, _, _ in tb.loop_edges] == \
        [(i, j) for i, j, _, _ in jb.loop_edges]
    for (_, _, rt, wt), (_, _, rj, wj) in zip(tb.loop_edges, jb.loop_edges):
        _close(rt, rj, rtol=0, atol=tol)
        _close(wt, wj, rtol=0, atol=tol)
    assert len(tb.edge_log) == len(jb.edge_log)
    for et, ej in zip(tb.edge_log, jb.edge_log):
        for k in ("i", "j", "path", "n_inliers", "accepted", "const_sizes"):
            assert et[k] == ej[k], (k, et, ej)
        assert et.get("reason") == ej.get("reason")
        assert et.get("confirmed_by") == ej.get("confirmed_by")
        if "rel" in ej:
            _close(et["rel"], ej["rel"], rtol=0, atol=1e-4 + tol)
    assert [(p["i"], p["j"]) for p in tb._pending] == \
        [(p["i"], p["j"]) for p in jb._pending]
    assert tb._validated == jb._validated
    for kt, kj in zip(tb.keyframes, jb.keyframes):
        for f in ("pose", "pose0", "pose_filter", "xyz", "map_xyz"):
            _close(getattr(kt, f), getattr(kj, f), rtol=0, atol=tol,
                   msg=f"{f} of keyframe {kt.frame}")


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_backend_session_streams_match_jax(name):
    build, n_edges = STREAMS[name]
    jb, tb = (build(p) for p in PKGS)
    _assert_same_backend(tb, jb)
    if n_edges is not None:
        assert len(tb.loop_edges) == n_edges
    if name == "eviction":
        # two keyframes went: the edges that survive are reindexed
        assert [k.frame for k in tb.keyframes][0] == 2
        assert tb.loop_edges and all(
            0 <= i < j < 7 for i, j, _, _ in tb.loop_edges)
    # the graph relaxation commits and rebases; then the window solve
    jg, tg = jb.optimize_graph(), tb.optimize_graph()
    _close(tg["nodes"], jg["nodes"], rtol=0, atol=1e-6)
    _close(tg["costs"], jg["costs"], rtol=1e-6, atol=1e-6)
    assert tg["n_loop_edges"] == jg["n_loop_edges"]
    _assert_same_backend(tb, jb)
    jr, tr = jb.refine_window(), tb.refine_window()
    for k in ("poses", "landmarks", "costs", "rmse_before", "rmse_after",
              "max_z", "max_corr"):
        _close(tr[k], jr[k], rtol=1e-6, atol=1e-6, msg=k)
    assert tr["applied"] == jr["applied"] and tr["frames"] == jr["frames"]
    _assert_same_backend(tb, jb)
    ts, js = tb.summary([tg, tr]), jb.summary([jg, jr])
    for k in ("keyframes", "loop_edges", "edge_candidates", "rejected",
              "ba_solves", "ba_applied", "graph_solves"):
        assert ts[k] == js[k], k


def test_window_ba_gate_holds_healthy_poses_and_commits_above_it():
    arrays, poses_gt, lms_gt = _make_problem(np.random.default_rng(4), W=5,
                                             L=12, perturb=0.0)
    outs = []
    for mod, cfg_cls, kw in ((jsession, JaxConfig, {}),
                             (tsession, SlamConfig, dict(device="cpu"))):
        for gate, shift in ((3.0, 0.0), (0.5, 0.05)):
            cfg = cfg_cls(dtype="float64", ba_window=4, ba_iters=6,
                          ba_apply_gate=gate)
            bs = mod.BackendSession(cfg, max_nodes=8, max_lms=16, **kw)
            for w in range(5):
                sel = np.flatnonzero(arrays["obs_mask"][w])
                bs.keyframes.append(mod.Keyframe(
                    frame=w, pose=poses_gt[w] + shift * (w == 3),
                    odo=poses_gt[w], lids=sel + 1,
                    pixels=arrays["obs"][w, sel], xyz=lms_gt[sel],
                    pose_sigma=np.full(3, 0.05)))
            before = [k.pose.copy() for k in bs.keyframes]
            out = bs.refine_window()
            outs.append((out, before, [k.pose.copy() for k in bs.keyframes]))
    for (jo, jb, ja), (to, tb_, ta) in zip(outs[:2], outs[2:]):
        assert to["applied"] == jo["applied"]
        _close(to["poses"], jo["poses"], rtol=0, atol=1e-6)
        _close(to["max_z"], jo["max_z"], rtol=1e-6)
        _close(np.stack(ta), np.stack(ja), rtol=0, atol=1e-6)
    assert outs[2][0]["applied"] is False
    np.testing.assert_array_equal(np.stack(outs[2][1]), np.stack(outs[2][2]))
    assert outs[3][0]["applied"] is True


def test_keyframe_from_state_matches_make_keyframe():
    from cv_monoslam_tpu_torch.convert import (state_from_arrays,
                                               state_to_arrays)
    from cv_monoslam_tpu_torch.filter.state import init_state

    cfg = SlamConfig(max_landmarks=6, dtype="float64")
    rng = np.random.default_rng(8)
    arrays = state_to_arrays(init_state(cfg, device="cpu"))
    arrays["S"] = np.triu(rng.normal(size=arrays["S"].shape))
    arrays["x"] = rng.normal(size=arrays["x"].shape)
    arrays["lm.active"] = np.array([1, 1, 0, 1, 1, 0], bool)
    arrays["lm.matched"] = np.array([1, 0, 1, 1, 0, 0], bool)
    arrays["lm.lid"] = np.arange(10, 16).astype(arrays["lm.lid"].dtype)
    arrays["lm.match_px"] = rng.uniform(0, 600, (6, 2))
    arrays["lm.xyz"] = rng.normal(size=(6, 3))
    state = state_from_arrays(arrays, device="cpu")
    odo = np.array([0.1, 0.2, 0.3])
    kf = tsession.keyframe_from_state(7, state, odo)
    S4 = arrays["S"][:, -4:]
    want = tsession.make_keyframe(
        7, arrays["x"][-4:], odo, arrays["lm.lid"],
        arrays["lm.matched"] & arrays["lm.active"], arrays["lm.match_px"],
        arrays["lm.xyz"], pose_sqrt_cov=np.sqrt((S4 * S4).sum(0)),
        active=arrays["lm.active"])
    assert kf.frame == 7 and list(kf.lids) == [10, 13]
    assert list(kf.map_lids) == [10, 11, 13, 14]
    for f in ("pose", "odo", "pixels", "xyz", "pose_sigma", "map_xyz",
              "pose0", "pose_filter"):
        _close(getattr(kf, f), getattr(want, f), rtol=1e-15, atol=0, msg=f)


def test_backend_session_without_device_raises_on_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsession.BackendSession(SlamConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        treplay.replay([], SlamConfig())
