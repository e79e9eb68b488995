"""PyTorch port: the backend's solves as the card runs them, on the CPU.

On the card each window BA is one replay of a captured CUDA graph
(``backend/session.py``), and the sharded BA's iterations are one graph on
an NCCL mesh (``parallel/dist_ba.py``); ``chip_smoke.py``'s config-4 phase
holds the graph route against the eager route there. Here, in float64 on
the CPU, against the JAX package where it has a counterpart:

* (a) a singular normal system — a pose graph with a node that no edge
  touches, a BA window with a landmark slot filled but unobserved, both
  undamped — gives non-finite results in both packages (the port's checked
  ``torch.linalg`` forms used to raise);
* (b) ``BackendSession.refine_window`` / ``optimize_graph`` driven with the
  same telemetry stream in both packages, their solvers made singular in
  the same way (wrapped with ``damping=0`` and the empty last slot marked
  filled), keep the filter's keyframe poses as the JAX session does, with
  ``applied`` False;
* (c) under ``test_torch_chunk.no_host_reads`` the solvers and the device
  part of a window solve (its inputs staged) read nothing back to the host,
  upload nothing and call no synchronizing ``torch.linalg`` form, so a
  capture on the card cannot fail on one; the guard refuses those forms;
* (d) the single staged upload rebuilds the window problem and the pose
  graph bit for bit as the JAX session assembles them.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_backend import (JCFG, TCFG, _assert_same_backend,
                                _make_problem, _problems, _square_graph, _t)
from test_torch_chunk import HostRead, no_host_reads

from cv_monoslam_tpu.backend import ba as jba
from cv_monoslam_tpu.backend import pose_graph as jpg
from cv_monoslam_tpu.backend import session as jsession
from cv_monoslam_tpu.config import SlamConfig as JaxConfig
from cv_monoslam_tpu_torch.backend import ba as tba
from cv_monoslam_tpu_torch.backend import pose_graph as tpg
from cv_monoslam_tpu_torch.backend import session as tsession
from cv_monoslam_tpu_torch.config import SlamConfig
from cv_monoslam_tpu_torch.parallel import dist_ba
from cv_monoslam_tpu_torch.parallel.mesh import make_mesh

# -- (a) singular systems -----------------------------------------------------


def _singular_graph():
    """The drifted square of ``test_torch_backend`` with node 9 filled and
    touched by no edge."""
    arrays, _, _ = _square_graph()
    arrays["node_mask"] = arrays["node_mask"].copy()
    arrays["node_mask"][9] = True
    return arrays


def _singular_window():
    """``test_backend``'s window with its last landmark slot filled and
    observed by no keyframe."""
    arrays, _, _ = _make_problem(np.random.default_rng(0))
    arrays["lm_mask"] = arrays["lm_mask"].copy()
    arrays["lm_mask"][-1] = True
    arrays["obs_mask"] = arrays["obs_mask"].copy()
    arrays["obs_mask"][:, -1] = False
    return arrays


def _solve_singular(case):
    if case == "pose_graph":
        a = _singular_graph()
        want, wc = jpg.pose_graph_solve(
            jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in a.items()}),
            iters=2, damping=0.0)
        got, gc = tpg.pose_graph_solve(
            tpg.PoseGraph(**{k: _t(v) for k, v in a.items()}), iters=2,
            damping=0.0)
        return (want, wc), (got, gc)
    jp, tp = _problems(_singular_window(), "float64")
    wp, wl, wc = jba.ba_solve(jp, JCFG, damping=0.0)
    gp, gl, gc = tba.ba_solve(tp, TCFG, damping=0.0)
    return (wp, wl, wc), (gp, gl, gc)


@pytest.mark.parametrize("case", ["pose_graph", "ba_window"])
def test_singular_system_gives_nonfinite_as_jax(case):
    want, got = _solve_singular(case)
    # the first output: the solved poses (nodes)
    assert not np.isfinite(np.asarray(want[0])).all()
    assert not bool(torch.isfinite(got[0]).all())
    assert got[0].shape == tuple(np.asarray(want[0]).shape)
    # every iteration after the singular solve has a non-finite cost
    for w, g in zip(want[-1][1:], got[-1][1:]):
        assert not np.isfinite(float(w)) and not np.isfinite(float(g))


# -- (b) BackendSession on a singular solve -----------------------------------


def _telemetry():
    """Five frames of telemetry over ``test_backend``'s window geometry,
    one keyframe each, the filter's pose at frame 3 off by 5 cm."""
    arrays, poses_gt, lms_gt = _make_problem(np.random.default_rng(4))
    calls = []
    for w in range(5):
        x, y, th = poses_gt[w]
        x += 0.05 * (w == 3)
        calls.append((w, np.array([x, y, 0.0, th]), poses_gt[w].copy(),
                      np.arange(1, 13), arrays["obs_mask"][w],
                      arrays["obs"][w], lms_gt, np.full(4, 0.05),
                      np.ones(12, bool)))
    return calls


def _sessions():
    out = []
    for mod, cfg_cls, kw in ((jsession, JaxConfig, {}),
                             (tsession, SlamConfig, dict(device="cpu"))):
        cfg = cfg_cls(dtype="float64", ba_window=4, ba_iters=4,
                      keyframe_every=1, ba_apply_gate=0.0)
        bs = mod.BackendSession(cfg, max_nodes=8, max_lms=16, **kw)
        for (frame, pose4, odo, lid, matched, px, xyz, psc,
             active) in _telemetry():
            bs.maybe_add_telemetry(frame, pose4, odo, lid, matched, px, xyz,
                                   pose_sqrt_cov=psc, active=active)
        assert len(bs.keyframes) == 5
        out.append(bs)
    return out


def _last_set(mask):
    """``mask`` with its last entry True, in the mask's own package."""
    if isinstance(mask, torch.Tensor):
        return torch.cat([mask[:-1], torch.ones_like(mask[-1:])])
    return mask.at[-1].set(True)


def _singular_solvers(monkeypatch):
    """Each session module's solvers, undamped, with the empty last slot
    (landmark column 15 of 12 ids; node 7 of 5 keyframes) marked filled."""
    for mod, ba_mod, pg_mod in ((jsession, jba, jpg),
                                (tsession, tba, tpg)):
        def ba_solve(prob, cfg, _ba=ba_mod, **kw):
            prob = dataclasses.replace(prob, lm_mask=_last_set(prob.lm_mask))
            return _ba.ba_solve(prob, cfg, damping=0.0, **kw)

        def pose_graph_solve(g, _pg=pg_mod, **kw):
            g = dataclasses.replace(g, node_mask=_last_set(g.node_mask))
            return _pg.pose_graph_solve(g, damping=0.0, **kw)

        monkeypatch.setattr(mod, "ba_solve", ba_solve)
        monkeypatch.setattr(mod, "pose_graph_solve", pose_graph_solve)


@pytest.mark.parametrize("solve", ["refine_window", "optimize_graph"])
def test_session_keeps_filter_poses_on_singular_solve(solve, monkeypatch):
    jb, tb = _sessions()
    before = [k.pose.copy() for k in tb.keyframes]
    _singular_solvers(monkeypatch)
    jout, tout = getattr(jb, solve)(), getattr(tb, solve)()
    key = "poses" if solve == "refine_window" else "nodes"
    assert not np.isfinite(jout[key]).all()
    assert not np.isfinite(tout[key]).all()
    if solve == "refine_window":
        # a finite solve would apply at gate 0: the guard is what refused
        assert jout["applied"] is False and tout["applied"] is False
        assert np.isnan(jout["max_z"]) and np.isnan(tout["max_z"])
        assert np.isfinite(tout["rmse_before"])
    np.testing.assert_array_equal(np.stack([k.pose for k in tb.keyframes]),
                                  np.stack(before))
    _assert_same_backend(tb, jb)


def test_session_applies_the_same_window_when_not_singular():
    """The stream of (b) without the singular wrapper: both sessions
    commit the window at gate 0, to the same poses."""
    jb, tb = _sessions()
    jout, tout = jb.refine_window(), tb.refine_window()
    assert jout["applied"] is True and tout["applied"] is True
    _assert_same_backend(tb, jb)


# -- (c) no host read, no upload, no synchronizing linalg form ----------------


@pytest.mark.parametrize("name", ["solve", "inv", "cholesky"])
def test_guard_refuses_synchronizing_linalg(name):
    a = torch.eye(3, dtype=torch.float64) * 2.0
    args = (a, torch.ones(3, dtype=torch.float64)) if name == "solve" \
        else (a,)
    with no_host_reads():
        with pytest.raises(HostRead):
            getattr(torch.linalg, name)(*args)
        ex = getattr(torch.linalg, f"{name}_ex")(*args, check_errors=False)
    assert bool(torch.isfinite(ex[0]).all())


def _window_session():
    _, tb = _sessions()
    return tb, tba.BAProblem(**tb._stage(tb._window_arrays())[1])


def _device_calls(name):
    """A no-argument call of the solver ``name`` on a seeded problem."""
    _, tp = _problems(_make_problem(np.random.default_rng(1), noise=0.5,
                                    perturb=0.03)[0], "float64")
    if name == "ba_solve":
        return lambda: tba.ba_solve(tp, TCFG)
    if name == "reprojection_rmse":
        return lambda: tba.reprojection_rmse(tp.poses, tp.landmarks, tp,
                                             TCFG)
    if name == "pose_graph_solve":
        g = tpg.PoseGraph(**{k: _t(v) for k, v in _square_graph()[0].items()})
        return lambda: tpg.pose_graph_solve(g, iters=5)
    if name == "window_solve":
        tb, prob = _window_session()
        return lambda: tb._window_solve(prob)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["ba_solve", "reprojection_rmse",
                                  "pose_graph_solve", "window_solve"])
def test_solvers_make_no_host_read(name):
    call = _device_calls(name)
    first = call()                 # builds the cached constants
    with no_host_reads():
        again = call()
    for a, b in zip(first if isinstance(first, tuple) else (first,),
                    again if isinstance(again, tuple) else (again,)):
        assert torch.equal(a, b)


def test_sharded_solve_makes_no_host_read(tmp_path):
    _, tp = _problems(_make_problem(np.random.default_rng(1), noise=0.5,
                                    perturb=0.03)[0], "float64")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(device="cpu")
        first = dist_ba.ba_solve_sharded(tp, TCFG, mesh, iters=3)
        with no_host_reads():
            again = dist_ba.ba_solve_sharded(tp, TCFG, mesh, iters=3)
    finally:
        dist.destroy_process_group()
    single = tba.ba_solve(tp, TCFG, iters=3)
    for a, b, c in zip(first, again, single):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-12,
                                   atol=1e-12)


# -- (d) the staged upload ----------------------------------------------------


@pytest.mark.parametrize("what", ["window_problem", "graph"])
def test_staged_upload_rebuilds_jax_problem(what):
    jb, tb = _sessions()
    want, got = getattr(jb, what)(), getattr(tb, what)()
    fields = [f.name for f in dataclasses.fields(got)]
    assert fields == [f.name for f in dataclasses.fields(want)]
    for f in fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert g.device.type == "cpu" and g.is_contiguous(), f
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, f
        # bit for bit, NaN-free inputs
        assert np.array_equal(g.numpy().view(np.uint8), w.view(np.uint8)), f
    if what == "window_problem":
        # one buffer behind every field
        ptrs = {getattr(got, f).untyped_storage().data_ptr() for f in fields}
        assert len(ptrs) == 1
