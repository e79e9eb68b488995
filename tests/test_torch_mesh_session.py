"""PyTorch port: ``SlamSession.run`` in chunks under a four-rank mesh, in
both layouts, vs the port's single-device session and vs the JAX engine's
sharded step.

The session under ``set_mesh(mesh)`` (the landmark layout) or
``set_mesh(mesh, shard_sqrt=True)`` factorizes the joint update across the
ranks (``dist_chol_panel``), and in ``shard_sqrt`` also sums every Gram
over S's rows across them. Here the ranks are four ``gloo`` processes on
the CPU, spawned once for the file (``parallel/launch.py``), each running
the session's chunks under the host-read guard (``launch.run_session``).
The implicit path at M = 24 (D = 148, joint n = 196, padded to 208: 52 rows
a rank, so panels of 16 span ranks), float64, on 12 frames of
``bench3_grid`` in chunks of 4.

References:

* the one-rank mesh session (the same distributed factorization and
  Grams, on a mesh of rank 0 alone): pose, x and S within 1e-10 (the four
  ranks sum S's row blocks in another order; on these frames the two part
  by 6e-14);
* the port's single-device session on the same frames, one thread as each
  rank computes: every discrete field of every frame's telemetry equal,
  pose within 5e-5. Without a mesh the joint update takes
  ``chol_psd_flagged``'s repair ladder where the distributed one takes its
  1e-3 rung (three of these frames' factorizations are not finite), so the
  repaired frames differ by ~1e-5 (the JAX engine's two paths alike);
* the JAX engine's ``slam_step`` jitted under ``jax.sharding.set_mesh`` on
  four of conftest's fake CPU devices with ``state_shardings`` of the same
  layout (as ``scripts/bench_scaling.py`` runs it), stepped frame by frame
  from the same state after frame 0 on the same images and odometry:
  per-frame map size and matches equal; pose within 1e-8 in the
  ``shard_sqrt`` layout, within 1e-4 in the landmark layout, where the JAX
  engine's own two layouts part by 5.7e-5 by frame 12 (the repaired,
  nearly indefinite joint matrices amplify roundoff; the port's two layouts
  part by 3e-17);
* rank 0: every rank's telemetry and final state equal to rank 0's bit for
  bit (a gate read otherwise on one rank would send its collectives down
  another branch).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from cv_monoslam_tpu.config import SlamConfig as JaxConfig
from cv_monoslam_tpu.filter import state as jstate
from cv_monoslam_tpu.filter.srukf import slam_step as j_slam_step
from cv_monoslam_tpu.parallel.mesh import make_mesh as j_make_mesh
from cv_monoslam_tpu.parallel.mesh import state_shardings as j_shardings
from cv_monoslam_tpu_torch.config import SlamConfig
from cv_monoslam_tpu_torch.convert import state_to_arrays
from cv_monoslam_tpu_torch.io import fixtures as tfix
from cv_monoslam_tpu_torch.parallel import launch

FIXTURE, MIN_STEP_XY = "bench3_grid", 0.005
FRAMES, CHUNK, RANKS = 12, 4, 4
KW = dict(max_landmarks=24, max_new_per_frame=8, max_detections=48,
          min_num=12, gate_detection=False, sigma_mode="implicit",
          min_step_xy=MIN_STEP_XY, dtype="float64", dist_chol_panel=16)
LAYOUTS = {"landmark": False, "shard_sqrt": True}
#: pose tolerance against the JAX engine's sharded step, by layout
JAX_POSE_ATOL = {"landmark": 1e-4, "shard_sqrt": 1e-8}
#: the per-frame telemetry that must be equal everywhere
DISCRETE = ("n_map", "n_visible", "n_matched", "n_repairs", "n_escalations",
            "n_skipped")


@pytest.fixture(scope="module")
def ranks():
    """Both layouts' sessions on one spawned set of four gloo ranks, and on
    a mesh of rank 0 alone: {(layout, ranks): each rank's result}."""
    keys = [(name, n) for n in (RANKS, 1) for name in LAYOUTS]
    cases = [(n, launch.run_session,
              (launch.MESH, SlamConfig(**KW), FIXTURE, FRAMES, CHUNK,
               MIN_STEP_XY, LAYOUTS[name])) for name, n in keys]
    try:
        res = launch.spawn(launch.run_cases, RANKS, "cpu", cases,
                           timeout_s=240.0)
    except OSError as e:       # no temporary file or process could start
        pytest.skip(f"gloo rendezvous unavailable: {e}")
    return {key: [r[i] for r in res[:key[1]]] for i, key in enumerate(keys)}


@pytest.fixture(scope="module")
def single():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # as each spawned rank computes
    try:
        return launch.to_numpy(launch.run_session(
            None, SlamConfig(**KW), FIXTURE, FRAMES, CHUNK, MIN_STEP_XY))
    finally:
        torch.set_num_threads(threads)


def _jax_run(state0: dict, shard_sqrt: bool) -> dict:
    """The JAX engine's step, jitted with ``state_shardings`` on four fake
    CPU devices, from the port's state after frame 0 (same leaf order)."""
    jcfg = JaxConfig(**KW)
    seq, track, _, _ = tfix.load(FIXTURE, min_step_xy=MIN_STEP_XY)
    odo = np.concatenate([track.xy, track.theta[:, None]], axis=1)
    template = jstate.init_state(jcfg, theta0=float(track.theta[0]))
    st = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template),
        [jnp.asarray(v) for v in state_to_arrays(state0).values()])
    mesh = j_make_mesh(RANKS)
    sh = j_shardings(mesh, jcfg, shard_sqrt=shard_sqrt)
    rep = NamedSharding(mesh, P())
    out = {k: [] for k in ("pose", "n_map", "n_matched")}
    with jax.sharding.set_mesh(mesh):
        step = jax.jit(lambda s, im, a, b: j_slam_step(s, im, a, b, False,
                                                       jcfg),
                       in_shardings=(sh, rep, rep, rep),
                       out_shardings=(sh, rep))
        st = jax.device_put(st, sh)
        for k in range(1, FRAMES + 1):
            img = seq.get(int(track.frame_id[k])).astype(np.float64)
            st, o = step(st, *(jax.device_put(jnp.asarray(v), rep)
                               for v in (img, odo[k - 1], odo[k])))
            for key in out:
                out[key].append(np.asarray(o[key]))
    return {k: np.stack(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_runs(single):
    return {name: _jax_run(single["state0"], sq)
            for name, sq in LAYOUTS.items()}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_four_ranks_match_one_rank(ranks, layout):
    got, want = ranks[layout, RANKS][0], ranks[layout, 1][0]
    for k in DISCRETE:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["pose"], want["pose"], rtol=0,
                               atol=1e-10)
    a, b = state_to_arrays(got["state"]), state_to_arrays(want["state"])
    for k in b:
        if np.issubdtype(b[k].dtype, np.floating):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-10,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_session_matches_single_device_session(ranks, single, layout):
    got = ranks[layout, RANKS][0]
    for k in DISCRETE:
        np.testing.assert_array_equal(got[k], single[k], err_msg=k)
    assert max(single["n_matched"]) > 0
    np.testing.assert_allclose(got["pose"], single["pose"], rtol=0,
                               atol=5e-5)
    a, b = state_to_arrays(got["state"]), state_to_arrays(single["state"])
    for k in b:
        if not np.issubdtype(b[k].dtype, np.floating):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_session_goes_through_the_distributed_factorization(
        ranks, single, layout):
    """Every rank factorized every frame's joint update across the mesh
    (counted on its device), and some frames took the 1e-3 rung (on the
    card its collectives sit in a conditional body); the single-device
    session never factorized across a mesh."""
    for r in ranks[layout, RANKS]:
        assert r["dist_chol_calls"] >= FRAMES
        assert 1 <= r["dist_chol_not_finite"] <= r["dist_chol_calls"] - FRAMES
    assert single["dist_chol_calls"] == 0


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_session_matches_jax_sharded_step(ranks, jax_runs, layout):
    got, want = ranks[layout, RANKS][0], jax_runs[layout]
    np.testing.assert_array_equal(got["n_map"], want["n_map"])
    np.testing.assert_array_equal(got["n_matched"], want["n_matched"])
    np.testing.assert_allclose(got["pose"], want["pose"], rtol=0,
                               atol=JAX_POSE_ATOL[layout])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_every_rank_holds_rank0_session(ranks, layout):
    want = ranks[layout, RANKS][0]
    for r, got in enumerate(ranks[layout, RANKS][1:], start=1):
        for k in ("pose",) + DISCRETE:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"rank {r} {k}")
        a, b = state_to_arrays(got["state"]), state_to_arrays(want["state"])
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"rank {r} {k}")
