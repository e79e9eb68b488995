"""PyTorch port: the sharded filter step (``parallel/spmd.py``) vs the JAX
package's sharded step and vs the port's own single-device step.

The JAX side runs in this process on its 8 fake CPU devices, as
``tests/test_spmd_filter.py`` runs it (``slam_step`` jitted with
``state_shardings``), on that file's own seeded inputs. The port's side runs
on ``gloo`` ranks spawned once for the whole file through
``parallel/launch.py``: world size 4, the world-size 1 and 2 cases on meshes
of the first ranks.

Tolerances, float32 as in the JAX test and taken from it: pose rtol 1e-5 /
atol 1e-6, x rtol 1e-4 / atol 1e-5, S rtol 1e-3 / atol 1e-4 (summation order
differs between the packages as between sharded and single-device runs).
Discrete outputs (lm_active, lm_matched, lm_lid) are equal. Exact: at world
size 1 the sharded step equals the port's single-device step bit for bit
(the single-device step keeps its arithmetic, and the packed all_gather
moves values and memory layouts unchanged), and every rank ends the frame
with the same state bit for bit.

The 8-frame case runs config 1 (M = 32, 8 slots per rank) on ``bench1_arc``
in float32 at 4 ranks in the landmark layout against the port's
single-device session, which runs on one thread as each rank does (on 8
threads the CPU's float32 products round otherwise, and 7 frames of
filtering carry that ~1e-7 to ~3e-4 in the pose): per-frame map size and
matches equal, discrete outputs equal, pose max |diff| <= 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from cv_monoslam_tpu.filter.srukf import slam_step as j_slam_step
from cv_monoslam_tpu.parallel.mesh import make_mesh as j_make_mesh
from cv_monoslam_tpu.parallel.mesh import state_shardings as j_shardings
from cv_monoslam_tpu_torch.api import SlamSession
from cv_monoslam_tpu_torch.config import SlamConfig
from cv_monoslam_tpu_torch.convert import state_from_arrays, state_to_arrays
from cv_monoslam_tpu_torch.filter.srukf import slam_step
from cv_monoslam_tpu_torch.io import fixtures as tfix
from cv_monoslam_tpu_torch.ops.host_reads import guarded
from cv_monoslam_tpu_torch.parallel import launch
from cv_monoslam_tpu_torch.parallel.mesh import (Layout, Mesh, check_layout,
                                                 make_mesh, replicate_hint,
                                                 state_shardings)
from cv_monoslam_tpu_torch.parallel.spmd import run_frames, sharded_slam_step
from test_spmd_filter import _cfg, _inputs

WORLDS = (1, 2, 4)
#: run_frames' redirect flags as host data: none, and one forced at frame 4
HOST_FLAGS = {"none": (False,) * 8,
              "frame4": (False,) * 4 + (True,) + (False,) * 3}
CASES = {
    # name: (M, seed, redirect, shard_sqrt, odo_cur override)
    "landmark": (16, 0, False, False, None),
    "redirect": (16, 3, True, False, [0.02, 0.0, 1.2]),
    "sqrt": (18, 1, False, True, None),
}
FRAMES = 8


def _port_cfg(jcfg) -> SlamConfig:
    return SlamConfig.from_json(jcfg.to_json())


def _case_inputs(name):
    m, seed, redirect, _, oc = CASES[name]
    jcfg = _cfg(m)
    state, img, op, oc0 = _inputs(jcfg, seed=seed)
    oc = oc0 if oc is None else np.array(oc, np.float32)
    return jcfg, state, img, op, oc, redirect


def _jax_sharded(name):
    jcfg, state, img, op, oc, redirect = _case_inputs(name)
    shard_sqrt = CASES[name][3]
    mesh = j_make_mesh(8)
    sh = j_shardings(mesh, jcfg, shard_sqrt=shard_sqrt)
    rep = NamedSharding(mesh, P())
    step = jax.jit(lambda st, im, a, b: j_slam_step(st, im, a, b, redirect,
                                                    jcfg),
                   in_shardings=(sh, rep, rep, rep), out_shardings=(sh, rep))
    with jax.sharding.set_mesh(mesh):
        st, out = step(jax.device_put(state, sh),
                       jax.device_put(jnp.asarray(img), rep),
                       jax.device_put(jnp.asarray(op), rep),
                       jax.device_put(jnp.asarray(oc), rep))
        jax.block_until_ready(st)
    return (state_to_arrays(st),
            {k: np.asarray(v) for k, v in out.items()})


def _track_inputs():
    """Config 1 on bench1_arc: the state after frame 0 and frames 0..7 as
    a single-device session prepares them, plus that session's records."""
    seq, track, _, _ = tfix.load("bench1_arc")
    cfg = SlamConfig(max_landmarks=32, max_new_per_frame=8,
                     max_detections=48)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # as each spawned rank computes
    try:
        sess = SlamSession(cfg, seq, track, device="cpu")
        state0 = launch.to_numpy(sess.state)
        images = np.stack([
            sess._to_device(sess._prep_image(
                seq.get(int(track.frame_id[k])))).numpy()
            for k in range(FRAMES)])
        odo = sess._odo[:FRAMES].numpy()
        redirect = np.asarray(sess._redirect[:FRAMES])
        sess.run(n_frames=FRAMES - 1, chunk=FRAMES - 1)
    finally:
        torch.set_num_threads(threads)
    return cfg, state0, images, odo, redirect, sess


@pytest.fixture(scope="module")
def ranks():
    """Every port case of the file on one spawned set of 4 gloo ranks."""
    cases, index = [], {}
    for name, (_, _, redirect, shard_sqrt, _) in CASES.items():
        jcfg, state, img, op, oc, _ = _case_inputs(name)
        cfg = _port_cfg(jcfg)
        st = launch.to_numpy(state_from_arrays(state_to_arrays(state),
                                               device="cpu"))
        args = (st, img, op, oc, redirect, cfg)
        index[name, "single"] = len(cases)
        cases.append((1, slam_step, args))
        for n in WORLDS:
            index[name, n] = len(cases)
            cases.append((n, sharded_slam_step,
                          args + (launch.MESH, Layout(shard_sqrt))))
    cfg, state0, images, odo, redirect, sess = _track_inputs()
    index["frames"] = len(cases)
    cases.append((4, run_frames, (state0, images, odo, redirect, cfg,
                                  launch.MESH, Layout())))
    for name, flags in HOST_FLAGS.items():
        for shard_sqrt in (False, True):
            # the redirect branch reads the host by design (it is eager
            # on one device too): only the frame step is guarded
            call = (guarded, run_frames) if name == "none" else (run_frames,)
            index[name, shard_sqrt] = len(cases)
            cases.append((1, call[0], call[1:] + (
                state0, images, odo, flags, cfg, launch.MESH,
                Layout(shard_sqrt))))
    try:
        res = launch.spawn(launch.run_cases, 4, "cpu", cases,
                           timeout_s=240.0)
    except OSError as e:       # no temporary file or process could start
        pytest.skip(f"gloo rendezvous unavailable: {e}")
    return res, index, sess


@pytest.fixture(scope="module")
def jax_sharded():
    return {name: _jax_sharded(name) for name in CASES}


def _close(got_state, got_out, want_state, want_out):
    np.testing.assert_allclose(got_out["pose"], want_out["pose"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_state["x"], want_state["x"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got_state["S"], want_state["S"], rtol=1e-3,
                               atol=1e-4)
    for k in ("lm_active", "lm_matched", "lm_lid"):
        np.testing.assert_array_equal(got_out[k], want_out[k], err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax_sharded_step(ranks, jax_sharded, name,
                                               world):
    res, index, _ = ranks
    st, out = res[0][index[name, world]]
    _close(state_to_arrays(st), out, *jax_sharded[name])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_single_device_step(ranks, name, world):
    res, index, _ = ranks
    st, out = res[0][index[name, world]]
    ref_st, ref_out = res[0][index[name, "single"]]
    got, want = state_to_arrays(st), state_to_arrays(ref_st)
    _close(got, out, want, ref_out)
    if world == 1:
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ref_out:
            np.testing.assert_array_equal(out[k], ref_out[k], err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_ends_with_the_same_state(ranks, name):
    res, index, _ = ranks
    for world in WORLDS:
        want = state_to_arrays(res[0][index[name, world]][0])
        for r in range(1, world):
            got = state_to_arrays(res[r][index[name, world]][0])
            for k in want:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{world} {r} {k}")
        for r in range(world, 4):
            assert res[r][index[name, world]] is None


def test_eight_frames_of_config1_at_four_ranks(ranks):
    res, index, sess = ranks
    recs = sess.records
    st, out = res[0][index["frames"]]
    assert [int(v) for v in out["n_map"]] == [r.n_map for r in recs]
    assert [int(v) for v in out["n_matched"]] == [r.n_matched for r in recs]
    assert max(r.n_matched for r in recs) > 0
    np.testing.assert_allclose(out["pose"], sess.trajectory, rtol=0,
                               atol=1e-5)
    want = state_to_arrays(sess.state)
    got = state_to_arrays(st)
    for k in ("lm.active", "lm.matched", "lm.lid", "lm.n_match"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for r in range(1, 4):
        np.testing.assert_array_equal(res[r][index["frames"]][1]["pose"],
                                      out["pose"])


@pytest.mark.parametrize("shard_sqrt", (False, True))
@pytest.mark.parametrize("flags", list(HOST_FLAGS))
def test_run_frames_reads_no_device_value(ranks, flags, shard_sqrt):
    """run_frames at one gloo rank with its redirect flags as host data: bit
    for bit the single-device ``slam_step`` over the same frames, one frame
    at a time on one thread as the rank computes; without a redirect under
    the host-read guard (no host read or upload outside
    ``control.host_bool``), and with a redirect forced at frame 4."""
    res, index, _ = ranks
    st, out = res[0][index[flags, shard_sqrt]]
    cfg, state0, images, odo, _, _ = _track_inputs()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state = state_from_arrays(state_to_arrays(launch.to_device(
            state0, "cpu")), device="cpu")
        poses, n_map = [], []
        for k in range(1, FRAMES):
            state, o = slam_step(state, torch.as_tensor(images[k]),
                                 torch.as_tensor(odo[k - 1]),
                                 torch.as_tensor(odo[k]),
                                 HOST_FLAGS[flags][k], cfg)
            poses.append(o["pose"].numpy())
            n_map.append(int(o["n_map"]))
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(out["pose"], np.stack(poses))
    assert [int(v) for v in out["n_map"]] == n_map
    got, want = state_to_arrays(st), state_to_arrays(state)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("shard_sqrt,m", [(True, 16), (False, 18)])
def test_layout_needs_divisible_sizes(shard_sqrt, m):
    """The JAX package's precondition and message, for 8 devices without
    eight processes; state_shardings checks the same on a mesh."""
    cfg = _port_cfg(_cfg(m))
    with pytest.raises(ValueError, match="divisible"):
        check_layout(cfg, 8, shard_sqrt)
    mesh = Mesh(group=None, rank=0, size=8, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="divisible"):
        state_shardings(mesh, cfg, shard_sqrt=shard_sqrt)
    ok = state_shardings(mesh, _port_cfg(_cfg(16 if m == 18 else 18)),
                         shard_sqrt=shard_sqrt)
    assert ok == Layout(shard_sqrt)


def test_replicate_hint_is_identity():
    x = torch.arange(3.0)
    assert replicate_hint(x) is x


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(device="cpu")


def test_nccl_needs_a_card_per_rank(tmp_path):
    """Two NCCL ranks on one card are refused before NCCL is asked."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has a card for each of two ranks")
    with pytest.raises(RuntimeError, match="one card per rank"):
        launch.init_process(0, 2, "cuda", str(tmp_path / "rendezvous"))
