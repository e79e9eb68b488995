"""PyTorch port: the row-sharded blocked Cholesky (``parallel/dist_chol.py``)
and its use in the filter's joint update, vs the JAX package's.

The JAX side runs in this process on its 8 fake CPU devices, as
``tests/test_dist_chol.py`` runs it, on that file's seeded float32 SPD
matrices. The port's side runs on ``gloo`` ranks spawned once for the file
(world size 4; the 1- and 2-rank cases on meshes of the first ranks).

Tolerances, float32 as in the JAX test and taken from it: against the
reference factorization rtol 2e-4 / atol 2e-4 * n; across rank counts and
between the packages rtol 1e-4 / atol 1e-2; the padded case's R^T R against
A rtol 1e-4 / atol 1e-2 * n; the filter with the distributed factorization
against the replicated one, x rtol 1e-3 / atol 1e-4 and S rtol 1e-2 /
atol 1e-3. Exact: the factor is upper triangular with zeros below the
diagonal, and an indefinite matrix gives a non-finite factor.
"""

import numpy as np
import pytest
import torch
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from cv_monoslam_tpu.config import CameraConfig as JaxCamera
from cv_monoslam_tpu.config import SlamConfig as JaxConfig
from cv_monoslam_tpu.filter.srukf import slam_step as j_slam_step
from cv_monoslam_tpu.filter.state import init_state as j_init_state
from cv_monoslam_tpu.parallel.dist_chol import (
    chol_rowsharded as j_chol, chol_rowsharded_padded as j_chol_padded)
from cv_monoslam_tpu.parallel.mesh import make_mesh as j_make_mesh
from cv_monoslam_tpu.parallel.mesh import state_shardings as j_shardings
from cv_monoslam_tpu_torch.config import SlamConfig
from cv_monoslam_tpu_torch.convert import state_from_arrays, state_to_arrays
from cv_monoslam_tpu_torch.filter import update
from cv_monoslam_tpu_torch.ops.host_reads import guarded
from cv_monoslam_tpu_torch.parallel import launch
from cv_monoslam_tpu_torch.parallel.dist_chol import (chol_rowsharded,
                                                      chol_rowsharded_padded)
from cv_monoslam_tpu_torch.parallel.mesh import Layout, Mesh, make_mesh, \
    set_mesh
from cv_monoslam_tpu_torch.parallel.spmd import sharded_slam_step
from test_dist_chol import _spd

REFERENCE = [(512, 4, 64), (256, 2, 128)]
INVARIANCE = (1, 2, 4)


def _filter_inputs(dist_panel):
    """The implicit configuration of tests/test_dist_chol.py's filter test
    (M = 10, D = 64, no detection), one seeded image for every run."""
    kw = dict(max_landmarks=10, max_new_per_frame=4, max_detections=16,
              update_mode="gram", qr_mode="gram", sigma_mode="implicit",
              gate_detection=False, dist_chol_panel=dist_panel)
    cam = dict(width=128, height=96, cx=64.0, cy=48.0)
    jcfg = JaxConfig(**kw, camera=JaxCamera(**cam))
    state = j_init_state(jcfg)
    state.lm.active[:4] = True
    state.lm.lid[:4] = np.arange(1, 5)
    for i in range(4):
        state.x[6 * i: 6 * i + 6] = [0, 0, 0, 0.1 * i - 0.15, 0.05,
                                     1.0 / jcfg.deep]
    rng = np.random.default_rng(2)
    img = np.asarray(rng.uniform(0, 255, (cam["height"], cam["width"])),
                     np.float32)
    odo = (np.zeros(3, np.float32), np.array([0.02, 0.0, 0.01], np.float32))
    return jcfg, state, img, odo


def _jax_filter(dist_panel):
    jcfg, state, img, (op, oc) = _filter_inputs(dist_panel)
    mesh = j_make_mesh(8)
    sh = j_shardings(mesh, jcfg, shard_sqrt=True)
    rep = NamedSharding(mesh, P())
    with jax.sharding.set_mesh(mesh):
        step = jax.jit(
            lambda st, im, a, b: j_slam_step(st, im, a, b, False, jcfg,
                                             allow_detect=False),
            in_shardings=(sh, rep, rep, rep), out_shardings=(sh, rep))
        st, _ = step(jax.device_put(state, sh), jax.device_put(img, rep),
                     jax.device_put(op, rep), jax.device_put(oc, rep))
        jax.block_until_ready(st)
    return np.asarray(st.x), np.asarray(st.S)


#: smallest eigenvalue of the joint-update matrices and the repair level
#: each needs: clean, repaired by the 1e-3 shift, beyond it
RUNGS = {1e-2: 0, -5e-4: 1, -1.0: 4}


def _rung_matrix(low, n=300, seed=4):
    """float64 symmetric, eigenvalues from ``low`` to 2 (n = 300 pads to
    320: at 4 ranks 80 rows each, so panels span ranks)."""
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(n, n)))
    return (q * np.linspace(low, 2.0, n)) @ q.T


def _indefinite(n=200, seed=11):
    a = _spd(n, seed)
    a[0, 0] = -1.0
    return a


@pytest.fixture(scope="module")
def ranks():
    """Every port case of the file on one spawned set of 4 gloo ranks."""
    M, Rows = launch.MESH, launch.Rows
    cases, index = [], {}

    def add(key, n, fn, args):
        index[key] = len(cases)
        cases.append((n, fn, args))

    for n, ndev, panel in REFERENCE:
        add(("ref", n), ndev, chol_rowsharded, (Rows(_spd(n)), M, panel))
    add("spanning", 4, chol_rowsharded, (Rows(_spd(384, seed=7)), M, 64))
    add("padded", 4, chol_rowsharded_padded, (_spd(300, seed=5), M, 64))
    for nd in INVARIANCE:
        add(("invariance", nd), nd, chol_rowsharded_padded,
            (_spd(384, seed=3), M, 64))
    add("indefinite", 4, chol_rowsharded_padded, (_indefinite(), M, 64))
    for nd in (1, 4):
        for low in RUNGS:
            add(("rung", nd, low), nd, guarded,
                (launch.ambient, update._dist_joint_chol, M, _rung_matrix(low),
                 64))
    step = partial(sharded_slam_step, allow_detect=False)
    for panel in (0, 64):
        jcfg, state, img, (op, oc) = _filter_inputs(panel)
        st = launch.to_numpy(state_from_arrays(state_to_arrays(state),
                                               device="cpu"))
        add(("filter", panel), 4, step,
            (st, img, op, oc, False, SlamConfig.from_json(jcfg.to_json()),
             M, Layout(shard_sqrt=True)))
    try:
        res = launch.spawn(launch.run_cases, 4, "cpu", cases,
                           timeout_s=240.0)
    except OSError as e:       # no temporary file or process could start
        pytest.skip(f"gloo rendezvous unavailable: {e}")
    return res, index


def _rows(res, i, n_ranks):
    """The row blocks of case ``i`` from its ranks, stacked."""
    return np.concatenate([res[r][i] for r in range(n_ranks)])


@pytest.mark.parametrize("n,ndev,panel", REFERENCE)
def test_matches_reference_cholesky(ranks, n, ndev, panel):
    res, index = ranks
    R = _rows(res, index["ref", n], ndev)
    spd = _spd(n)
    assert np.abs(np.tril(R, -1)).max() == 0.0
    np.testing.assert_allclose(R, np.linalg.cholesky(spd).T, rtol=2e-4,
                               atol=2e-4 * n)
    jr = np.asarray(j_chol(jnp.asarray(spd), j_make_mesh(ndev), panel))
    np.testing.assert_allclose(R, jr, rtol=1e-4, atol=1e-2)


def test_panel_spanning_ranks(ranks):
    # rows_loc = 384 / 4 = 96 is not a multiple of the panel (64): panels
    # span two ranks, whose broadcasts assemble the diagonal block
    res, index = ranks
    R = _rows(res, index["spanning"], 4)
    spd = _spd(384, seed=7)
    np.testing.assert_allclose(R, np.linalg.cholesky(spd).T, rtol=2e-4,
                               atol=2e-4 * 384)
    jr = np.asarray(j_chol(jnp.asarray(spd), j_make_mesh(8), 64))
    np.testing.assert_allclose(R, jr, rtol=1e-4, atol=1e-2)


def test_padded_arbitrary_n(ranks):
    # 300 divides by neither 4 nor 64: identity-padded embedding
    res, index = ranks
    spd = _spd(300, seed=5)
    for r in range(4):                       # replicated on every rank
        np.testing.assert_array_equal(res[r][index["padded"]],
                                      res[0][index["padded"]])
    R = res[0][index["padded"]]
    assert R.shape == (300, 300)
    np.testing.assert_allclose(R.T @ R, spd, rtol=1e-4, atol=1e-2 * 300)
    jr = np.asarray(j_chol_padded(jnp.asarray(spd), j_make_mesh(8), 64))
    np.testing.assert_allclose(R, jr, rtol=1e-4, atol=1e-2)


def test_rank_count_invariance(ranks):
    res, index = ranks
    outs = [res[0][index["invariance", nd]] for nd in INVARIANCE]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=1e-4, atol=1e-2)
    spd = jnp.asarray(_spd(384, seed=3))
    for nd in (1, 2, 8):
        jr = np.asarray(j_chol_padded(spd, j_make_mesh(nd), 64))
        np.testing.assert_allclose(outs[0], jr, rtol=1e-4, atol=1e-2)


def test_indefinite_matrix_gives_nonfinite_factor(ranks):
    res, index = ranks
    assert not np.isfinite(res[0][index["indefinite"]]).all()
    jr = np.asarray(j_chol_padded(jnp.asarray(_indefinite()),
                                  j_make_mesh(4), 64))
    assert not np.isfinite(jr).all()


def test_filter_update_dist_matches_replicated(ranks):
    """One slam_step under the shard_sqrt layout at 4 ranks:
    dist_chol_panel=64 factorizes across the mesh and must give the
    replicated factorization's posterior, and the JAX package's."""
    res, index = ranks
    (st0, _), (st64, _) = (res[0][index["filter", p]] for p in (0, 64))
    x0, s0 = st0.x, st0.S
    x1, s1 = st64.x, st64.S
    np.testing.assert_allclose(x1, x0, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(s1, s0, rtol=1e-2, atol=1e-3)
    jx, js = _jax_filter(64)
    np.testing.assert_allclose(x1, jx, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(s1, js, rtol=1e-2, atol=1e-3)


def test_repair_ladder_on_a_one_rank_mesh(tmp_path):
    """update._dist_joint_chol on a 1-rank gloo mesh in this process: a
    clean factorization is level 0, one that the 1e-3 shift repairs level
    1, and one it cannot repair level 4 with a non-finite factor."""
    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.normal(size=(100, 100)))
    launch.init_process(0, 1, "cpu", str(tmp_path / "rendezvous"))
    try:
        mesh = make_mesh(device="cpu")
        with set_mesh(mesh):
            for low, want in ((1e-2, 0), (-5e-4, 1), (-1.0, 4)):
                eig = np.linspace(low, 2.0, 100)
                js = torch.as_tensor((q * eig) @ q.T)
                r, level = update._dist_joint_chol(js, 64)
                assert level == want, (low, level)
                assert bool(torch.isfinite(r).all()) == (want < 4)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def jax_rungs():
    """The JAX package's ``_dist_joint_chol`` jitted under ``set_mesh`` of
    4 of its fake devices, on each matrix of :data:`RUNGS`."""
    from cv_monoslam_tpu.filter import update as jupdate

    out = {}
    with jax.sharding.set_mesh(j_make_mesh(4)):
        fn = jax.jit(lambda js: jupdate._dist_joint_chol(js, 64))
        for low in RUNGS:
            r, level = fn(jnp.asarray(_rung_matrix(low)))
            out[low] = (np.asarray(r), int(level))
    return out


@pytest.mark.parametrize("low", list(RUNGS))
@pytest.mark.parametrize("ndev", (1, 4))
def test_dist_joint_chol_matches_jax(ranks, jax_rungs, ndev, low):
    """update._dist_joint_chol at 1 and 4 gloo ranks under the host-read
    guard (no host read, no upload outside ``control.host_bool``; the rung
    is a ``control.if_``, read once on the host here): the level a 0-d
    device tensor equal to JAX's, the factor to 1e-9 relative of JAX's
    (float64), every rank the same; non-finite at level 4 in both."""
    res, index = ranks
    jr, jlevel = jax_rungs[low]
    assert jlevel == RUNGS[low]
    r, level = res[0][index["rung", ndev, low]]
    assert level.shape == () and level.dtype == np.int32
    assert int(level) == jlevel
    for q in range(1, ndev):
        np.testing.assert_array_equal(res[q][index["rung", ndev, low]][0], r)
    if jlevel == 4:
        assert not np.isfinite(r).all() and not np.isfinite(jr).all()
    else:
        np.testing.assert_allclose(r, jr, rtol=1e-9,
                                   atol=1e-9 * np.abs(jr).max())


def test_dispatch_needs_the_panel_and_an_ambient_mesh():
    mesh = Mesh(group=None, rank=0, size=4, device=torch.device("cpu"))
    on, off = SlamConfig(dist_chol_panel=64), SlamConfig()
    assert not update._use_dist_chol(on)
    with set_mesh(mesh):
        assert update._use_dist_chol(on)
        assert not update._use_dist_chol(off)
        assert not update._use_dist_chol(None)
    assert not update._use_dist_chol(on)


def test_row_blocks_must_divide():
    mesh = Mesh(group=None, rank=0, size=4, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide"):
        chol_rowsharded(torch.eye(100)[:25], mesh, 64)
