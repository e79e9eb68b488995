"""PyTorch port: distributed bundle adjustment (``parallel/dist_ba.py``) vs
the JAX package's sharded solver and vs the port's single-device
``ba_solve``.

The JAX side runs in this process on its 8 fake CPU devices, as
``tests/test_dist_ba.py`` runs it, on that file's problems
(``tests/test_backend.py::_make_problem``, seeded, float64). The port's side
runs on ``gloo`` ranks spawned once for the file (world size 4; the 1- and
2-rank cases on meshes of the first ranks); each rank returns its block of
landmarks, which the test stacks in rank order.

Tolerances, float64 as in the JAX test and taken from it: poses and
landmarks rtol 1e-9 / atol 1e-11 (the all_reduce sums the landmark blocks in
another order than one device does); costs rtol 1e-6 / atol 1e-12 (they
decay toward roundoff, where the order shows).
"""

import dataclasses

import numpy as np
import pytest
import torch

from cv_monoslam_tpu.backend.ba import ba_solve as j_ba_solve
from cv_monoslam_tpu.parallel.dist_ba import \
    ba_solve_sharded as j_ba_solve_sharded
from cv_monoslam_tpu.parallel.mesh import make_mesh as j_make_mesh
from cv_monoslam_tpu_torch.backend.ba import (BAProblem, ba_solve,
                                              reprojection_rmse)
from cv_monoslam_tpu_torch.config import CameraConfig, SlamConfig
from cv_monoslam_tpu_torch.parallel import launch
from cv_monoslam_tpu_torch.parallel.dist_ba import ba_solve_sharded
from cv_monoslam_tpu_torch.parallel.mesh import Mesh
from test_backend import CFG as JCFG, _make_problem

CFG = SlamConfig(dtype="float64", ba_iters=8,
                 camera=CameraConfig(width=640, height=480))
WORLDS = (1, 2, 4)
#: name: (seed, W, L, perturb) — the problems of tests/test_dist_ba.py
PROBLEMS = {"single": (0, 5, 16, 0.02), "geometry": (1, 5, 16, 0.03),
            "sizes": (2, 4, 16, 0.01)}


def _problems():
    """Each JAX problem and its port twin (numpy leaves)."""
    out = {}
    for name, (seed, W, L, perturb) in PROBLEMS.items():
        jprob, _, _ = _make_problem(np.random.default_rng(seed), W=W, L=L,
                                    perturb=perturb)
        tprob = BAProblem(**{
            f.name: (None if getattr(jprob, f.name) is None
                     else np.asarray(getattr(jprob, f.name)))
            for f in dataclasses.fields(BAProblem)})
        out[name] = (jprob, tprob)
    return out


@pytest.fixture(scope="module")
def problems():
    return _problems()


@pytest.fixture(scope="module")
def ranks(problems):
    """Every port case of the file on one spawned set of 4 gloo ranks."""
    cases, index = [], {}
    for name, (_, tprob) in problems.items():
        index[name, "single"] = len(cases)
        cases.append((1, ba_solve, (tprob, CFG)))
        for n in WORLDS:
            index[name, n] = len(cases)
            cases.append((n, ba_solve_sharded, (tprob, CFG, launch.MESH)))
    try:
        res = launch.spawn(launch.run_cases, 4, "cpu", cases,
                           timeout_s=240.0)
    except OSError as e:       # no temporary file or process could start
        pytest.skip(f"gloo rendezvous unavailable: {e}")
    return res, index


def _sharded(res, i, n):
    """(poses, all landmarks stacked from the ranks' blocks, costs)."""
    poses, _, costs = res[0][i]
    for r in range(1, n):                    # poses and costs replicated
        np.testing.assert_array_equal(res[r][i][0], poses)
        np.testing.assert_array_equal(res[r][i][2], costs)
    return poses, np.concatenate([res[r][i][1] for r in range(n)]), costs


def _assert_solution(got, want):
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_single_device(ranks, world):
    res, index = ranks
    got = _sharded(res, index["single", world], world)
    _assert_solution(got, res[0][index["single", "single"]])


@pytest.fixture(scope="module")
def jax_solutions(problems):
    """The JAX package's sharded (8 devices) and single-device solutions."""
    jprob = problems["single"][0]
    return [[np.asarray(v) for v in out]
            for out in (j_ba_solve_sharded(jprob, JCFG, j_make_mesh(8)),
                        j_ba_solve(jprob, JCFG))]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_jax_sharded(ranks, jax_solutions, world):
    res, index = ranks
    got = _sharded(res, index["single", world], world)
    for want in jax_solutions:
        _assert_solution(got, want)


def test_sharded_improves_geometry(ranks, problems):
    res, index = ranks
    poses, lms, _ = _sharded(res, index["geometry", 4], 4)
    prob = launch.to_device(problems["geometry"][1], torch.device("cpu"))
    r = float(reprojection_rmse(torch.as_tensor(poses), torch.as_tensor(lms),
                                prob, CFG))
    assert r < 1e-2


def test_mesh_sizes(ranks, problems):
    res, index = ranks
    ref = _sharded(res, index["sizes", 1], 1)[0]
    for n in WORLDS[1:]:
        np.testing.assert_allclose(_sharded(res, index["sizes", n], n)[0],
                                   ref, rtol=1e-9, atol=1e-11)
    jposes = np.asarray(j_ba_solve_sharded(problems["sizes"][0], JCFG,
                                           j_make_mesh(2))[0])
    np.testing.assert_allclose(ref, jposes, rtol=1e-9, atol=1e-11)


def test_landmarks_must_divide_by_the_mesh(problems):
    mesh = Mesh(group=None, rank=0, size=3, device=torch.device("cpu"))
    prob = launch.to_device(problems["single"][1], torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide"):
        ba_solve_sharded(prob, CFG, mesh)
