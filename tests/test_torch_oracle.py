"""The port's copies of the reference oracle (``models/oracle.py``) and of
the full projective patch warp (``models/projective_warp.py``) against the
JAX package's: host NumPy on both sides, so every result must be equal
exactly (``np.array_equal``), on seeded inputs."""

import numpy as np
import pytest

from cv_monoslam_tpu.config import SlamConfig as JaxConfig
from cv_monoslam_tpu.models import oracle as jor
from cv_monoslam_tpu.models import projective_warp as jpw
from cv_monoslam_tpu_torch.config import SlamConfig
from cv_monoslam_tpu_torch.io.synthetic import get_sequence
from cv_monoslam_tpu_torch.models import oracle as tor
from cv_monoslam_tpu_torch.models import projective_warp as tpw


def test_oracle_slam_equals_the_jax_packages_over_10_frames():
    seq, track, _, _ = get_sequence("arc", 15, 0)
    j = jor.OracleSLAM(JaxConfig(dtype="float64"), seq, track)
    t = tor.OracleSLAM(SlamConfig(dtype="float64"), seq, track)
    for _ in range(10):
        j.step()
        t.step()
    assert np.array_equal(t.x, j.x)
    assert np.array_equal(t.S, j.S)
    assert [l.lid for l in t.landmarks] == [l.lid for l in j.landmarks]
    assert len(t.traj) == 10
    assert np.array_equal(np.stack(t.traj), np.stack(j.traj))


def test_numeric_helpers_equal_the_jax_packages():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(9, 6))
    assert np.array_equal(tor.qr_r(a), jor.qr_r(a))
    # an indefinite matrix takes the GMW floors, a PD one none
    for m in (a.T @ a, a.T @ a - 3.0 * np.eye(6), np.zeros((0, 0))):
        assert np.array_equal(tor.gmw_cholesky(m), jor.gmw_cholesky(m))

    img = rng.integers(0, 256, (40, 56)).astype(np.float64)
    u = rng.uniform(-2, 58, 200)
    v = rng.uniform(-2, 42, 200)
    assert np.array_equal(tor.bilinear(img, u, v), jor.bilinear(img, u, v))
    p, q = rng.normal(size=(17, 17)), rng.normal(size=(17, 17))
    assert tor.ncc(p, q) == jor.ncc(p, q)
    assert tor.ncc(p, np.ones((17, 17))) == 0.0
    frame = get_sequence("arc", 15, 0)[0].get(3)
    got = tor.good_features(frame, 30, 0.01, 10.0)
    assert len(got) == 30
    assert np.array_equal(got, jor.good_features(frame, 30, 0.01, 10.0))


def test_oracle_camera_equals_the_jax_packages():
    tc = tor.OracleCamera(SlamConfig())
    jc = jor.OracleCamera(JaxConfig())
    rng = np.random.default_rng(1)
    for u, v in rng.uniform([0, 0], [640, 480], (40, 2)):
        assert tc.undistort(u, v) == jc.undistort(u, v)
        assert tc.distort(u, v) == jc.distort(u, v)
    for hlr in rng.normal([0, 0, 3], [1.5, 1.5, 0.2], (40, 3)):
        assert tc.project(hlr) == jc.project(hlr)
    assert np.array_equal(tc.K, jc.K)


@pytest.mark.parametrize("dxy,dth", [((0.05, 0.0), 0.05),
                                     ((0.30, 0.10), 0.30)])
def test_projective_warp_patch_equals_the_jax_packages(dxy, dth):
    cfg = SlamConfig(dtype="float64")
    tc, jc = tor.OracleCamera(cfg), jor.OracleCamera(JaxConfig())
    rng = np.random.default_rng(2)
    hp = cfg.hp_init
    patch = rng.integers(0, 256, (2 * hp + 1, 2 * hp + 1)).astype(float)
    init_px = np.array([390.0, 300.0])
    ray = tc.image2camera(*tc.undistort(*init_px))
    xyz = np.array([ray[0] * cfg.deep, ray[1] * cfg.deep, cfg.deep])
    pos1 = np.array([dxy[0], dxy[1], 0.0])
    pred = np.array(tc.project(tor.yaw(dth).T @ (xyz - pos1)))
    args = (patch, init_px, tor.yaw(0.0), np.zeros(3), pred, xyz,
            tor.yaw(dth), pos1, hp, cfg.hp_match)
    got = tpw.projective_warp_patch(tc, *args)
    assert got.shape == (2 * cfg.hp_match + 1,) * 2
    assert (got > 0).mean() > 0.7
    assert np.array_equal(got, jpw.projective_warp_patch(jc, *args))
