"""PyTorch port: camera model and frame transforms vs the JAX package.

Same seeded inputs (numpy) through both, float64 on the CPU. Tolerance:
1e-9 absolute on pixels (values up to ~640) and 1e-12 on unit-scale
quantities — the same closed forms evaluated in the same order, so only
last-bit differences of the math libraries remain.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_monoslam_tpu.config import CameraConfig as JaxCamera
from cv_monoslam_tpu.geometry import camera as jcam
from cv_monoslam_tpu.geometry import transforms as jtf
from cv_monoslam_tpu_torch.config import CameraConfig
from cv_monoslam_tpu_torch.geometry import camera as tcam
from cv_monoslam_tpu_torch.geometry import transforms as ttf

JCAM = JaxCamera()
TCAM = CameraConfig()


def _pix(rng, n=200):
    # inside, near and beyond the border (sentinel cases)
    return np.stack([rng.uniform(-20, 660, n), rng.uniform(-20, 500, n)], 1)


def _hlr(rng, n=200):
    h = rng.normal(0, 0.6, (n, 3))
    h[:, 2] = rng.uniform(0.5, 4.0, n)
    h[:5, 2] = 0.0                                   # Z == 0 guard
    return h


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def test_undistort_distort_match_jax():
    rng = np.random.default_rng(0)
    p = _pix(rng)
    _close(tcam.undistort(TCAM, torch.as_tensor(p)),
           jcam.undistort(JCAM, jnp.asarray(p)), 1e-9)
    _close(tcam.distort(TCAM, torch.as_tensor(p)),
           jcam.distort(JCAM, jnp.asarray(p)), 1e-9)


@pytest.mark.parametrize("with_err", [False, True])
def test_camera2image_and_project_match_jax(with_err):
    rng = np.random.default_rng(1)
    h = _hlr(rng)
    err = rng.normal(0, 2.0, (len(h), 2)) if with_err else None
    terr = torch.as_tensor(err) if with_err else None
    jerr = jnp.asarray(err) if with_err else None
    _close(tcam.camera2image(TCAM, torch.as_tensor(h), terr),
           jcam.camera2image(JCAM, jnp.asarray(h), jerr), 1e-9)
    got = tcam.project(TCAM, torch.as_tensor(h), terr)
    want = jcam.project(JCAM, jnp.asarray(h), jerr)
    _close(got, want, 1e-9)
    # the (0, 0) sentinel lands on the same points
    np.testing.assert_array_equal(got.numpy() == 0, np.asarray(want) == 0)


def test_image2camera_matches_jax():
    p = _pix(np.random.default_rng(2))
    _close(tcam.image2camera(TCAM, torch.as_tensor(p)),
           jcam.image2camera(JCAM, jnp.asarray(p)), 1e-12)


def test_transforms_match_jax():
    rng = np.random.default_rng(3)
    feat = rng.normal(0, 0.5, (50, 6))
    feat[:, 5] = rng.uniform(0.05, 1.0, 50)
    feat[0, 5] = 0.0                                  # rho == 0 guard
    pos = rng.normal(0, 1.0, (50, 3))
    th = rng.uniform(-np.pi, np.pi, 50)
    _close(ttf.yaw_matrix(torch.as_tensor(th)),
           jtf.yaw_matrix(jnp.asarray(th)), 1e-12)
    _close(ttf.wrap_angle(torch.as_tensor(4 * th)),
           jtf.wrap_angle(jnp.asarray(4 * th)), 1e-12)
    tf_, jf = torch.as_tensor(feat), jnp.asarray(feat)
    tp, jp = torch.as_tensor(pos), jnp.asarray(pos)
    for fn, jfn, args, jargs in (
            (ttf.state_to_world, jtf.state_to_world, (tf_, tp), (jf, jp)),
            (ttf.inverse_depth_to_cartesian, jtf.inverse_depth_to_cartesian,
             (tf_,), (jf,))):
        got, want = fn(*args).numpy(), np.asarray(jfn(*jargs))
        # the rho == 0 row is ~1e13 in size: relative comparison there
        np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=1e-9)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    _close(ttf.world_to_angles(torch.as_tensor(pos)),
           jtf.world_to_angles(jnp.asarray(pos)), 1e-12)
