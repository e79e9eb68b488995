"""The affine-warp approximation, measured for the port: the counterpart of
``tests/test_warp_deviation.py`` with the port's ``frontend/matching``.

The engine's patch warp is a 2x2 affine linearization of the plane-induced
homography at the patch centre without per-sample distortion; the
reference resamples through the full homography with a viewing-ray-averaged
normal and per-sample distort/undistort (SLAM.cpp:1804-1906, transcribed in
``models/projective_warp.py``). The two sweeps (``slow``, as in the JAX
file) bound the per-pixel difference and the NCC-peak displacement over
realistic pose deltas; the fast case holds the port's affine patch to the
JAX engine's at 1e-9 in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_monoslam_tpu.config import SlamConfig as JaxConfig
from cv_monoslam_tpu.filter import state as jstate
from cv_monoslam_tpu.frontend.matching import warp_patches as j_warp_patches
from cv_monoslam_tpu_torch.config import SlamConfig
from cv_monoslam_tpu_torch.filter.state import init_state, replace
from cv_monoslam_tpu_torch.frontend.matching import warp_patches
from cv_monoslam_tpu_torch.io.synthetic import make_world
from cv_monoslam_tpu_torch.models.oracle import OracleCamera, yaw
from cv_monoslam_tpu_torch.models.projective_warp import projective_warp_patch

CFG = SlamConfig(max_landmarks=4, dtype="float64")
CAM = OracleCamera(CFG)
WORLD = make_world(seed=3, cfg=CFG)
SWEEP = [
    ("small", (0.05, 0.0), 0.05),
    ("medium", (0.15, 0.05), 0.15),
    ("large", (0.30, 0.10), 0.30),
    ("rot-only", (0.0, 0.0), 0.35),
    ("trans-only", (0.35, 0.0), 0.0),
]


def _render(pose_xy, theta):
    return WORLD.render(np.asarray(pose_xy, float), float(theta))


def _setup_landmark():
    """Init view at the origin; landmark = ceiling point imaged ~80 px
    off-centre (off-axis so the homography has real perspective)."""
    frame0 = _render((0.0, 0.0), 0.0)
    init_px = np.array([390.0, 300.0])
    ray = CAM.image2camera(*CAM.undistort(*init_px))   # cam0 == world
    xyz = np.array([ray[0] * CFG.deep, ray[1] * CFG.deep, CFG.deep])
    hp = CFG.hp_init
    patch = frame0[int(init_px[1]) - hp:int(init_px[1]) + hp + 1,
                   int(init_px[0]) - hp:int(init_px[0]) + hp + 1]
    return init_px, xyz, patch.astype(np.float64)


def _engine_affine_warp(init_px, xyz, patch, pose, theta):
    """The port's warp path on a one-landmark state."""
    state = init_state(CFG, device="cpu")
    lm = state.lm
    lm.active[0] = True
    lm.lid[0] = 1
    lm.init_pixel[0] = torch.as_tensor(init_px)
    lm.init_trans[0] = 0.0
    lm.init_theta[0] = 0.0
    lm.init_patch[0] = torch.as_tensor(patch)
    lm.xyz[0] = torch.as_tensor(xyz)
    x = state.x.clone()
    x[-4:] = torch.tensor([pose[0], pose[1], 0.0, theta], dtype=x.dtype)
    return warp_patches(replace(state, x=x), CFG)[0].numpy()


def _jax_affine_warp(init_px, xyz, patch, pose, theta):
    """The JAX engine's warp path on the same one-landmark state."""
    jcfg = JaxConfig(max_landmarks=4, dtype="float64")
    state = jstate.init_state(jcfg)
    lm = state.lm
    lm.active[0] = True
    lm.lid[0] = 1
    lm.init_pixel[0] = init_px
    lm.init_trans[0] = 0.0
    lm.init_theta[0] = 0.0
    lm.init_patch[0] = patch
    lm.xyz[0] = xyz
    x = np.array(state.x)
    x[-4:] = [pose[0], pose[1], 0.0, theta]
    state = jstate.replace(state, x=jnp.asarray(x))
    return np.asarray(j_warp_patches(state, jcfg))[0]


def _predicted(xyz, pose, dth):
    return np.array(CAM.project(
        yaw(dth).T @ (xyz - np.array([pose[0], pose[1], 0.0]))))


def _projective(init_px, xyz, patch, pose, dth, pred):
    return projective_warp_patch(
        CAM, patch, init_px, yaw(0.0), np.zeros(3), pred, xyz, yaw(dth),
        np.array([pose[0], pose[1], 0.0]), CFG.hp_init, CFG.hp_match)


def _ncc_peak(region, tpl):
    """Integer NCC argmax of tpl inside region: (du, dv) from the region
    centre and the peak score."""
    rh, rw = region.shape
    th, tw = tpl.shape
    t = tpl - tpl.mean()
    tn = np.sqrt((t * t).sum()) or 1.0
    best, arg = -2.0, (0, 0)
    for oy in range(rh - th + 1):
        for ox in range(rw - tw + 1):
            w = region[oy:oy + th, ox:ox + tw]
            wc = w - w.mean()
            den = np.sqrt((wc * wc).sum()) * tn
            s = (wc * t).sum() / den if den > 0 else 0.0
            if s > best:
                best, arg = s, (ox, oy)
    return arg[0] - (rw - tw) // 2, arg[1] - (rh - th) // 2, best


def test_affine_patch_equals_the_jax_engines():
    """One pose delta (0.15 m, 0.05 m, 0.15 rad): the port's affine patch
    against the JAX engine's, float64, to 1e-9."""
    init_px, xyz, patch = _setup_landmark()
    pose, dth = np.array([0.15, 0.05]), 0.15
    got = _engine_affine_warp(init_px, xyz, patch, pose, dth)
    want = _jax_affine_warp(init_px, xyz, patch, pose, dth)
    assert (got > 0).mean() > 0.7
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.slow
def test_affine_vs_projective_patch_error():
    """Per-pixel deviation of the affine warp from the full projective warp
    stays under 8 % of the patch contrast across realistic pose deltas."""
    init_px, xyz, patch = _setup_landmark()
    for name, dxy, dth in SWEEP:
        pose = np.array(dxy)
        pred = _predicted(xyz, pose, dth)
        assert pred[0] != 0, f"{name}: landmark left the view"
        aff = _engine_affine_warp(init_px, xyz, patch, pose, dth)
        proj = _projective(init_px, xyz, patch, pose, dth, pred)
        both = (aff > 0) & (proj > 0)
        assert both.mean() > 0.7, f"{name}: warps barely overlap"
        contrast = patch.max() - patch.min()
        rms = np.sqrt(((aff - proj)[both] ** 2).mean())
        assert rms < 0.08 * contrast, (
            f"{name}: affine deviates {rms:.2f} vs contrast {contrast:.0f}")


@pytest.mark.slow
def test_affine_ncc_peak_matches_projective():
    """At realistic deltas (<= 0.15 m / 0.15 rad) the affine and projective
    templates peak at the true projection with scores near 1; at extreme
    combined deltas both scores fall toward the 0.8 acceptance threshold,
    so the failure mode is a rejected match, never a confident misplaced
    one."""
    init_px, xyz, patch = _setup_landmark()
    for name, dxy, dth in SWEEP:
        pose = np.array(dxy)
        frame1 = _render(pose, dth)
        pred = _predicted(xyz, pose, dth)
        pu, pv = int(round(pred[0])), int(round(pred[1]))
        r = CFG.hp_match + 6
        region = frame1[pv - r:pv + r + 1, pu - r:pu + r + 1]
        aff = _engine_affine_warp(init_px, xyz, patch, pose, dth)
        proj = _projective(init_px, xyz, patch, pose, dth, pred)
        ax, ay, ascore = _ncc_peak(region, aff)
        px_, py_, pscore = _ncc_peak(region, proj)
        if max(abs(pose[0]), abs(pose[1])) <= 0.15 and dth <= 0.15:
            assert ascore > 0.99 and pscore > 0.99, (
                f"{name}: scores {ascore:.3f}/{pscore:.3f}")
            assert (ax, ay) == (0, 0), (
                f"{name}: affine peak off true position ({ax},{ay})")
            assert abs(ax - px_) <= 1 and abs(ay - py_) <= 1
        else:
            assert abs(ascore - pscore) < 0.12, (
                f"{name}: scores {ascore:.3f} vs {pscore:.3f}")
            if (ax, ay) != (px_, py_):
                assert ascore < CFG.threshold_match_patch + 0.02, (
                    f"{name}: displaced affine peak with confident "
                    f"score {ascore:.3f}")
