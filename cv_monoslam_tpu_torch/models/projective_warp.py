"""Full projective patch warp — slow NumPy REFERENCE implementation.

The engine (frontend/matching.warp_matrices) and the serial oracle
(models/oracle.warp_matrix) both approximate the reference's patch warp
by a 2x2 affine linearization of the plane-induced homography at the
patch centre, without per-sample distortion. The reference instead
builds the full homography with a viewing-ray-AVERAGED plane normal
(SLAM.cpp:1833-1843) and resamples the patch per pixel with per-sample
distort/undistort chains (SLAM.cpp:1860-1906). This module transcribes
that full model so the affine approximation can be *measured* against it
(tests/test_warp_deviation.py — VERDICT r2 missing #1 — and, for this
package's ``frontend/matching``, tests/test_torch_warp_deviation.py). Like
``models/oracle.py`` it is host NumPy by design, a reference, and a copy of
``cv_monoslam_tpu/models/projective_warp.py``.

Conventions follow the engine/oracle camera: pixel vectors are (v, u, 1)
with camera X paired to the pixel row axis through (cx, f1) — see
geometry/camera.py for the reference's swapped-axis ceiling mount.
"""

from __future__ import annotations

import numpy as np


def _unit(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / (n if n > 0 else 1.0)


def _bilinear(img: np.ndarray, u: float, v: float) -> float:
    """Sample img at fractional (u=col, v=row); zero outside."""
    h, w = img.shape
    u0, v0 = int(np.floor(u)), int(np.floor(v))
    if u0 < 0 or v0 < 0 or u0 + 1 > w - 1 or v0 + 1 > h - 1:
        return 0.0
    du, dv = u - u0, v - v0
    return float(img[v0, u0] * (1 - du) * (1 - dv)
                 + img[v0, u0 + 1] * du * (1 - dv)
                 + img[v0 + 1, u0] * (1 - du) * dv
                 + img[v0 + 1, u0 + 1] * du * dv)


def projective_warp_patch(cam, init_patch: np.ndarray,
                          init_pixel: np.ndarray, init_rot: np.ndarray,
                          init_trans: np.ndarray, pred_pixel: np.ndarray,
                          xyz: np.ndarray, rot1: np.ndarray,
                          pos1: np.ndarray, hp_init: int,
                          hp_match: int) -> np.ndarray:
    """Warp the (2*hp_init+1)^2 init patch to the current view, full model.

    cam: models.oracle.OracleCamera; init_rot/rot1: (3,3) world-from-
    camera rotations at init/current; init_trans/pos1: camera positions.
    Returns the (2*hp_match+1)^2 warped patch (float64, zero where the
    source sample leaves the init patch — the reference leaves those
    entries at their zero initialization).

    Reference semantics reproduced (SLAM.cpp:1804-1906):
      * relative transform cam0 -> cam1 from the two poses;
      * plane normal = average of the UNIT VIEWING RAYS through the init
        pixel (cam0) and the predicted pixel (rotated into cam0) — NOT
        the true ceiling normal (SLAM.cpp:1833-1843);
      * plane distance from the landmark's Cartesian estimate along that
        normal;
      * homography H = K (R + t n^T / d) K^-1 between UNDISTORTED pixel
        coordinates;
      * patch centre = distort(H(undistort(init_pixel)));
      * every output sample: undistort in view 1 -> H^-1 -> distort in
        view 0 -> bilinear from the init patch (SLAM.cpp:1860-1906).
    """
    r0, c0 = init_rot, np.asarray(init_trans, float)
    r1, c1 = rot1, np.asarray(pos1, float)
    R10 = r1.T @ r0                        # cam0 -> cam1
    t10 = r1.T @ (c0 - c1)

    # averaged viewing-ray normal, in cam0 coordinates
    u0u, v0u = cam.undistort(*init_pixel)
    n0 = _unit(cam.image2camera(u0u, v0u))
    u1u, v1u = cam.undistort(*pred_pixel)
    n1 = _unit(R10.T @ cam.image2camera(u1u, v1u))
    n = _unit(n0 + n1)

    # plane distance along n of the landmark point in cam0
    x_c0 = r0.T @ (np.asarray(xyz, float) - c0)
    d = float(n @ x_c0)
    if abs(d) < 1e-9:
        d = 1e-9

    K = cam.K
    H10 = K @ (R10 + np.outer(t10, n) / d) @ np.linalg.inv(K)
    H01 = np.linalg.inv(H10)

    def apply_h(H, u, v):
        p = H @ np.array([v, u, 1.0])
        if p[2] == 0:
            p[2] = 1e-13
        return p[1] / p[2], p[0] / p[2]    # (u, v)

    # patch centre in the current (distorted) image
    cu, cv = apply_h(H10, u0u, v0u)
    cu, cv = cam.distort(cu, cv)

    Pm = 2 * hp_match + 1
    out = np.zeros((Pm, Pm), np.float64)
    ou0 = init_pixel[0] - hp_init          # init-patch origin in image0
    ov0 = init_pixel[1] - hp_init
    for j in range(Pm):                    # row (v offset)
        for i in range(Pm):                # col (u offset)
            u1 = cu - hp_match + i
            v1 = cv - hp_match + j
            uu, vv = cam.undistort(u1, v1)
            su, sv = apply_h(H01, uu, vv)
            su, sv = cam.distort(su, sv)
            if su == 0 and sv == 0:
                continue                   # sentinel: outside the image
            out[j, i] = _bilinear(init_patch, su - ou0, sv - ov0)
    return out
