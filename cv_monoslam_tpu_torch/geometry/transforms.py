"""Frame transforms and the inverse-depth parameterization (torch).

Covers the reference's coordinate machinery (MonoSLAM/SLAM.cpp:1031-1037,
3250-3420, 2721-2751) as batched functions on tensors.

State layout (per reference SLAM.h:271, SLAM.cpp:1184): a landmark is the
6-vector (x, y, z, theta, phi, rho) — anchor position, azimuth, elevation,
inverse depth; the robot pose is the 4-vector (x, y, z, theta).
"""

from __future__ import annotations

import torch


def yaw_matrix(theta: torch.Tensor) -> torch.Tensor:
    """World-from-camera yaw-only rotation R_wc (SLAM.cpp:1031-1037).

    Batched: theta (...,) -> (..., 3, 3).
    """
    c, s = torch.cos(theta), torch.sin(theta)
    z = torch.zeros_like(theta)
    o = torch.ones_like(theta)
    return torch.stack(
        [
            torch.stack([c, -s, z], dim=-1),
            torch.stack([s, c, z], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi] — single-branch version of SLAM.cpp:507-519."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def ray_from_angles(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Direction m(theta, phi) used by inverse depth (SLAM.cpp:3270-3276):
    (cos(phi) sin(theta), -sin(phi), cos(phi) cos(theta))."""
    cp = torch.cos(phi)
    return torch.stack(
        [cp * torch.sin(theta), -torch.sin(phi), cp * torch.cos(theta)],
        dim=-1)


def _safe_rho(rho: torch.Tensor) -> torch.Tensor:
    return torch.where(rho == 0.0, torch.full_like(rho, 1e-13), rho)


def state_to_world(feat6: torch.Tensor, cam_pos: torch.Tensor) -> torch.Tensor:
    """Inverse-depth landmark -> camera-to-landmark vector in world frame.

    Hlw = anchor + m(theta, phi)/rho - cam_pos (SLAM.cpp:3250-3278).
    feat6: (..., 6); cam_pos: (..., 3) -> (..., 3).
    """
    anchor = feat6[..., 0:3]
    theta, phi, rho = feat6[..., 3], feat6[..., 4], feat6[..., 5]
    m = ray_from_angles(theta, phi)
    return anchor + m / _safe_rho(rho)[..., None] - cam_pos


def world_to_angles(hlw: torch.Tensor) -> torch.Tensor:
    """Direction vector -> (theta, phi) (SLAM.cpp:3398-3420):
    theta = atan2(x, z); phi = atan2(-y, sqrt(x^2 + z^2))."""
    x, y, z = hlw[..., 0], hlw[..., 1], hlw[..., 2]
    theta = torch.atan2(x, z)
    phi = torch.atan2(-y, torch.sqrt(x * x + z * z))
    return torch.stack([theta, phi], dim=-1)


def world_to_camera(hlw: torch.Tensor, rcw: torch.Tensor) -> torch.Tensor:
    """Rotate world vector into camera frame (SLAM.cpp:3290-3310)."""
    return torch.einsum("...ij,...j->...i", rcw, hlw)


def camera_to_world(hlr: torch.Tensor, rwc: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", rwc, hlr)


def inverse_depth_to_cartesian(feat6: torch.Tensor) -> torch.Tensor:
    """Landmark 6-state -> world xyz (SLAM.cpp:2721-2751, 2766-2778)."""
    anchor = feat6[..., 0:3]
    theta, phi, rho = feat6[..., 3], feat6[..., 4], feat6[..., 5]
    return anchor + ray_from_angles(theta, phi) / _safe_rho(rho)[..., None]


def cartesian_jacobian(feat6: torch.Tensor) -> torch.Tensor:
    """d(xyz)/d(feat6) analytic Jacobian, (..., 3, 6) (SLAM.cpp:2743-2748)."""
    theta, phi, rho = feat6[..., 3], feat6[..., 4], feat6[..., 5]
    r = _safe_rho(rho)
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    r2 = r * r
    eye = torch.eye(3, dtype=feat6.dtype, device=feat6.device).expand(
        *theta.shape, 3, 3)
    dang = torch.stack(
        [
            torch.stack([cp * ct / r, -sp * st / r, -cp * st / r2], dim=-1),
            torch.stack([torch.zeros_like(r), -cp / r, sp / r2], dim=-1),
            torch.stack([-cp * st / r, -sp * ct / r, -cp * ct / r2], dim=-1),
        ],
        dim=-2,
    )
    return torch.cat([eye, dang], dim=-1)


def rotation_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """3x3 rotation -> quaternion (w, x, y, z), branch-free (reference:
    SLAM.cpp:2903-2948 uses the max-trace branch ladder)."""
    m01, m02 = R[..., 0, 1], R[..., 0, 2]
    m10, m12 = R[..., 1, 0], R[..., 1, 2]
    m20, m21 = R[..., 2, 0], R[..., 2, 1]
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    qw = 0.5 * torch.sqrt(torch.clamp(1.0 + tr, min=1e-12))
    denom = torch.where(qw < 1e-6, torch.ones_like(qw), 4.0 * qw)
    qx = (m21 - m12) / denom
    qy = (m02 - m20) / denom
    qz = (m10 - m01) / denom
    return torch.stack([qw, qx, qy, qz], dim=-1)


def covariance_ellipsoid(cov3: torch.Tensor):
    """1-sigma ellipsoid axes + orientation quaternion from a 3x3 covariance
    (SLAM.cpp:2791-2802, 2815-2948). Returns (sigma (...,3), quat (...,4)).

    A covariance that is not finite gives what ``jnp.linalg.eigh`` gives
    (it factors the symmetrized input, and returns NaN where
    ``torch.linalg.eigh`` raises): sigma NaN; the quaternion of the
    identity when the only non-finite entries are infinities on the
    diagonal, else NaN. ``eigh`` runs on the identity in place of such a
    covariance, so the finite ones keep their values."""
    sym = (cov3 + cov3.mT) / 2
    finite = torch.isfinite(sym).all(dim=(-2, -1))
    diag = torch.diagonal(sym, dim1=-2, dim2=-1)
    off = ~torch.eye(3, dtype=torch.bool, device=cov3.device)
    inf_diag_only = (torch.isfinite(sym[..., off]).all(dim=-1)
                     & ~torch.isnan(diag).any(dim=-1))
    eye = torch.eye(3, dtype=cov3.dtype, device=cov3.device)
    w, v = torch.linalg.eigh(torch.where(finite[..., None, None], cov3, eye))
    nan = torch.full_like(w[..., :1], float("nan"))
    sigma = torch.where(finite[..., None], torch.sqrt(torch.clamp(w, min=0.0)),
                        nan)
    quat = torch.where((finite | inf_diag_only)[..., None],
                       rotation_to_quaternion(v), nan)
    return sigma, quat
