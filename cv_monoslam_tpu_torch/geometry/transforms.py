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


def inverse_depth_to_cartesian(feat6: torch.Tensor) -> torch.Tensor:
    """Landmark 6-state -> world xyz (SLAM.cpp:2721-2751, 2766-2778)."""
    anchor = feat6[..., 0:3]
    theta, phi, rho = feat6[..., 3], feat6[..., 4], feat6[..., 5]
    return anchor + ray_from_angles(theta, phi) / _safe_rho(rho)[..., None]
