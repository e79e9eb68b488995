"""Pinhole + radial-distortion camera model (batched, torch).

Reproduces the reference camera semantics (MonoSLAM/SLAM.cpp:3177-3420)
including its ceiling-mount axis convention, with a fixed-iteration Newton
distortion instead of the reference's 100-iteration loop
(SLAM.cpp:3186-3193 — converges in < 5 for this lens).

Pixel convention used throughout this package: ``pix[..., 0]`` = u = column
index (width axis), ``pix[..., 1]`` = v = row index (height axis).

The reference maps camera coordinates to pixels as (SLAM.cpp:3338-3339):
    column u  =  cy + f2 * Y/Z
    row    v  =  cx + f1 * X/Z
and inverts identically (SLAM.cpp:3360-3363): camera X pairs with the *row*
axis through (cx, f1) and camera Y with the *column* axis through (cy, f2).
Radial distortion is centred at (cx on u, cy on v) (SLAM.cpp:3181-3182).

An out-of-view projection is encoded by the (0, 0) pixel sentinel, as in the
reference (SLAM.cpp:3206-3212, 3341-3345).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import CameraConfig


def undistort(cam: CameraConfig, pix_d: torch.Tensor) -> torch.Tensor:
    """Distorted pixel -> undistorted pixel, closed form (SLAM.cpp:3224-3236)."""
    xd = (pix_d[..., 0] - cam.cx) * cam.dx
    yd = (pix_d[..., 1] - cam.cy) * cam.dy
    rd2 = xd * xd + yd * yd
    d = 1.0 + cam.k1 * rd2 + cam.k2 * rd2 * rd2
    return torch.stack(
        [cam.cx + xd * d / cam.dx, cam.cy + yd * d / cam.dy], dim=-1)


def distort(cam: CameraConfig, pix_u: torch.Tensor) -> torch.Tensor:
    """Undistorted pixel -> distorted pixel via Newton solve for r_d.

    Mirrors SLAM.cpp:3177-3213 (``cam.distort_iters`` Newton steps on
    f(rd) = rd + k1 rd^3 + k2 rd^5 - ru). Applies the same visibility
    sentinel: results outside [0, W] x [0, H] become (0, 0).
    """
    xu = (pix_u[..., 0] - cam.cx) * cam.dx
    yu = (pix_u[..., 1] - cam.cy) * cam.dy
    ru = torch.sqrt(xu * xu + yu * yu)
    ru2 = ru * ru
    rd = ru / (1.0 + cam.k1 * ru2 + cam.k2 * ru2 * ru2)
    for _ in range(cam.distort_iters):
        rd2 = rd * rd
        f = rd + cam.k1 * (rd2 * rd) + cam.k2 * (rd2 * rd2 * rd) - ru
        fp = 1.0 + 3.0 * cam.k1 * rd * rd + 5.0 * cam.k2 * (rd2 * rd2)
        rd = rd - f / fp
    rd2 = rd * rd
    d = 1.0 + cam.k1 * rd2 + cam.k2 * rd2 * rd2
    d = torch.where(d == 0.0, torch.full_like(d, 1e-13), d)
    u = cam.cx + (xu / d) / cam.dx
    v = cam.cy + (yu / d) / cam.dy
    visible = (u >= 0) & (u <= cam.width) & (v >= 0) & (v <= cam.height)
    out = torch.stack([u, v], dim=-1)
    return torch.where(visible[..., None], out, torch.zeros_like(out))


def camera2image(cam: CameraConfig, hlr: torch.Tensor,
                 err: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Camera-frame point -> undistorted pixel (SLAM.cpp:3322-3349).

    ``hlr[..., :]`` = (X, Y, Z) in the camera frame. Applies the reference's
    axis pairing (u from Y via cy/f2, v from X via cx/f1), the additive
    measurement-noise term ``err`` (shape (..., 2), u then v), the 10-px
    interior margin, and the Z==0 guard — all collapsing to the (0,0)
    sentinel.
    """
    X, Y, Z = hlr[..., 0], hlr[..., 1], hlr[..., 2]
    safe_z = torch.where(Z == 0.0, torch.ones_like(Z), Z)
    u = cam.cy + cam.f2 * Y / safe_z
    v = cam.cx + cam.f1 * X / safe_z
    if err is not None:
        u = u + err[..., 0]
        v = v + err[..., 1]
    ok = ((Z != 0.0)
          & (u >= cam.margin) & (u <= cam.width - cam.margin)
          & (v >= cam.margin) & (v <= cam.height - cam.margin))
    out = torch.stack([u, v], dim=-1)
    return torch.where(ok[..., None], out, torch.zeros_like(out))


def image2camera(cam: CameraConfig, pix_u: torch.Tensor) -> torch.Tensor:
    """Undistorted pixel -> unit-Z camera ray (SLAM.cpp:3360-3372)."""
    X = (pix_u[..., 1] - cam.cx) / cam.f1
    Y = (pix_u[..., 0] - cam.cy) / cam.f2
    return torch.stack([X, Y, torch.ones_like(X)], dim=-1)


def project_smooth(cam: CameraConfig, hlr: torch.Tensor) -> torch.Tensor:
    """Sentinel-free differentiable projection for the BA backend.

    Same math as :func:`project` but without the visibility zeroing — the
    (0,0) sentinel is a step discontinuity whose derivative is zero, which
    would silently kill Gauss-Newton Jacobians. Validity is handled by the
    caller's observation mask instead.

    Differentiable by ``torch.func`` (``jacfwd`` under ``vmap``): no
    in-place write, no host read, ``torch.where`` for both guards, the
    Newton loop unrolled ``cam.distort_iters`` times.
    """
    X, Y, Z = hlr[..., 0], hlr[..., 1], hlr[..., 2]
    safe_z = torch.where(torch.abs(Z) < 1e-9, torch.full_like(Z, 1e-9), Z)
    u = cam.cy + cam.f2 * Y / safe_z
    v = cam.cx + cam.f1 * X / safe_z
    xu = (u - cam.cx) * cam.dx
    yu = (v - cam.cy) * cam.dy
    ru = torch.sqrt(xu * xu + yu * yu + 1e-18)
    ru2 = ru * ru
    rd = ru / (1.0 + cam.k1 * ru2 + cam.k2 * ru2 * ru2)
    for _ in range(cam.distort_iters):
        rd2 = rd * rd
        f = rd + cam.k1 * (rd2 * rd) + cam.k2 * (rd2 * rd2 * rd) - ru
        fp = 1.0 + 3.0 * cam.k1 * rd * rd + 5.0 * cam.k2 * (rd2 * rd2)
        rd = rd - f / fp
    rd2 = rd * rd
    d = 1.0 + cam.k1 * rd2 + cam.k2 * rd2 * rd2
    d = torch.where(d == 0.0, torch.full_like(d, 1e-13), d)
    return torch.stack([cam.cx + (xu / d) / cam.dx,
                        cam.cy + (yu / d) / cam.dy], dim=-1)


def project_smooth_jvp(cam: CameraConfig, hlr: torch.Tensor,
                       dhlr: torch.Tensor):
    """:func:`project_smooth` with forward-mode derivatives written out.

    ``dhlr`` (..., 3, K) holds K tangent directions of ``hlr`` (..., 3).
    Returns ``(pix (..., 2), dpix (..., 2, K))``: what
    ``torch.func.jvp`` of :func:`project_smooth` gives for each direction,
    the unrolled Newton iterations differentiated step by step, as a fixed
    sequence of elementwise ops on whole tensors. (``torch.func.jacfwd``
    under ``vmap`` computes the same numbers through some 5000 dispatched
    ops per call, hundreds of them scalar host-to-device copies.)
    """
    X, Y, Z = hlr[..., 0, None], hlr[..., 1, None], hlr[..., 2, None]
    dX, dY, dZ = dhlr[..., 0, :], dhlr[..., 1, :], dhlr[..., 2, :]
    tiny = torch.abs(Z) < 1e-9
    sz = torch.where(tiny, torch.full_like(Z, 1e-9), Z)
    dsz = torch.where(tiny, torch.zeros_like(dZ), dZ)
    u = cam.cy + cam.f2 * Y / sz
    v = cam.cx + cam.f1 * X / sz
    du = cam.f2 * (dY / sz - Y * dsz / (sz * sz))
    dv = cam.f1 * (dX / sz - X * dsz / (sz * sz))
    xu = (u - cam.cx) * cam.dx
    yu = (v - cam.cy) * cam.dy
    dxu = du * cam.dx
    dyu = dv * cam.dy
    ru = torch.sqrt(xu * xu + yu * yu + 1e-18)
    dru = (xu * dxu + yu * dyu) / ru
    ru2 = ru * ru
    den = 1.0 + cam.k1 * ru2 + cam.k2 * ru2 * ru2
    dden = (2.0 * cam.k1 * ru + 4.0 * cam.k2 * (ru2 * ru)) * dru
    rd = ru / den
    drd = dru / den - ru * dden / (den * den)
    for _ in range(cam.distort_iters):
        rd2 = rd * rd
        f = rd + cam.k1 * (rd2 * rd) + cam.k2 * (rd2 * rd2 * rd) - ru
        fp = 1.0 + 3.0 * cam.k1 * rd * rd + 5.0 * cam.k2 * (rd2 * rd2)
        df = fp * drd - dru
        dfp = (6.0 * cam.k1 * rd + 20.0 * cam.k2 * (rd2 * rd)) * drd
        drd = drd - (df / fp - f * dfp / (fp * fp))
        rd = rd - f / fp
    rd2 = rd * rd
    d = 1.0 + cam.k1 * rd2 + cam.k2 * rd2 * rd2
    dd = (2.0 * cam.k1 * rd + 4.0 * cam.k2 * (rd2 * rd)) * drd
    flat = d == 0.0
    d = torch.where(flat, torch.full_like(d, 1e-13), d)
    dd = torch.where(flat, torch.zeros_like(dd), dd)
    pix = torch.cat([cam.cx + (xu / d) / cam.dx,
                     cam.cy + (yu / d) / cam.dy], dim=-1)
    dpix = torch.stack([(dxu / d - xu * dd / (d * d)) / cam.dx,
                        (dyu / d - yu * dd / (d * d)) / cam.dy], dim=-2)
    return pix, dpix


def project(cam: CameraConfig, hlr: torch.Tensor,
            err: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Camera-frame point -> distorted pixel, with sentinel propagation.

    Chains camera2image + distort; a (0,0) from the margin test stays (0,0).
    """
    uvu = camera2image(cam, hlr, err)
    uvd = distort(cam, uvu)
    dead = torch.all(uvu == 0.0, dim=-1)
    return torch.where(dead[..., None], torch.zeros_like(uvd), uvd)
