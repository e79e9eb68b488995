"""Active-search NCC matching — batched over landmarks (torch).

Replaces the reference's serial per-landmark loops:
  * patch warp (SLAM.cpp:1804-1906): plane-induced ceiling homography,
    linearized at each feature into a 2x2 affine map, applied as one batched
    bilinear resample over all landmarks;
  * exhaustive NCC search (SLAM.cpp:1915-2009, 3141-3166): all landmarks x
    all (2*10+1)^2 window offsets scored at once. The matcher computes the
    warp, the region gather and the NCC in one call: on the kernel route
    one launch (``warp_ncc_score_map``), on "xla" its plain version;
    ``warp_patches`` and ``ncc_scores`` keep the two steps apart (the
    ``warp_bilinear`` and ``ncc_score_map`` kernels);
  * chi^2 ellipse gate err^T (Si^T Si)^-1 err < chi2inv(0.95, 6)
    (SLAM.cpp:1975-1977) and the per-landmark window half-sizes
    min(10, max(8, ceil(2*Si_00))) (SLAM.cpp:1952-1955) become masks;
  * acceptance: max masked NCC > 0.8 (SLAM.cpp:184, 1989), with optional
    parabolic sub-pixel refinement.
"""

from __future__ import annotations

import torch

from ..config import SlamConfig
from ..filter.state import FilterState, replace
from ..geometry import camera as cam_mod
from ..geometry import transforms as tf
from ..ops import control
from .. import forcing
from ..ops.vision import (gather_regions, ncc_score_map, ncc_score_map_ref,
                          warp_bilinear, warp_bilinear_ref,
                          warp_ncc_score_map, warp_ncc_score_map_ref,
                          warp_sample_coords)


def _use_kernel(cfg: SlamConfig) -> bool:
    """``vision_backend``: "pallas" and "auto" go through the kernel
    wrappers (the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors); "xla" calls the plain versions directly."""
    if cfg.vision_backend in ("pallas", "auto"):
        return True
    if cfg.vision_backend == "xla":
        return False
    raise ValueError(f"unknown vision_backend {cfg.vision_backend!r}")


def _inv2x2(a: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a batch of 2x2 matrices (no device sync, no
    error check: a singular J10 gives inf/nan like an unchecked inverse)."""
    a00, a01 = a[:, 0, 0], a[:, 0, 1]
    a10, a11 = a[:, 1, 0], a[:, 1, 1]
    det = a00 * a11 - a01 * a10
    return torch.stack([torch.stack([a11, -a01], dim=-1),
                        torch.stack([-a10, a00], dim=-1)], dim=-2) \
        / det[:, None, None]


def warp_matrices(state: FilterState, cfg: SlamConfig) -> torch.Tensor:
    """Batched 2x2 affine warps d(init pix)/d(current pix), (M, 2, 2).

    Ceiling-plane homography between each landmark's init view and the
    current view, linearized at the landmark (cf SLAM.cpp:1804-1860).
    Operates in (v, u, 1) pixel vectors — see geometry.camera for the
    reference's axis pairing.
    """
    cam = cfg.camera
    lm = state.lm
    dtype, dev = state.x.dtype, state.x.device
    theta1 = state.x[-1]
    c1 = state.x[-4:-1]
    r1 = tf.yaw_matrix(theta1)                       # (3,3)
    r0 = tf.yaw_matrix(lm.init_theta)                # (M,3,3)
    c0 = lm.init_trans                               # (M,3)
    d0 = lm.xyz[:, 2] - c0[:, 2]
    d0 = torch.where(torch.abs(d0) < 1e-6, torch.full_like(d0, 1e-6), d0)
    ez = control.constant((0.0, 0.0, 1.0), dtype, dev)
    n0 = torch.einsum("mji,j->mi", r0, ez)           # r0^T ez
    R10 = torch.einsum("ji,mjk->mik", r1, r0)        # r1^T r0
    t10 = torch.einsum("ji,mj->mi", r1, c0 - c1)
    K = control.constant(((cam.f1, 0.0, cam.cx),
                          (0.0, cam.f2, cam.cy),
                          (0.0, 0.0, 1.0)), dtype, dev)
    Kinv = control.constant(((1.0 / cam.f1, 0.0, -cam.cx / cam.f1),
                             (0.0, 1.0 / cam.f2, -cam.cy / cam.f2),
                             (0.0, 0.0, 1.0)), dtype, dev)
    H = torch.einsum(
        "ij,mjk,kl->mil", K,
        R10 + t10[:, :, None] * n0[:, None, :] / d0[:, None, None],
        Kinv)                                        # (M,3,3) cam0 -> cam1
    uv0 = cam_mod.undistort(cam, lm.init_pixel)      # (M,2) (u,v)
    p0 = torch.stack([uv0[:, 1], uv0[:, 0], torch.ones_like(uv0[:, 0])],
                     dim=-1)
    q = torch.einsum("mij,mj->mi", H, p0)
    qz = torch.where(q[:, 2] == 0, torch.full_like(q[:, 2], 1e-13), q[:, 2])
    J10 = (H[:, :2, :2] * qz[:, None, None]
           - q[:, :2, None] * H[:, 2:3, :2]) / (qz ** 2)[:, None, None]
    return _inv2x2(J10)                              # (M,2,2) (dv,du) basis


def warp_patches(state: FilterState, cfg: SlamConfig) -> torch.Tensor:
    """Warp every landmark's init patch to the current view: (M, Pm, Pm)."""
    su, sv = warp_coords(state, cfg)
    patches = state.lm.init_patch.to(state.x.dtype)
    if _use_kernel(cfg):
        return warp_bilinear(patches, su, sv)
    return warp_bilinear_ref(patches, su, sv)


def warp_coords(state: FilterState, cfg: SlamConfig):
    """Sample positions (su, sv), each (M, Pm, Pm), inside the (Pi, Pi) init
    patch, centred at (hp_init, hp_init)."""
    return warp_sample_coords(warp_matrices(state, cfg), cfg.hp_init,
                              cfg.hp_match)


def region_origins(centers: torch.Tensor, H: int, W: int,
                   cfg: SlamConfig) -> torch.Tensor:
    """(M, 2) search-region origins (u, v) for window centres ``centers``,
    clamped so that each (Rg, Rg) region lies inside the (H, W) frame;
    offset (dx, dy) of the region is match centre base + (dx, dy) +
    hp_match."""
    hp_m, hs = cfg.hp_match, cfg.hp_init        # max half-window = hp_init
    Rg = 2 * hs + 1 + 2 * hp_m                  # region side, W1 + Pm - 1
    base = centers - (hs + hp_m)
    hi = control.constant((W - Rg, H - Rg), base.dtype, base.device)
    return torch.minimum(torch.clamp(base, min=0), hi)


def ncc_scores(image: torch.Tensor, centers: torch.Tensor,
               patches: torch.Tensor, cfg: SlamConfig):
    """Zero-mean NCC of every window offset for every landmark.

    image: (H, W) float; centers: (M, 2) int (u, v) window centres;
    patches: (M, Pm, Pm) warped templates.
    Returns (scores (M, W1, W1), base (M, 2) region origin (u, v)) where
    W1 = 2*hp_init + 1 offsets and scores[m, dy, dx] corresponds to match
    centre (base + (dx, dy) + hp_match).
    """
    Pm = 2 * cfg.hp_match + 1
    W1 = 2 * cfg.hp_init + 1
    base = region_origins(centers, *image.shape, cfg)
    regions = gather_regions(image, base, W1 + Pm - 1).to(patches.dtype)
    if _use_kernel(cfg):
        return ncc_score_map(regions, patches, pm=Pm, w1=W1), base
    return ncc_score_map_ref(regions, patches, pm=Pm, w1=W1), base


def data_association(state: FilterState, image: torch.Tensor,
                     cfg: SlamConfig) -> FilterState:
    """Warp + gated NCC search + acceptance for all landmarks at once."""
    return accept_matches(state, *association_rows(state, image, cfg), cfg)


def association_rows(state: FilterState, image: torch.Tensor,
                     cfg: SlamConfig):
    """The per-landmark part of :func:`data_association`, for every slot of
    ``state.lm`` (a landmark-sharded step hands each rank a table of its
    own slots): the warp and the NCC search (on the kernel route one
    launch of the fused kernel), the gates and the NCC peak. Returns
    (accepted before the consensus test, match pixels, warped patches)."""
    dtype = state.x.dtype
    dev = state.x.device
    lm = state.lm
    hp_m, hs = cfg.hp_match, cfg.hp_init
    W1 = 2 * hs + 1
    H, W = image.shape

    centers_i = lm.pred.to(torch.int32)                       # trunc, as ref
    base = region_origins(centers_i, H, W, cfg)
    fn = warp_ncc_score_map if _use_kernel(cfg) else warp_ncc_score_map_ref
    scores, patches = fn(image.to(dtype), base, warp_matrices(state, cfg),
                         lm.init_patch.to(dtype), hp_init=hs, hp_match=hp_m)

    # offset grid -> absolute window centre pixels
    offs = torch.arange(W1, device=dev, dtype=torch.int32)
    ov, ou = torch.meshgrid(offs, offs, indexing="ij")        # (W1,W1)
    au = base[:, 0, None, None] + ou[None] + hp_m             # (M,W1,W1)
    av = base[:, 1, None, None] + ov[None] + hp_m

    # per-landmark half-window (SLAM.cpp:1952-1955)
    half_x = torch.ceil(2.0 * torch.abs(lm.si[:, 0, 0])).to(torch.int32)
    half_y = torch.ceil(2.0 * torch.abs(lm.si[:, 1, 1])).to(torch.int32)
    half_x = torch.clamp(half_x, hp_m, hs)
    half_y = torch.clamp(half_y, hp_m, hs)

    eu = au.to(dtype) - lm.pred[:, 0, None, None]
    ev = av.to(dtype) - lm.pred[:, 1, None, None]
    pi = torch.einsum("mki,mkj->mij", lm.si, lm.si)           # (M,2,2)
    det = pi[:, 0, 0] * pi[:, 1, 1] - pi[:, 0, 1] * pi[:, 1, 0]
    det_ok = torch.abs(det) > 1e-12
    safe_det = torch.where(det_ok, det, torch.ones_like(det))
    inv00 = pi[:, 1, 1] / safe_det
    inv11 = pi[:, 0, 0] / safe_det
    inv01 = -pi[:, 0, 1] / safe_det
    maha = (inv00[:, None, None] * eu * eu
            + 2 * inv01[:, None, None] * eu * ev
            + inv11[:, None, None] * ev * ev)

    in_win = ((torch.abs(au - centers_i[:, 0, None, None])
               <= half_x[:, None, None])
              & (torch.abs(av - centers_i[:, 1, None, None])
                 <= half_y[:, None, None]))
    in_img = ((au >= hp_m) & (au <= W - hp_m - 1)
              & (av >= hp_m) & (av <= H - hp_m - 1))
    ok = (lm.visible & det_ok)[:, None, None] & in_win & in_img \
        & (maha < cfg.chi2_gate)
    masked = torch.where(ok, scores, torch.full_like(scores, -1.0))

    flat = masked.reshape(masked.shape[0], -1)
    best_idx = torch.argmax(flat, dim=1)
    best = torch.gather(flat, 1, best_idx[:, None])[:, 0]
    by = best_idx // W1
    bx = best_idx % W1
    accepted = lm.visible & det_ok & (best > cfg.threshold_match_patch)

    mu = (base[:, 0] + bx + hp_m).to(dtype)
    mv = (base[:, 1] + by + hp_m).to(dtype)
    if cfg.subpixel_match:
        mu = mu + _parabolic(masked, by, bx, axis=1)
        mv = mv + _parabolic(masked, by, bx, axis=0)

    accepted = forcing.association(accepted, best, cfg)
    mu, mv = forcing.offset(accepted, mu, mv, masked, base, by, bx, best,
                            _parabolic, cfg)
    return accepted, torch.stack([mu, mv], dim=1), patches


def accept_matches(state: FilterState, accepted: torch.Tensor,
                   match_px: torch.Tensor, patches: torch.Tensor,
                   cfg: SlamConfig) -> FilterState:
    """The part of :func:`data_association` that spans landmarks: the
    1-point RANSAC consensus, then the matches written into the table."""
    lm = state.lm
    if cfg.use_ransac:
        accepted = one_point_ransac(accepted, match_px, lm.pred, cfg)
    lm_new = replace(
        lm,
        matched=accepted,
        match_px=torch.where(accepted[:, None], match_px, lm.match_px),
        match_patch=torch.where(accepted[:, None, None],
                                patches.to(torch.float32), lm.match_patch),
        n_match=lm.n_match + accepted.to(torch.int32),
    )
    return replace(state, lm=lm_new)


def one_point_ransac(accepted: torch.Tensor, match_px: torch.Tensor,
                     pred: torch.Tensor, cfg: SlamConfig) -> torch.Tensor:
    """1-point RANSAC over innovation consensus (SLAM.cpp:2097-2103's
    commented-out branch). Each accepted match proposes its own innovation;
    inliers agree within ``threshold_ransac`` pixels; the largest consensus
    wins. With <= 2 accepted matches all are kept."""
    nu = match_px - pred                                   # (M, 2)
    d2 = torch.sum((nu[:, None, :] - nu[None, :, :]) ** 2, dim=-1)
    thr2 = cfg.threshold_ransac ** 2
    agree = (d2 < thr2) & accepted[None, :] & accepted[:, None]
    votes = torch.sum(agree, dim=1)                        # (M,)
    best = torch.argmax(torch.where(accepted, votes,
                                    torch.full_like(votes, -1)))
    inlier = agree[best]
    n_acc = torch.sum(accepted)
    return torch.where(n_acc > 2, accepted & inlier, accepted)


def _parabolic(scores: torch.Tensor, by: torch.Tensor, bx: torch.Tensor,
               axis: int) -> torch.Tensor:
    """Batched 1-D parabolic sub-pixel offset around (by, bx)."""
    W1 = scores.shape[-1]
    m = torch.arange(scores.shape[0], device=scores.device)
    neg = torch.full_like(scores[:, 0, 0], -1.0)
    s0 = scores[m, by, bx]
    if axis == 1:   # along x
        xm = torch.clamp(bx - 1, 0, W1 - 1)
        xp = torch.clamp(bx + 1, 0, W1 - 1)
        sm = torch.where(bx > 0, scores[m, by, xm], neg)
        sp = torch.where(bx < W1 - 1, scores[m, by, xp], neg)
    else:
        ym = torch.clamp(by - 1, 0, W1 - 1)
        yp = torch.clamp(by + 1, 0, W1 - 1)
        sm = torch.where(by > 0, scores[m, ym, bx], neg)
        sp = torch.where(by < W1 - 1, scores[m, yp, bx], neg)
    usable = (sm > -1.0) & (sp > -1.0)
    denom = sm - 2 * s0 + sp
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    off = torch.where(denom < -1e-12, 0.5 * (sm - sp) / safe,
                      torch.zeros_like(denom))
    return torch.where(usable, torch.clamp(off, -0.5, 0.5),
                       torch.zeros_like(off))
