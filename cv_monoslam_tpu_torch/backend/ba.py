"""Sliding-window bundle adjustment (SURVEY.md §7 step 5, bench config 4).

The reference has no backend — its only trajectory estimate is the filter,
and its only "loop closure" is the redirection splice (SLAM.cpp:948-1015,
1354-1428). This module is a square-root Gauss-Newton BA over a fixed
window of keyframes:

  * **Fixed shapes**: W keyframes x L landmark slots, observation mask for
    validity — one code path at any fill level.
  * **Batched residual/Jacobian**: every (keyframe, landmark) pair at once —
    reprojection through the reference camera model (yaw-only pose, ceiling
    camera, distortion included), differentiated in forward mode by hand
    (``geometry.camera.project_smooth_jvp``; ``project_smooth`` itself stays
    differentiable by ``torch.func``, which the tests hold it against).
  * **Schur complement over landmarks**: the landmark-block inverse is a
    batched 3x3 inverse; the reduced (3W, 3W) pose system is dense and tiny.
    The landmark axis is the axis a multi-device run shards:
    :func:`_obs_blocks` returns exactly the terms such a run would reduce.
  * **Odometry factors** between consecutive keyframes + a first-pose prior
    pin gauge and scale (monocular BA alone is scale-free).

Poses are planar (x, y, theta) with z = 0 — the reference's robot state
(SLAM.cpp:226-231 keeps z nominally zero). The solve is small dense algebra
(``torch.linalg.inv`` / ``solve`` / ``einsum``) on the problem's device, in
full FP32 for float32 inputs (nothing here enables TF32: Gauss-Newton
amplifies the factorization error of a reduced-precision product every
iteration).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..geometry import transforms as tf
from .pose_graph import _edge_jacobians


def project_planar(pose3: torch.Tensor, xyz: torch.Tensor,
                   cfg: SlamConfig) -> torch.Tensor:
    """Project world point through a planar (x, y, theta) camera pose;
    batched over leading dimensions of both arguments."""
    t = torch.stack([pose3[..., 0], pose3[..., 1],
                     torch.zeros_like(pose3[..., 0])], dim=-1)
    rcw = tf.yaw_matrix(pose3[..., 2]).transpose(-1, -2)
    hlr = (rcw @ (xyz - t)[..., None])[..., 0]
    return cam_mod.project_smooth(cfg.camera, hlr)


def _res_jac(poses, landmarks, obs, cfg: SlamConfig):
    """Batched (W, L) residuals + pose/landmark Jacobians:
    ``r (W, L, 2)``, ``Jp = dr/dpose (W, L, 2, 3)``,
    ``Jl = dr/dlandmark (W, L, 2, 3)``.

    Forward mode written out (the JAX package takes ``jax.jacfwd`` under two
    ``vmap``s): six tangent directions of the camera-frame point, three per
    pose component and three per landmark component, pushed through
    :func:`..geometry.camera.project_smooth_jvp`."""
    th = poses[:, None, 2]                                  # (W,1)
    c, s = torch.cos(th), torch.sin(th)
    dx = landmarks[None, :, 0] - poses[:, None, 0]          # (W,L)
    dy = landmarks[None, :, 1] - poses[:, None, 1]
    dz = landmarks[None, :, 2].expand_as(dx)
    hx = c * dx + s * dy
    hy = -s * dx + c * dy
    hlr = torch.stack([hx, hy, dz], dim=-1)                 # (W,L,3)
    z, o = torch.zeros_like(hx), torch.ones_like(hx)
    cc, ss = c.expand_as(hx), s.expand_as(hx)
    # d hlr / d (px, py, theta | lx, ly, lz): rows X, Y, Z of the point
    dhlr = torch.stack([
        torch.stack([-cc, -ss, hy, cc, ss, z], dim=-1),
        torch.stack([ss, -cc, -hx, -ss, cc, z], dim=-1),
        torch.stack([z, z, z, z, z, o], dim=-1)], dim=-2)   # (W,L,3,6)
    pix, dpix = cam_mod.project_smooth_jvp(cfg.camera, hlr, dhlr)
    return pix - obs, dpix[..., :3], dpix[..., 3:]


def _residuals(poses, landmarks, obs, cfg: SlamConfig):
    """(W, L, 2) reprojection residuals alone."""
    return project_planar(poses[:, None], landmarks[None], cfg) - obs


def _relpose(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Relative planar pose of p1 in p0's frame: (dx, dy, dtheta); batched
    over leading dimensions."""
    c, s = torch.cos(p0[..., 2]), torch.sin(p0[..., 2])
    dx = p1[..., 0] - p0[..., 0]
    dy = p1[..., 1] - p0[..., 1]
    return torch.stack([c * dx + s * dy,
                        -s * dx + c * dy,
                        tf.wrap_angle(p1[..., 2] - p0[..., 2])], dim=-1)


@dataclasses.dataclass(frozen=True)
class BAProblem:
    """One window. All tensors fixed-shape, on one device; masks encode
    validity."""

    poses: torch.Tensor      # (W, 3) initial keyframe poses (x, y, theta)
    landmarks: torch.Tensor  # (L, 3) initial world points
    obs: torch.Tensor        # (W, L, 2) observed pixels
    obs_mask: torch.Tensor   # (W, L) bool
    odo_rel: torch.Tensor    # (W-1, 3) measured relative poses
    kf_mask: torch.Tensor    # (W,) bool — filled keyframe slots
    lm_mask: torch.Tensor    # (L,) bool — filled landmark slots
    #: (W, 3) filter marginal anchors — the ORIGINAL filter pose estimate
    #: per keyframe (not the last refinement, so repeated window solves
    #: cannot compound drift). Zeros + zero weight = no prior.
    prior_poses: Optional[torch.Tensor] = None
    #: (W, 3) inverse variances of the anchors (0 disables per-component)
    prior_iw: Optional[torch.Tensor] = None


def _obs_blocks(poses, landmarks, obs, obs_mask, kf_mask, lm_mask,
                cfg: SlamConfig, pix_sigma: float, damping: float):
    """Landmark-indexed Hessian blocks for one GN iteration.

    This is the part that shards over the landmark axis: every return value
    is either pose-shaped (summed over local landmarks — a distributed
    caller all-reduces it) or landmark-sharded.

    Returns (U, Hred, bp_obs, Vinv, Wc, bl, cost_obs):
      U     (W,3,3)    sum_l Jp^T Jp                         [reduce]
      Hred  (W,W,3,3)  sum_l W_wl Vinv_l W_w'l^T (Schur)     [reduce]
      bp    (W,3)      -sum_l Jp^T r - sum_l W Vinv bl       [reduce]
      Vinv  (L,3,3)    damped landmark block inverses        [local]
      Wc    (W,L,3,3)  pose-landmark coupling                [local]
      bl    (L,3)      -Jl^T r                               [local]
      cost  ()         0.5 sum r^T W r                       [reduce]
    """
    dtype, dev = poses.dtype, poses.device
    # sanitize: unfilled landmark slots hold (0,0,0), which sits in the
    # camera plane (Z=0) and NaNs the distortion Newton solve; masked
    # entries must be zeroed with where (0 * NaN = NaN would leak through
    # a multiplicative mask)
    safe_lms = torch.where(
        lm_mask[:, None], landmarks,
        torch.tensor([0.0, 0.0, 3.0], dtype=dtype, device=dev))
    r, Jp, Jl = _res_jac(poses, safe_lms, obs, cfg)        # (W,L,2[,3])
    wmask = (obs_mask & kf_mask[:, None] & lm_mask[None, :]).to(dtype)
    on = wmask[..., None] > 0
    iw = wmask / (pix_sigma ** 2)
    Jp = torch.where(on[..., None], Jp, torch.zeros_like(Jp))
    Jl = torch.where(on[..., None], Jl, torch.zeros_like(Jl))
    r = torch.where(on, r, torch.zeros_like(r))

    # blocks:                          shard axis = l (landmarks)
    U = torch.einsum("wlki,wlkj,wl->wij", Jp, Jp, iw)      # (W,3,3)
    V = torch.einsum("wlki,wlkj,wl->lij", Jl, Jl, iw)      # (L,3,3)
    Wc = torch.einsum("wlki,wlkj,wl->wlij", Jp, Jl, iw)    # (W,L,3,3)
    bp = -torch.einsum("wlki,wlk,wl->wi", Jp, r, iw)       # (W,3)
    bl = -torch.einsum("wlki,wlk,wl->li", Jl, r, iw)       # (L,3)

    # landmark block inverse (damped; empty slots get identity)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    V = V + damping * eye3[None]
    V = torch.where(lm_mask[:, None, None], V, eye3[None])
    Vinv = torch.linalg.inv(V)                             # (L,3,3)

    # Schur reduction over landmarks (the distributed reduce term):
    #   H_ww' -= sum_l W_wl Vinv_l W_w'l^T ; b_p -= sum_l W_wl Vinv_l b_l
    WV = torch.einsum("wlij,ljk->wlik", Wc, Vinv)          # (W,L,3,3)
    Hred = torch.einsum("wlik,vlmk->wvim", WV, Wc)         # (W,W,3,3)
    bp = bp - torch.einsum("wlik,lk->wi", WV, bl)
    cost = 0.5 * torch.sum(r * r * iw[..., None])
    return U, Hred, bp, Vinv, Wc, bl, cost


def _pose_system(poses, U, Hred, bp_obs, prob: BAProblem, cfg: SlamConfig,
                 odo_sigma: torch.Tensor, damping: float,
                 prior_pose: torch.Tensor):
    """Assemble + solve the reduced pose system (replicated everywhere)."""
    W = prob.kf_mask.shape[0]
    dtype, dev = poses.dtype, poses.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    ar = torch.arange(W, device=dev)
    lo, hi = ar[:-1], ar[1:]

    H = -Hred
    H[ar, ar] += U + damping * eye3[None]
    bp = bp_obs.clone()

    # odometry relative-pose factors between consecutive filled keyframes
    p0, p1 = poses[:-1], poses[1:]
    res_o = _relpose(p0, p1) - prob.odo_rel
    res_o = torch.cat([res_o[:, :2], tf.wrap_angle(res_o[:, 2:])], dim=1)
    J0, J1 = _edge_jacobians(p0, p1)                        # (W-1,3,3)
    on = (prob.kf_mask[:-1] & prob.kf_mask[1:]).to(dtype)
    iw_o = on[:, None] / (odo_sigma ** 2)[None, :]          # (W-1,3)

    H[lo, lo] += torch.einsum("eki,ek,ekj->eij", J0, iw_o, J0)
    H[hi, hi] += torch.einsum("eki,ek,ekj->eij", J1, iw_o, J1)
    H[lo, hi] += torch.einsum("eki,ek,ekj->eij", J0, iw_o, J1)
    H[hi, lo] += torch.einsum("eki,ek,ekj->eij", J1, iw_o, J0)
    bp[:-1] += -torch.einsum("eki,ek,ek->ei", J0, iw_o, res_o)
    bp[1:] += -torch.einsum("eki,ek,ek->ei", J1, iw_o, res_o)

    # gauge prior on the first pose
    H[0, 0] += torch.diag(prior_pose)
    bp[0] += -prior_pose * (poses[0] - prob.poses[0])
    # filter-marginal anchors: every keyframe is softly tied to the pose
    # the FILTER estimated when the keyframe was created, weighted by the
    # (inflated) filter pose covariance. BA then only moves poses where
    # reprojection/odometry evidence genuinely disagrees — without this,
    # repeated window refinements walk off in the weakly-observable
    # directions of the ceiling-camera geometry and degrade a good
    # trajectory instead of improving a drifting one.
    if prob.prior_poses is not None and prob.prior_iw is not None:
        iw_a = torch.where(prob.kf_mask[:, None], prob.prior_iw,
                           torch.zeros_like(prob.prior_iw))
        H[ar, ar] += torch.diag_embed(iw_a)
        res_a = poses - prob.prior_poses
        res_a = torch.cat([res_a[:, :2], tf.wrap_angle(res_a[:, 2:])], dim=1)
        bp = bp + (-iw_a * res_a)
    # empty keyframe slots: identity rows
    kf_off = ~prob.kf_mask
    H = torch.where((kf_off[:, None] | kf_off[None, :])[..., None, None],
                    torch.zeros_like(H), H)
    H[ar, ar] += kf_off[:, None, None].to(dtype) * eye3[None]
    bp = torch.where(kf_off[:, None], torch.zeros_like(bp), bp)

    Hd = H.permute(0, 2, 1, 3).reshape(3 * W, 3 * W)
    dxp = torch.linalg.solve(Hd, bp.reshape(-1)).reshape(W, 3)
    dxp = torch.where(prob.kf_mask[:, None], dxp, torch.zeros_like(dxp))
    cost_odo = 0.5 * torch.sum(res_o * res_o * iw_o)
    return dxp, cost_odo


def back_substitute(dxp, Vinv, Wc, bl, lm_mask):
    """Landmark updates from the pose solution (local to each shard):
    dxl = Vinv (bl - sum_w W_wl^T dxp_w)."""
    dxl = torch.einsum("lij,lj->li",
                       Vinv, bl - torch.einsum("wlki,wk->li", Wc, dxp))
    return torch.where(lm_mask[:, None], dxl, torch.zeros_like(dxl))


def _gn_step(poses, landmarks, prob: BAProblem, cfg: SlamConfig,
             pix_sigma: float, odo_sigma: torch.Tensor, damping: float,
             prior_pose: torch.Tensor):
    """One damped Gauss-Newton iteration with landmark-Schur elimination."""
    U, Hred, bp, Vinv, Wc, bl, cost_obs = _obs_blocks(
        poses, landmarks, prob.obs, prob.obs_mask, prob.kf_mask,
        prob.lm_mask, cfg, pix_sigma, damping)
    dxp, cost_odo = _pose_system(poses, U, Hred, bp, prob, cfg,
                                 odo_sigma, damping, prior_pose)
    dxl = back_substitute(dxp, Vinv, Wc, bl, prob.lm_mask)
    return poses + dxp, landmarks + dxl, cost_obs + cost_odo


def ba_solve(prob: BAProblem, cfg: SlamConfig, *, iters: Optional[int] = None,
             pix_sigma: Optional[float] = None,
             odo_sigma: Tuple[float, float, float] = (0.02, 0.02, 0.01),
             damping: float = 1e-4,
             prior_pose: Tuple[float, float, float] = (1e6, 1e6, 1e6)):
    """Gauss-Newton sliding-window BA. Returns (poses, landmarks, costs).

    A Python loop of ``iters`` iterations; no value is read on the host."""
    iters = cfg.ba_iters if iters is None else iters
    pix_sigma = cfg.sigma_measure if pix_sigma is None else pix_sigma
    dtype, dev = prob.poses.dtype, prob.poses.device
    odo_s = torch.tensor(odo_sigma, dtype=dtype, device=dev)
    prior = torch.tensor(prior_pose, dtype=dtype, device=dev)

    poses, landmarks = prob.poses, prob.landmarks
    costs = []
    for _ in range(iters):
        poses, landmarks, cost = _gn_step(
            poses, landmarks, prob, cfg, pix_sigma, odo_s, damping, prior)
        costs.append(cost)
    costs = (torch.stack(costs) if costs
             else torch.zeros(0, dtype=dtype, device=dev))
    return poses, landmarks, costs


def reprojection_rmse(poses, landmarks, prob: BAProblem,
                      cfg: SlamConfig) -> torch.Tensor:
    safe_lms = torch.where(
        prob.lm_mask[:, None], landmarks,
        torch.tensor([0.0, 0.0, 3.0], dtype=poses.dtype,
                     device=poses.device))
    r = _residuals(poses, safe_lms, prob.obs, cfg)
    m = (prob.obs_mask & prob.kf_mask[:, None]
         & prob.lm_mask[None, :])
    r = torch.where(m[..., None], r, torch.zeros_like(r))
    md = m.to(poses.dtype)
    num = torch.sum(torch.sum(r * r, dim=-1) * md)
    return torch.sqrt(num / torch.clamp(torch.sum(md), min=1.0))
