"""SRUKF measurement prediction — batched over sigma points x slots.

Reference semantics (SLAM.cpp:1604-1795): push every propagated sigma point
through state->world->camera->image->distort for EVERY landmark (reusing the
motion-propagated augmented sigma set), weighted-mean the pixels, mark
landmarks visible when the mean pixel is non-sentinel, and form each
feature's 2x2 sqrt innovation from the sqrt(wi)-scaled pixel deviations.
One (M, n_sigma) broadcast replaces the reference's per-landmark per-point
double loop; the 2x2 QR per feature (SLAM.cpp:1775-1795) becomes a
closed-form 2x2 Cholesky of the Gram matrix.
"""

from __future__ import annotations

import torch

from ..config import SlamConfig
from ..frontend.matching import _use_kernel
from ..geometry import camera as cam_mod
from ..geometry import transforms as tf
from ..ops import vision
from .sigma import ut_weights
from .state import FilterState, PredictCache, replace


def chol2x2_upper(g: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Batched upper-triangular S with S^T S = G for PSD 2x2 G (..., 2, 2)."""
    g00 = torch.clamp(g[..., 0, 0], min=eps)
    a = torch.sqrt(g00)
    safe_a = torch.where(a == 0, torch.ones_like(a), a)
    b = g[..., 0, 1] / safe_a
    c = torch.sqrt(torch.clamp(g[..., 1, 1] - b * b, min=eps))
    z = torch.zeros_like(a)
    return torch.stack([
        torch.stack([a, b], dim=-1),
        torch.stack([z, c], dim=-1),
    ], dim=-2)


def project_all(sigma: torch.Tensor, cfg: SlamConfig, lo: int = 0,
                hi: int | None = None) -> torch.Tensor:
    """Project every slot (or the slots ``[lo, hi)``) through every sigma
    point.

    sigma: (Na, n_sigma) augmented motion-propagated points.
    Returns pixels (M, 2, n_sigma) with the (0, 0) invisible sentinel.
    """
    hi = cfg.max_landmarks if hi is None else hi
    M = hi - lo
    D = cfg.state_dim
    feats = sigma[6 * lo:6 * hi].reshape(M, 6, -1).permute(0, 2, 1)  # M,ns,6
    pos = sigma[D - 4: D - 1].T                                  # (ns, 3)
    theta = sigma[D - 1]                                         # (ns,)
    err = sigma[D + 3: D + 5].T                                  # (ns, 2)
    rcw = tf.yaw_matrix(theta).transpose(-1, -2)                 # (ns, 3, 3)
    hlw = tf.state_to_world(feats, pos[None, :, :])              # (M, ns, 3)
    hlr = torch.einsum("sij,msj->msi", rcw, hlw)
    pix = cam_mod.project(cfg.camera, hlr, err[None, :, :])      # (M, ns, 2)
    return pix.permute(0, 2, 1)                                  # (M, 2, ns)


def _batched_chol_lower(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of each matrix of a batch; a matrix that fails comes
    back all zero (JAX returns NaN for that matrix only and the caller zeroes
    non-finite entries; ``cholesky_ex`` reports the failure per matrix)."""
    L, info = torch.linalg.cholesky_ex(0.5 * (a + a.transpose(-1, -2)))
    ok = (info == 0)[:, None, None] & torch.isfinite(L)
    return torch.where(ok, L, torch.zeros_like(L))


def measurement_predict_reduced(state: FilterState, cache: PredictCache,
                                cfg: SlamConfig):
    """Per-landmark reduced-subspace UT (sigma_mode="implicit").
    Returns (new_state, cache with pred/h_lin filled)."""
    return apply_prediction(state, cache,
                            _reduced_rows(state, cache, cfg, 0,
                                          cfg.max_landmarks))


def _reduced_rows(state: FilterState, cache: PredictCache, cfg: SlamConfig,
                  lo: int, hi: int) -> dict:
    """:func:`measurement_predict_reduced`'s per-landmark outputs for the
    slots ``[lo, hi)``.

    Each landmark's measurement depends on EXACTLY 10 state dims: its own
    6-dim inverse-depth block plus the robot pose (x, y, z, theta). Each
    landmark gets a 21-point UT of its 10-dim marginal instead of the
    2(6M+5)+1 points of the full-state UT, agreeing with it to second
    order.

    Also emits the UT-implied linearization H_m (2 x 10) per landmark
    (cross-covariance against the subspace, solved against the subspace
    covariance) — the update rebuilds the full-state innovation structure
    from it via Grams of S.
    """
    dtype = state.x.dtype
    dev = state.x.device
    D = cfg.state_dim
    M = hi - lo

    # subspace covariance of z_m = [feat6_m, robot4]
    if cache.g_pred is not None:
        # blocks gathered straight from the motion-predicted covariance
        # Gram (state.S is stale here by design)
        G = cache.g_pred
        idx6 = (6 * torch.arange(lo, hi, device=dev)[:, None]
                + torch.arange(6, device=dev)[None, :])
        FF = G[idx6[:, :, None], idx6[:, None, :]]         # (M, 6, 6)
        FR = G[6 * lo:6 * hi, D - 4:].reshape(M, 6, 4)     # (M, 6, 4)
        RR = G[D - 4:, D - 4:]
    else:
        S = state.S
        S_feat = S[:, 6 * lo:6 * hi].reshape(D, M, 6)
        S_rob = S[:, D - 4:]
        FF = torch.einsum("dmi,dmj->mij", S_feat, S_feat)
        FR = torch.einsum("dmi,dj->mij", S_feat, S_rob)
        RR = S_rob.T @ S_rob
    cov = torch.cat([
        torch.cat([FF, FR], dim=2),
        torch.cat([FR.transpose(1, 2), RR.expand(M, 4, 4)], dim=2),
    ], dim=1)                                              # (M, 10, 10)
    eye10 = torch.eye(10, dtype=dtype, device=dev)
    scale = torch.clamp(torch.einsum("mii->m", cov) / 10.0, min=1e-12)
    L = _batched_chol_lower(cov + (1e-7 * scale)[:, None, None] * eye10)

    w_r = ut_weights(10, cfg)
    mu_z = torch.cat([state.x[6 * lo:6 * hi].reshape(M, 6),
                      state.x[D - 4:].expand(M, 4)], dim=1)  # (M, 10)
    offs = w_r.gamma * L.transpose(1, 2)                   # (M, 10pt, 10)
    c0 = mu_z[:, None, :]
    pts = torch.cat([c0, c0 + offs, c0 - offs], dim=1)     # (M, 21, 10)

    feats = pts[..., :6]
    pos = pts[..., 6:9]
    theta = pts[..., 9]
    rcw = tf.yaw_matrix(theta).transpose(-1, -2)           # (M, 21, 3, 3)
    hlw = tf.state_to_world(feats, pos)                    # (M, 21, 3)
    hlr = torch.einsum("msij,msj->msi", rcw, hlw)
    pix = cam_mod.project(cfg.camera, hlr)                 # (M, 21, 2)
    # sentinel guard: sigma points whose projection leaves the image get
    # the CENTER projection (zero deviation) instead of (0,0). A border
    # landmark with live sentinel points otherwise produces a garbage
    # linearization H with ~1e4-scale entries, and the float32 joint
    # factorization then loses PSD by O(1)
    live = torch.any(pix != 0.0, dim=-1, keepdim=True)     # (M, 21, 1)
    pix = torch.where(live, pix, pix[:, :1])

    mean = torch.einsum("msi,s->mi", pix, w_r.mean_weights(dtype, dev))
    lm = state.lm
    visible = lm.active[lo:hi] & (mean[:, 0] != 0) & (mean[:, 1] != 0)

    dz = w_r.wi_sr * (pts[:, 1:] - pts[:, :1])             # (M, 20, 10)
    dh = w_r.wi_sr * (pix[:, 1:] - pix[:, :1])             # (M, 20, 2)
    gram_r = torch.einsum("msi,msj->mij", dh, dh)
    # rescale to the FULL-state UT's deviation normalization so Si (which
    # gates the chi^2 ellipse and sizes the search window) matches the
    # full path's scale across weight schemes
    w_full = ut_weights(D + 5, cfg)
    c_ratio = (2.0 * (w_full.wi_sr * w_full.gamma) ** 2
               / (2.0 * (w_r.wi_sr * w_r.gamma) ** 2))
    gram_geo = c_ratio * gram_r + (cfg.sigma_measure ** 2) * torch.eye(
        2, dtype=dtype, device=dev)
    si = chol2x2_upper(gram_geo)

    # implied linearization: H = (Szz^-1 Pzy)^T, batched 10x10 solves
    szz = torch.einsum("msi,msj->mij", dz, dz)
    pzy = torch.einsum("msi,msk->mik", dz, dh)
    jit_i = 1e-9 * torch.einsum("mii->m", szz) / 10.0 + 1e-20
    sol, _ = torch.linalg.solve_ex(szz + jit_i[:, None, None] * eye10, pzy)
    h_lin = sol.transpose(1, 2)
    h_lin = torch.where(torch.isfinite(h_lin), h_lin,
                        torch.zeros_like(h_lin))           # (M, 2, 10)

    return dict(visible=visible,
                pred=torch.where(visible[:, None], mean, lm.pred[lo:hi]),
                si=torch.where(visible[:, None, None], si, lm.si[lo:hi]),
                h_lin=h_lin)


def apply_prediction(state: FilterState, cache: PredictCache,
                     rows: dict):
    """Write per-landmark prediction outputs (``visible``, merged ``pred``
    and ``si``, and ``sigma_pix`` or ``h_lin``) for every slot into the
    landmark table and the cache."""
    lm = state.lm
    visible = rows["visible"]
    lm_new = replace(
        lm,
        visible=visible,
        matched=torch.zeros_like(lm.matched),
        n_predict=lm.n_predict + visible.to(torch.int32),
        pred=rows["pred"],
        si=rows["si"],
    )
    extra = {k: rows[k] for k in ("sigma_pix", "h_lin") if k in rows}
    return (
        replace(state, lm=lm_new),
        replace(cache, pred=rows["pred"], **extra),
    )


def prediction_rows(state: FilterState, cache: PredictCache,
                    cfg: SlamConfig, lo: int, hi: int) -> dict:
    """The per-landmark outputs of :func:`measurement_predict` for the slots
    ``[lo, hi)`` only (for :func:`apply_prediction`): the part a
    landmark-sharded step splits across ranks."""
    if cfg.sigma_mode == "implicit":
        return _reduced_rows(state, cache, cfg, lo, hi)
    return _full_rows(state, cache, cfg, lo, hi)


def measurement_predict(state: FilterState, cache: PredictCache,
                        cfg: SlamConfig):
    """Returns (new_state, cache with sigma_pix/pred filled)."""
    if cfg.sigma_mode == "implicit":
        return measurement_predict_reduced(state, cache, cfg)
    return apply_prediction(state, cache,
                            _full_rows(state, cache, cfg, 0,
                                       cfg.max_landmarks))


def _full_rows(state: FilterState, cache: PredictCache, cfg: SlamConfig,
               lo: int, hi: int) -> dict:
    """:func:`full_rows_ref`'s rows of the slots ``[lo, hi)``: on CUDA
    tensors the projection and the tail are one kernel launch each
    (``ops.vision.measure_project``, ``ops.vision.measure_merge``) around
    the plain version's own two reductions (:func:`_pixel_moments`), which
    the benchmark's reference shares; on CPU tensors, and with
    ``vision_backend="xla"``, the plain version itself."""
    if not _use_kernel(cfg) or cache.sigma.device.type == "cpu":
        return full_rows_ref(state, cache, cfg, lo, hi)
    lm = state.lm
    pix = vision.measure_project(cache.sigma, lo=lo, m=hi - lo,
                                 state_dim=cfg.state_dim, cam=cfg.camera)
    mean, gram = _pixel_moments(pix, cfg)
    visible, pred, si = vision.measure_merge(
        mean, gram, lm.active[lo:hi], lm.pred[lo:hi], lm.si[lo:hi],
        sigma_measure=cfg.sigma_measure)
    return dict(visible=visible, pred=pred, si=si, sigma_pix=pix)


def _pixel_moments(pix: torch.Tensor, cfg: SlamConfig):
    """The weighted mean (M, 2) of the (M, 2, ns) pixels and the Gram
    (M, 2, 2) of their sqrt(wi)-scaled deviations from the centre point."""
    w = ut_weights(cfg.state_dim + 5, cfg)
    mean = pix @ w.mean_weights(pix.dtype, pix.device)  # (M, 2)
    dev_pix = w.wi_sr * (pix[:, :, 1:] - pix[:, :, :1])  # (M, 2, 2Na)
    return mean, torch.einsum("mis,mjs->mij", dev_pix, dev_pix)


def full_rows_ref(state: FilterState, cache: PredictCache, cfg: SlamConfig,
                  lo: int, hi: int) -> dict:
    """Plain version of the full-sigma rows of the slots ``[lo, hi)``: every
    slot projected through every sigma point (:func:`project_all`), the
    weighted mean and the deviations' Gram, visibility, the 2x2 sqrt
    innovation and the merges with the old rows, one torch operation at a
    time."""
    dtype = state.x.dtype
    dev = state.x.device
    pix = project_all(cache.sigma, cfg, lo, hi)         # (M, 2, ns)
    mean, gram = _pixel_moments(pix, cfg)

    lm = state.lm
    visible = lm.active[lo:hi] & (mean[:, 0] != 0) & (mean[:, 1] != 0)

    # independent per-landmark measurement noise: Pyy = geo + sigma^2 I
    gram = gram + (cfg.sigma_measure ** 2) * torch.eye(
        2, dtype=dtype, device=dev)
    si = chol2x2_upper(gram)
    return dict(visible=visible,
                pred=torch.where(visible[:, None], mean, lm.pred[lo:hi]),
                si=torch.where(visible[:, None, None], si, lm.si[lo:hi]),
                sigma_pix=pix)
