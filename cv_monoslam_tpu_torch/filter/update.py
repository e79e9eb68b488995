"""SRUKF measurement update — three strategies on fixed shapes.

The reference applies **sequential per-landmark 2D updates** with stale
sigma-point reuse (SLAM.cpp:2048-2104) followed by a recompose-refactor
"Cholesky downdate" (SLAM.cpp:2106-2327). This module offers:

``update_mode="gram"`` (default, the joint-Gram single-Cholesky form):
    Pyy = Z^T Z + R_noise (2M x 2M),  Pxy = A^T Z (D x 2M), and ONE
    factorization of the joint matrix [[Pyy, Pxy^T], [Pxy, G]] (G = S^T S):
    its upper Cholesky is [[Ryy, Ryx], [0, S']], so the posterior sqrt S'
    emerges inside one backward-stable factorization, and
    dx = Ryx^T Ryy^-T nu. Under ``sigma_mode="implicit"`` the same joint
    matrix is assembled from the UT-implied per-landmark linearization and
    the motion-predicted covariance Gram (``_update_gram_implicit``): the
    frame's only D x D factorization.

``update_mode="batched"`` (joint QR-Schur, the accuracy reference):
    One QR over the stacked innovation/state deviation matrix

        M  = [[Z_masked, A], [Pad, 0]]          (2Na + 2M, 2M + D)
        R  = qr(M) = [[Ryy, Ryx], [0, Rxx]]
        dx = Ryx^T Ryy^-T nu_masked
        S' = Rxx                                 exact Schur complement

``update_mode="sequential"`` (reference-faithful): per-landmark 2D gain +
    true rank-2 hyperbolic downdate (ops.linalg.chol_downdate) in the
    reference's slot order, reusing stale sigma deviations exactly as
    SLAM.cpp:2063-2095 does: a fixed-trip loop over all slots, each under
    its matched flag (see ``_update_sequential``). A reference mode, not a
    fast one.

Unmatched slots get zeroed Z columns plus unit noise (a unit Pad row in the
batched form) — exact no-ops that keep every shape fixed. P' = S'^T S' is
always PSD in the batched/gram paths; the sequential path inherits the
reference's information double-counting (that is the point of offering it).

With ``cfg.dist_chol_panel > 0`` and a mesh made ambient by
``parallel.mesh.set_mesh``, the gram updates' joint factorization runs as
the row-sharded panel Cholesky across that mesh (``parallel/dist_chol.py``;
``_dist_joint_chol``); without a mesh the panel width is ignored, as in the
JAX package.
"""

from __future__ import annotations

import torch

from ..config import SlamConfig
from ..ops import chol_downdate, control, gmw_chol, gram, tri_solve
from ..ops.linalg import AMBIENT, chol_psd_flagged, gram_rows
from .sigma import ut_weights
from .state import FilterState, PredictCache, count_repairs, replace


def _deviation_blocks(state: FilterState, cache: PredictCache,
                      cfg: SlamConfig):
    """Shared preamble: masked innovation/state deviation blocks."""
    D = cfg.state_dim
    M = cfg.max_landmarks
    w = ut_weights(D + 5, cfg)
    lm = state.lm

    A = w.wi_sr * (cache.sigma[:D, 1:] - cache.sigma[:D, :1]).T  # (2Na, D)
    dz = w.wi_sr * (cache.sigma_pix[:, :, 1:] - cache.sigma_pix[:, :, :1])
    Z = dz.reshape(2 * M, -1).T                                  # (2Na, 2M)
    cmask = torch.repeat_interleave(lm.matched, 2)               # (2M,)
    Z = torch.where(cmask[None, :], Z, torch.zeros_like(Z))
    nu = (lm.match_px - lm.pred).reshape(-1)                     # (2M,)
    nu = torch.where(cmask, nu, torch.zeros_like(nu))
    return A, Z, nu, cmask


def _update_batched(state: FilterState, cache: PredictCache,
                    cfg: SlamConfig) -> FilterState:
    dtype = state.x.dtype
    D = cfg.state_dim
    M = cfg.max_landmarks
    A, Z, nu, cmask = _deviation_blocks(state, cache, cfg)
    any_match = torch.any(state.lm.matched)

    pad = torch.diag(torch.where(
        cmask, torch.full_like(nu, cfg.sigma_measure),
        torch.ones_like(nu)).to(dtype))
    top = torch.cat([Z, A], dim=1)
    bot = torch.cat([pad, pad.new_zeros((2 * M, D))], dim=1)
    R = torch.linalg.qr(torch.cat([top, bot], dim=0), mode="r")[1]

    m2 = 2 * M
    ryy, ryx, rxx = R[:m2, :m2], R[:m2, m2:], R[m2:, m2:]
    dx = ryx.T @ tri_solve(ryy, nu, trans=True)

    x_new = torch.where(any_match, state.x + dx, state.x)
    S_new = torch.where(any_match, rxx, state.S)
    return replace(state, x=x_new, S=S_new)


def _update_gram(state: FilterState, cache: PredictCache,
                 cfg: SlamConfig) -> FilterState:
    dtype = state.x.dtype
    A, Z, nu, cmask = _deviation_blocks(state, cache, cfg)
    any_match = torch.any(state.lm.matched)

    r_noise = torch.where(
        cmask, torch.full_like(nu, cfg.sigma_measure ** 2),
        torch.ones_like(nu)).to(dtype)
    pyy = gram(Z) + torch.diag(r_noise)                    # (2M, 2M)
    pxy = A.T @ Z                                          # (D, 2M)
    # joint-Gram Cholesky: the Schur complement emerges inside one
    # factorization instead of the f32-cancellation-prone explicit
    # G - W^T W; an unrepairable frame degrades to "skip this update"
    G = gram_rows(state.S)
    S_new, dx, rep = _joint_schur_chol(pyy, pxy, G, nu, cfg)
    ok = any_match & torch.isfinite(S_new).all() & torch.isfinite(dx).all()
    skipped = (any_match & ~ok).to(torch.int32)

    x_new = torch.where(ok, state.x + dx, state.x)
    S_new = torch.where(ok, S_new, state.S)
    state = count_repairs(state, rep)
    return replace(state, x=x_new, S=S_new,
                   n_skipped=state.n_skipped + skipped)


def _update_gram_implicit(state: FilterState, cache: PredictCache,
                          cfg: SlamConfig) -> FilterState:
    """Gram update from the UT-implied linearization (sigma_mode implicit).

    With A = the full-state sigma deviations, A^T A = c * S^T S exactly
    (c = 2*(wi_sr*gamma)^2, the structured-Gram identity), and the
    innovation deviations are Z = A[:, cols_m] H_m^T per landmark. So

        Pxy = A^T Z = c * (G Hbar^T),   Pyy = Z^T Z = c * Hbar G Hbar^T

    with G = S^T S and Hbar the (2M x D) block-sparse stack of the H_m:
    everything is Grams of S plus small per-landmark (6/4)-dim einsums; the
    (2Na x 2M) innovation tensor never exists.
    """
    dtype = state.x.dtype
    D = cfg.state_dim
    M = cfg.max_landmarks
    lm = state.lm
    H = cache.h_lin                                       # (M, 2, 10)
    any_match = torch.any(lm.matched)
    w = ut_weights(D + 5, cfg)
    c = 2.0 * (w.wi_sr * w.gamma) ** 2

    # the motion stage hands over the predicted covariance GRAM (state.S is
    # stale); this stage performs the frame's only D x D factorization, on
    # the posterior
    G = cache.g_pred if cache.g_pred is not None else gram_rows(state.S)

    # B2 = G Hbar^T (D, 2M), built blockwise from G's landmark/robot cols
    Gf = G[:, : 6 * M].reshape(D, M, 6)
    Gr = G[:, D - 4:]
    B2 = (torch.einsum("dmi,mki->dmk", Gf, H[:, :, :6])
          + torch.einsum("di,mki->dmk", Gr, H[:, :, 6:])).reshape(D, 2 * M)
    cmask = torch.repeat_interleave(lm.matched, 2)        # (2M,)
    B2 = torch.where(cmask[None, :], B2, torch.zeros_like(B2))

    # Pyy = Hbar B2 (2M, 2M), rows of unmatched slots zeroed
    B2f = B2[: 6 * M].reshape(M, 6, 2 * M)
    B2r = B2[D - 4:]
    pyy = (torch.einsum("mki,mia->mka", H[:, :, :6], B2f)
           + torch.einsum("mki,ia->mka", H[:, :, 6:], B2r)
           ).reshape(2 * M, 2 * M)
    pyy = torch.where(cmask[:, None], pyy, torch.zeros_like(pyy))
    nu = (lm.match_px - lm.pred).reshape(-1)
    nu = torch.where(cmask, nu, torch.zeros_like(nu))
    r_noise = torch.where(
        cmask, torch.full_like(nu, cfg.sigma_measure ** 2),
        torch.ones_like(nu)).to(dtype)
    pyy = c * 0.5 * (pyy + pyy.T) + torch.diag(r_noise)
    pxy = c * B2

    S_new, dx, rep = _joint_schur_chol(pyy, pxy, G, nu, cfg)
    # a no-match frame factorizes G itself (Pxy = 0): the posterior equals
    # the prediction and the frame's single Cholesky still refreshes S
    ok = torch.isfinite(S_new).all() & torch.isfinite(dx).all()
    # counted regardless of any_match: on a NO-match frame ~ok falls back
    # to the STALE pre-motion sqrt, silently dropping the frame's motion
    # noise — telemetry must surface that, not report a clean frame
    skipped = (~ok).to(torch.int32)

    x_new = torch.where(ok & any_match, state.x + dx, state.x)
    # unrepairable posterior: fall back to the pre-motion sqrt (finite,
    # conservative — the frame degrades to prediction-only, counted)
    S_new = torch.where(ok, S_new, state.S)
    state = count_repairs(state, rep)
    return replace(state, x=x_new, S=S_new,
                   n_skipped=state.n_skipped + skipped)


def _dist_joint_chol(Js: torch.Tensor, panel: int):
    """Row-sharded blocked Cholesky of the equilibrated joint matrix across
    the ambient mesh (``parallel/dist_chol.py``) with a two-rung repair, as
    the JAX package writes it: a clean attempt, then one 1e-3 diagonal
    shift under :func:`control.if_` when the factor is not finite (level
    1). A result that is still not finite is level 4, and the caller's skip
    fallback degrades the frame to prediction-only — chol_psd_flagged's
    escalated rung without six distributed factorizations. The level is a
    0-d int32 device tensor; captured, the rung is a conditional node with
    its collectives inside, and eagerly its test is one host read. The
    factor is replicated, so every rank takes the same branch."""
    from ..parallel.dist_chol import chol_rowsharded_padded

    mesh = AMBIENT.get()[0]
    r = chol_rowsharded_padded(Js, mesh, panel)
    bad = ~torch.isfinite(r).all()
    level = bad.to(torch.int32)

    def shifted():
        js = Js.clone()
        js.diagonal().add_(1e-3)
        r.copy_(chol_rowsharded_padded(js, mesh, panel))

    control.if_(bad, shifted)
    return r, level.masked_fill(~torch.isfinite(r).all(), 4)


def _use_dist_chol(cfg: SlamConfig | None) -> bool:
    """The distributed factorization needs both the config opt-in and an
    ambient mesh (``parallel.mesh.set_mesh``)."""
    return bool(cfg is not None and cfg.dist_chol_panel > 0
                and AMBIENT.get()[0] is not None)


def _joint_schur_chol(pyy: torch.Tensor, pxy: torch.Tensor, G: torch.Tensor,
                      nu: torch.Tensor, cfg: SlamConfig | None = None):
    """Posterior sqrt + state correction via ONE joint Cholesky.

    Forming W = Ryy^-T Pxy^T explicitly and subtracting G - W^T W loses PSD
    by ~eps * cond(Pyy) * ||G|| and goes indefinite in float32. Instead
    factorize the joint matrix

        J = [[Pyy, Pxy^T], [Pxy, G]]  (PSD by construction: a Gram)

    whose upper Cholesky is [[Ryy, Ryx], [0, S']]: the Schur complement
    emerges inside the elimination with error ~eps*||J||.
    dx = Ryx^T Ryy^-T nu. Joint-diagonal equilibration keeps small-variance
    directions representable in float32.

    Under ``cfg.dist_chol_panel > 0`` with an ambient mesh the (2M + D)^2
    factorization runs as the row-sharded panel algorithm instead.
    """
    m2 = pyy.shape[0]
    J = torch.cat([
        torch.cat([pyy, pxy.T], dim=1),
        torch.cat([pxy, G], dim=1)], dim=0)
    dj = torch.sqrt(torch.clamp(torch.diagonal(J), min=0.0))
    dj = torch.where(dj > 0, dj, torch.ones_like(dj))
    Js = J / (dj[:, None] * dj[None, :])
    if _use_dist_chol(cfg):
        Rj, rep = _dist_joint_chol(Js, cfg.dist_chol_panel)
    else:
        Rj, rep = chol_psd_flagged(Js, 1e-6)
    R = Rj * dj[None, :]
    ryy = R[:m2, :m2]
    ryx = R[:m2, m2:]
    S_new = R[m2:, m2:]
    dx = ryx.T @ tri_solve(ryy, nu, trans=True)
    return S_new, dx, rep


def _update_sequential(state: FilterState, cache: PredictCache,
                       cfg: SlamConfig) -> FilterState:
    """Reference-faithful per-landmark loop (SLAM.cpp:2048-2104).

    The JAX package's scan over all M slots in slot order, each slot's
    update under its matched flag (:func:`control.if_`, the ``lax.cond``):
    a captured frame holds M conditional nodes and reads nothing back; eager,
    each gate is one host read. The body writes into the x / S buffers made
    before the loop. A slot's downdate is one launch of the rotation-sweep
    kernel on the card (``ops.linalg.chol_downdate``), or with
    ``downdate_mode="gmw"`` two Grams and two modified Choleskys
    (``ops.linalg.gmw_chol``, one kernel launch each)."""
    dtype = state.x.dtype
    D = cfg.state_dim
    w = ut_weights(D + 5, cfg)
    lm = state.lm

    A = w.wi_sr * (cache.sigma[:D, 1:] - cache.sigma[:D, :1]).T  # (2Na, D)
    dz = w.wi_sr * (cache.sigma_pix[:, :, 1:]
                    - cache.sigma_pix[:, :, :1])                 # (M, 2, 2Na)
    nu_all = lm.match_px - lm.pred                               # (M, 2)

    x, S = state.x.clone(), state.S.clone()

    def body(m: int) -> None:
        pxy = A.T @ dz[m].T                        # (D, 2)
        si = lm.si[m]                              # (2, 2) upper
        # K = Pxy (Si^T Si)^-1  via two triangular solves
        k = tri_solve(si, tri_solve(si, pxy.T, trans=True)).T  # (D, 2)
        x.copy_(x + k @ nu_all[m])
        u = (k @ si.T).T                           # (2, D): U U^T = K Pyy K^T
        if cfg.downdate_mode == "gmw":
            # reference recompose-refactor (SLAM.cpp:2106-2327): one
            # column at a time, Gill-Murray-Wright PD repair
            for col in range(2):
                S.copy_(gmw_chol(gram(S) - torch.outer(u[col], u[col])))
        else:
            S.copy_(chol_downdate(S, u))

    for m in range(cfg.max_landmarks):
        control.if_(lm.matched[m], lambda m=m: body(m))
    return replace(state, x=x.to(dtype), S=S.to(dtype))


def kalman_update(state: FilterState, cache: PredictCache,
                  cfg: SlamConfig) -> FilterState:
    if cfg.update_mode == "batched":
        return _update_batched(state, cache, cfg)
    if cfg.update_mode == "gram":
        if cfg.sigma_mode == "implicit":
            return _update_gram_implicit(state, cache, cfg)
        return _update_gram(state, cache, cfg)
    if cfg.update_mode == "sequential":
        return _update_sequential(state, cache, cfg)
    raise ValueError(f"unknown update_mode {cfg.update_mode!r}")
