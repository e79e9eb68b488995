"""SRUKF measurement update — the joint-Gram single-Cholesky form.

The reference applies sequential per-landmark 2D updates followed by a
recompose-refactor "Cholesky downdate" (SLAM.cpp:2048-2327). The default
``update_mode="gram"`` computes the same joint posterior through the normal
equations:

    Pyy = Z^T Z + R_noise (2M x 2M),  Pxy = A^T Z (D x 2M)

and factorizes the JOINT matrix [[Pyy, Pxy^T], [Pxy, G]] (G = S^T S) once:
its upper Cholesky is [[Ryy, Ryx], [0, S']], so the posterior sqrt S'
emerges inside one backward-stable factorization, and dx = Ryx^T Ryy^-T nu.
Unmatched slots get zeroed Z columns plus unit noise — exact no-ops that
keep every shape fixed.

``update_mode`` "batched" and "sequential", and the implicit-mode update,
are not ported yet and raise.
"""

from __future__ import annotations

import torch

from ..config import SlamConfig
from ..ops import gram, tri_solve
from ..ops.linalg import chol_psd_flagged
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
    G = gram(state.S)
    S_new, dx, rep = _joint_schur_chol(pyy, pxy, G, nu)
    ok = any_match & torch.isfinite(S_new).all() & torch.isfinite(dx).all()
    skipped = (any_match & ~ok).to(torch.int32)

    x_new = torch.where(ok, state.x + dx, state.x)
    S_new = torch.where(ok, S_new, state.S)
    state = count_repairs(state, rep)
    return replace(state, x=x_new, S=S_new,
                   n_skipped=state.n_skipped + skipped)


def _joint_schur_chol(pyy: torch.Tensor, pxy: torch.Tensor, G: torch.Tensor,
                      nu: torch.Tensor):
    """Posterior sqrt + state correction via ONE joint Cholesky.

    Forming W = Ryy^-T Pxy^T explicitly and subtracting G - W^T W loses PSD
    by ~eps * cond(Pyy) * ||G|| and goes indefinite in float32. Instead
    factorize the joint matrix

        J = [[Pyy, Pxy^T], [Pxy, G]]  (PSD by construction: a Gram)

    whose upper Cholesky is [[Ryy, Ryx], [0, S']]: the Schur complement
    emerges inside the elimination with error ~eps*||J||.
    dx = Ryx^T Ryy^-T nu. Joint-diagonal equilibration keeps small-variance
    directions representable in float32.
    """
    m2 = pyy.shape[0]
    J = torch.cat([
        torch.cat([pyy, pxy.T], dim=1),
        torch.cat([pxy, G], dim=1)], dim=0)
    dj = torch.sqrt(torch.clamp(torch.diagonal(J), min=0.0))
    dj = torch.where(dj > 0, dj, torch.ones_like(dj))
    Js = J / (dj[:, None] * dj[None, :])
    Rj, rep = chol_psd_flagged(Js, 1e-6)
    R = Rj * dj[None, :]
    ryy = R[:m2, :m2]
    ryx = R[:m2, m2:]
    S_new = R[m2:, m2:]
    dx = ryx.T @ tri_solve(ryy, nu, trans=True)
    return S_new, dx, rep


def kalman_update(state: FilterState, cache: PredictCache,
                  cfg: SlamConfig) -> FilterState:
    if cfg.update_mode == "gram":
        if cfg.sigma_mode == "implicit":
            raise NotImplementedError(
                "the implicit-mode update is not ported yet (ROADMAP.md, "
                "Queue 1: the implicit large-state path)")
        return _update_gram(state, cache, cfg)
    if cfg.update_mode in ("batched", "sequential"):
        raise NotImplementedError(
            f"update_mode={cfg.update_mode!r} is not ported yet "
            f"(ROADMAP.md, Queue 1: the other update modes)")
    raise ValueError(f"unknown update_mode {cfg.update_mode!r}")
