"""SRUKF time update (motion prediction) — batched over sigma points.

Reference semantics (SLAM.cpp:1343-1595):
  * odometry pair -> control (rot1, trans, rot2) with
    rot1 = atan2(dy, dx) - theta_prev, trans = |d|, rot2 = dtheta - rot1;
  * control sqrt-noise Mt = diag(a1 r1^2 + a2 t^2, a3 t^2 + a4 r1^2 + a4 r2^2,
    a1 r2^2 + a2 t^2) placed directly into the augmented sqrt block
    (SLAM.cpp:1456-1458), capped at ``motion_noise_cap``;
  * augmented state [x; 3 control-noise; 2 measurement-noise] (Na = D + 5);
  * only the last-4 robot rows propagate: noise *subtracted* from the
    control, then x += t cos(theta + r1), y += t sin(theta + r1),
    theta += r1 + r2 (SLAM.cpp:1488-1530);
  * new S from the sqrt(wi)-scaled deviations (SLAM.cpp:1539-1555), via the
    structured Gram under qr_mode="gram".

The propagated augmented sigma set is returned for reuse by the measurement
predict and update (the reference keeps m_sigma across phases).
"""

from __future__ import annotations

import torch

from ..config import SlamConfig
from ..ops import qr_r
from ..ops.linalg import chol_psd_flagged
from .sigma import deviations, generate_sigma, ut_weights
from .state import FilterState, PredictCache, count_repairs, replace


def odometry_control(odo_prev: torch.Tensor, odo_cur: torch.Tensor):
    """(x, y, theta) pair -> (rot1, trans, rot2) (SLAM.cpp:1446-1454)."""
    d = odo_cur[:2] - odo_prev[:2]
    rot1 = torch.atan2(d[1], d[0]) - odo_prev[2]
    trans = torch.sqrt(d[0] ** 2 + d[1] ** 2)
    rot2 = odo_cur[2] - odo_prev[2] - rot1
    return rot1, trans, rot2


def structured_sqrt_gram(S: torch.Tensor, sig_out: torch.Tensor,
                         ridx: torch.Tensor, w, na: int, *,
                         with_flag: bool = False):
    """Posterior sqrt factor via a structured Gram — no (2Na x D) QR.

    For any UT whose output differs from the prior state only in the rows
    ``ridx`` (motion predict touches {x, y, theta}; feature integration
    touches the 6*K new-slot rows), the deviation matrix keeps the exact
    sigma-offset structure +-gamma*S rows in every OTHER column. With
    c = wi_sr, g = gamma and E+/E- the propagated ridx-column deviations of
    the +/- sigma branches:

        G[F,F] = 2 (c g)^2 (S^T S)[F,F]
        G[F,R] = c^2 g  S[:,F]^T (E+ - E-)[:D]
        G[R,R] = c^2 (E+^T E+ + E-^T E-)

    and S' = chol(G) (equilibrated, PD-repaired).
    """
    base = sig_out[ridx, :1]                                   # (|R|, 1)
    Ep = (sig_out[ridx, 1:na + 1] - base).T                    # (Na, |R|)
    Em = (sig_out[ridx, na + 1:] - base).T                     # (Na, |R|)
    return structured_sqrt_gram_rows(S, Ep, Em, ridx, w,
                                     with_flag=with_flag)


def structured_gram_rows(S: torch.Tensor, Ep: torch.Tensor,
                         Em: torch.Tensor, ridx: torch.Tensor, w):
    """Posterior covariance GRAM (no factorization) from the touched-row
    deviations: Ep/Em (Na_aug, |R|) are (chi_i - chi_0) for the +/- sigma
    branches restricted to rows ``ridx``."""
    D = S.shape[0]
    c2g2 = 2.0 * (w.wi_sr * w.gamma) ** 2
    G = c2g2 * (S.T @ S)                                       # (D, D)
    cross = (w.wi_sr ** 2 * w.gamma) * (S.T @ (Ep[:D] - Em[:D]))
    grr = (w.wi_sr ** 2) * (Ep.T @ Ep + Em.T @ Em)
    G[:, ridx] = cross
    G[ridx, :] = cross.T
    G[ridx[:, None], ridx[None, :]] = grr
    return G


def equilibrated_chol(G: torch.Tensor, jitter: float = 1e-6):
    """Upper sqrt of a covariance Gram via diag-equilibrated, PD-repaired
    Cholesky (cf ops.linalg.cholqr). Returns (R, repair_level)."""
    d = torch.sqrt(torch.clamp(torch.diagonal(G), min=0.0))
    d = torch.where(d > 0, d, torch.ones_like(d))
    r, rep = chol_psd_flagged(G / (d[:, None] * d[None, :]), jitter)
    return r * d[None, :], rep


def structured_sqrt_gram_rows(S: torch.Tensor, Ep: torch.Tensor,
                              Em: torch.Tensor, ridx: torch.Tensor, w, *,
                              with_flag: bool = False):
    """Core of :func:`structured_sqrt_gram` taking the propagated-row
    deviations directly (see :func:`structured_gram_rows`)."""
    G = structured_gram_rows(S, Ep, Em, ridx, w)
    R, rep = equilibrated_chol(G)
    return (R, rep) if with_flag else R


def _motion_sqrt_gram(S: torch.Tensor, sig: torch.Tensor, w, D: int,
                      na: int):
    ridx = torch.tensor([D - 4, D - 3, D - 1], device=S.device)
    return structured_sqrt_gram(S, sig[:D], ridx, w, na, with_flag=True)


def _control_noise(rot1, trans, rot2, cfg: SlamConfig, dtype):
    """Capped control sqrt-noise diagonal Mt (SLAM.cpp:1456-1458)."""
    mt = torch.stack([
        cfg.a1 * rot1 ** 2 + cfg.a2 * trans ** 2,
        cfg.a3 * trans ** 2 + cfg.a4 * rot1 ** 2 + cfg.a4 * rot2 ** 2,
        cfg.a1 * rot2 ** 2 + cfg.a2 * trans ** 2,
    ]).to(dtype)
    return torch.clamp(mt, max=cfg.motion_noise_cap)


def motion_predict_implicit(state: FilterState, odo_prev: torch.Tensor,
                            odo_cur: torch.Tensor, cfg: SlamConfig):
    """Time update without materializing the sigma tensor.

    The motion model touches exactly three state rows {x, y, theta}, and the
    sigma rule chi_i = mu +- gamma*S_row_i means the (2Na+1)-vector of
    row-j values is read straight off COLUMN j of S. Propagating only those
    row-vectors (plus the three control-noise rows) reproduces the full
    UT's robot-row outputs exactly; the mean of every untouched row is mu_j
    (the +- branches cancel at equal weights).

    The predicted covariance is returned as a GRAM in ``cache.g_pred``; the
    update factorizes the posterior directly, so ``state.S`` is STALE until
    then (no stage in between reads S: data association uses lm and pose
    fields only).
    """
    dtype = state.x.dtype
    dev = state.x.device
    D = cfg.state_dim
    na = D + 5
    ns = 2 * na + 1
    w = ut_weights(na, cfg)
    g = w.gamma

    rot1, trans, rot2 = odometry_control(odo_prev, odo_cur)
    mt = _control_noise(rot1, trans, rot2, cfg, dtype)

    # (3, 2Na+1) values of state rows x, y, theta across the sigma set
    ridx = torch.tensor([D - 4, D - 3, D - 1], device=dev)
    cols = torch.cat([state.S[:, ridx].T,
                      torch.zeros((3, 5), dtype=dtype, device=dev)], dim=1)
    mu_r = state.x[ridx][:, None]
    rows = torch.cat([mu_r, mu_r + g * cols, mu_r - g * cols], dim=1)
    # (3, 2Na+1) control-noise rows: +-gamma*mt at their own column only
    noise = torch.zeros((3, ns), dtype=dtype, device=dev)
    k = torch.arange(3, device=dev)
    noise[k, 1 + D + k] = g * mt
    noise[k, 1 + na + D + k] = -g * mt

    r1 = rot1 - noise[0]
    tr = trans - noise[1]
    r2 = rot2 - noise[2]
    th_row = rows[2]
    R = torch.stack([rows[0] + tr * torch.cos(th_row + r1),
                     rows[1] + tr * torch.sin(th_row + r1),
                     th_row + r1 + r2])                        # (3, 2Na+1)

    x_new = state.x.clone()
    x_new[ridx] = R @ w.mean_weights(dtype, dev)

    base = R[:, :1]
    Ep = (R[:, 1:na + 1] - base).T                             # (Na, 3)
    Em = (R[:, na + 1:] - base).T
    g_pred = structured_gram_rows(state.S, Ep, Em, ridx, w)

    cache = PredictCache(
        sigma=None, sigma_pix=None,
        pred=torch.zeros((cfg.max_landmarks, 2), dtype=dtype, device=dev),
        g_pred=g_pred,
    )
    return replace(state, x=x_new), cache


def motion_predict(state: FilterState, odo_prev: torch.Tensor,
                   odo_cur: torch.Tensor, cfg: SlamConfig):
    """One SRUKF time update. Returns (new_state, PredictCache)."""
    if cfg.sigma_mode == "implicit":
        return motion_predict_implicit(state, odo_prev, odo_cur, cfg)
    dtype = state.x.dtype
    dev = state.x.device
    D = cfg.state_dim
    na = D + 5
    w = ut_weights(na, cfg)

    rot1, trans, rot2 = odometry_control(odo_prev, odo_cur)
    mt = _control_noise(rot1, trans, rot2, cfg, dtype)

    # augmented mean + sqrt (expandMatrix, SLAM.cpp:1461-1462). The 2
    # measurement-noise dims stay zero: independent per-landmark pixel
    # noise enters the innovation Gram (measurement.py) and the update
    mu = torch.cat([state.x, torch.zeros(5, dtype=dtype, device=dev)])
    sr = torch.zeros((na, na), dtype=dtype, device=dev)
    sr[:D, :D] = state.S
    k = torch.arange(D, D + 3, device=dev)
    sr[k, k] = mt

    sig = generate_sigma(mu, sr, w.gamma)

    # propagate robot rows (noise subtracted from control, SLAM.cpp:1497-1524)
    r1 = rot1 - sig[D + 0]
    tr = trans - sig[D + 1]
    r2 = rot2 - sig[D + 2]
    theta = sig[D - 1]
    sig[D - 4] += tr * torch.cos(theta + r1)
    sig[D - 3] += tr * torch.sin(theta + r1)
    sig[D - 1] += r1 + r2

    x_new = sig[:D] @ w.mean_weights(dtype, dev)
    rep = 0
    if cfg.qr_mode == "gram":
        S_new, rep = _motion_sqrt_gram(state.S, sig, w, D, na)
    else:
        S_new = qr_r(deviations(sig[:D], w.wi_sr), cfg.qr_mode)

    new_state = count_repairs(replace(state, x=x_new, S=S_new), rep)
    cache = PredictCache(
        sigma=sig,
        sigma_pix=torch.zeros((cfg.max_landmarks, 2, sig.shape[1]),
                              dtype=dtype, device=dev),
        pred=torch.zeros((cfg.max_landmarks, 2), dtype=dtype, device=dev),
    )
    return new_state, cache
