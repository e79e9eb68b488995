"""Square-root linear algebra, plain: ``torch.linalg`` and the plain
versions of the port's two recurrence kernels.

Frozen from the port's ``ops/linalg.py``: the same functions with the
kernels replaced by their plain versions (``gmw_chol`` is ``gmw_chol_ref``,
``chol_update`` / ``chol_downdate`` the rotation sweeps), the Cholesky by
``torch.linalg.cholesky_ex`` on every device, and no mesh."""

from __future__ import annotations

import torch

from . import control

#: no mesh is ever ambient here (the port's ``parallel`` paths)
class _NoMesh:
    @staticmethod
    def get():
        return (None, False)


AMBIENT = _NoMesh()


def gram(a: torch.Tensor) -> torch.Tensor:
    """A^T A at full precision of ``a``'s dtype."""
    return a.T @ a


def gram_rows(a: torch.Tensor, b: torch.Tensor | None = None
              ) -> torch.Tensor:
    """``a^T b`` (``a^T a`` without ``b``)."""
    b = a if b is None else b
    return a.T @ b


def chol_upper_ex(sym: torch.Tensor):
    """``torch.linalg.cholesky_ex(sym, upper=True)``: (R row-major, info)."""
    r, info = torch.linalg.cholesky_ex(sym, upper=True)
    return r.contiguous(), info


def _chol_upper(g: torch.Tensor):
    """Upper Cholesky of the symmetrized ``g`` (JAX symmetrizes its input
    the same way). Returns (R, bad) with ``bad`` a 0-d bool device tensor:
    the factorization failed (``info != 0``) or is not finite. R is the
    row-major factor as it came out, not yet NaN-filled where it failed."""
    r, info = chol_upper_ex(0.5 * (g + g.T))
    return r, (info != 0) | ~torch.isfinite(r).all()


def chol_psd_flagged(g: torch.Tensor, jitter: float):
    """Upper Cholesky of a (near-)PSD matrix with escalating repair.

    An escalating scaled diagonal shift (jitter x 1, 1e2, 1e3, 1e6) keeps the
    factorization PD, the analogue of the reference's Gill-Murray-Wright
    repair (SLAM.cpp:2197-2327).

    Returns ``(R, level)``: ``level`` (0-d int32 device tensor) is the number
    of jitter rungs the factorization needed — 0 clean, 1-3 minor floors, 4
    the escalated 1e6x rung. If even that rung fails, R is NaN on and above
    the diagonal and 0 below, as JAX returns it.

    The ladder is the JAX one: per rung ``level += bad``, then a refactor of
    the shifted copy under :func:`control.if_`, so a captured chunk keeps
    every rung on the device. Eager, each rung's test is one host read, and
    a clean factorization reads once and builds no shifted copy.
    """
    scale = torch.clamp(torch.max(torch.abs(torch.diagonal(g))), min=1.0)
    r, bad = _chol_upper(g)
    level = torch.zeros((), dtype=torch.int32, device=g.device)
    for mult in (1.0, 1e2, 1e3, 1e6):
        level = level + bad.to(torch.int32)

        def refactor(mult=mult):
            shifted = g.clone()
            shifted.diagonal().add_((mult * jitter) * scale)
            r2, bad2 = _chol_upper(shifted)
            r.copy_(r2)
            bad.copy_(bad2)

        if control.if_(bad, refactor) is False:
            return r, level
    control.if_(bad, lambda: r.copy_(
        torch.triu(torch.full_like(r, float("nan")))))
    return r, level


def _chol_psd(g: torch.Tensor, jitter: float) -> torch.Tensor:
    return chol_psd_flagged(g, jitter)[0]


def cholqr(a: torch.Tensor, jitter: float = 1e-6) -> torch.Tensor:
    """Single-pass CholeskyQR: R with R^T R = A^T A (columns equilibrated)."""
    d = torch.sqrt(torch.sum(a * a, dim=0))
    d = torch.where(d > 0, d, torch.ones_like(d))
    r = _chol_psd(gram(a / d[None, :]), jitter)
    return r * d[None, :]


def cholqr2(a: torch.Tensor, jitter: float = 1e-6) -> torch.Tensor:
    """CholeskyQR2 R factor of tall-skinny ``a`` (n >= d).

    Round 1: R1 = chol(A^T A) on column-equilibrated A.
    Round 2: Q = A R1^{-1}, R2 = chol(Q^T Q), R = R2 R1.
    Q^T Q is within O(eps kappa(A)^2 / kappa(R1)^2) of I, so round 2 restores
    orthogonality lost to the Gram squaring. All heavy ops are matmuls.
    """
    r1 = cholqr(a, jitter)
    q = torch.linalg.solve_triangular(r1.T, a.T, upper=False).T  # A R1^{-1}
    r2 = _chol_psd(gram(q), jitter)
    return r2 @ r1


def tri_solve(r: torch.Tensor, b: torch.Tensor, *, trans: bool = False,
              lower: bool = False) -> torch.Tensor:
    """Solve R x = b (or R^T x = b with trans=True) for triangular R.
    ``b`` is a vector (n,) or a matrix (n, k)."""
    a = r.T if trans else r
    vec = b.dim() == 1
    x = torch.linalg.solve_triangular(a, b[:, None] if vec else b,
                                      upper=(not lower) != trans)
    return x[:, 0] if vec else x


def tri_inv_upper(r: torch.Tensor, base: int = 32) -> torch.Tensor:
    """Explicit inverse of upper-triangular ``r`` by divide-and-conquer:

        inv([[A, B], [0, C]]) = [[A^-1, -A^-1 B C^-1], [0, C^-1]]

    Above the ``base`` size all but the leaf solves become matmuls, and the
    two half-size inverses at each level are independent. Backward error
    matches the triangular solve's; the conditioning caveat of any explicit
    triangular inverse applies unchanged (callers feed equilibrated SPD
    panel factors)."""
    n = r.shape[0]
    if n <= base:
        return torch.linalg.solve_triangular(
            r, torch.eye(n, dtype=r.dtype, device=r.device), upper=True)
    m = n // 2
    ai = tri_inv_upper(r[:m, :m], base)
    ci = tri_inv_upper(r[m:, m:], base)
    top = torch.cat([ai, -((ai @ r[:m, m:]) @ ci)], dim=1)
    bot = torch.cat([r.new_zeros((n - m, m)), ci], dim=1)
    return torch.cat([top, bot], dim=0)


def _gmw_floors(a: torch.Tensor) -> torch.Tensor:
    """The pivot floors (delta, beta^2) of :func:`gmw_chol` for ``a``, a (2,)
    tensor on ``a``'s device (the JAX package's, by the same torch ops on
    both routes)."""
    n = a.shape[0]
    eps = torch.finfo(a.dtype).eps
    diag = torch.diagonal(a)
    gamma = torch.clamp(torch.max(torch.abs(diag)), min=eps)
    off = a - torch.diag(diag)
    xi = torch.clamp(torch.max(torch.abs(off)) if n > 1
                     else a.new_zeros(()), min=eps)
    delta = eps * torch.clamp(gamma + xi, min=1.0)
    beta2 = torch.clamp(torch.maximum(
        gamma, xi / max(float(n * n - 1.0) ** 0.5, 1.0)), min=eps)
    return torch.stack([delta, beta2])


def gmw_chol_ref(a: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gmw_chol`: a Python loop of n pivots, about
    ten device ops each, no host read."""
    n = a.shape[0]
    delta, beta2 = _gmw_floors(a)
    idx = torch.arange(n, device=a.device)

    aw = a
    s = torch.zeros_like(a)
    for j in range(n):
        cjj = aw[j, j]
        col = torch.where(idx > j, aw[:, j], torch.zeros_like(aw[:, j]))
        theta = torch.max(torch.abs(col))
        dj = torch.maximum(torch.maximum(torch.abs(cjj),
                                         theta * theta / beta2), delta)
        low = col / dj                       # L[:, j] strictly below diag
        lfull = torch.where(idx == j, torch.ones_like(low), low)
        aw = aw - dj * torch.outer(low, low)
        s[j] = torch.sqrt(dj) * lfull
    return s


def _rank1_rotate(r: torch.Tensor, u: torch.Tensor, downdate: bool,
                  eps: float) -> torch.Tensor:
    """One rank-1 sqrt update/downdate by a sweep of plane rotations.

    Upper-triangular ``r`` (n, n), vector ``u`` (n,). Returns R' with
    R'^T R' = R^T R ± u u^T. Downdates that would lose positive definiteness
    are clamped (diag^2 floored at eps * diag^2) — the analogue of the
    reference's forced-PD repair (SLAM.cpp:2197-2327). A Python loop of n
    rotations, no host read (every guard is a ``torch.where``).
    """
    n = r.shape[0]
    cols = torch.arange(n, device=r.device)
    r = r.clone()
    for k in range(n):
        rk = r[k]                          # row k, (n,)
        rkk = rk[k]
        uk = u[k]
        if downdate:
            t2 = rkk * rkk - uk * uk
            # PD-loss guard: a column whose downdate would make the pivot
            # imaginary SKIPS its rotation (that u component is dropped).
            # Scaling through a clamped pivot would multiply the trailing
            # row by 1/sqrt(eps).
            pd_ok = t2 >= eps * rkk * rkk
            rho = torch.sqrt(torch.maximum(t2, eps * rkk * rkk))
        else:
            pd_ok = torch.ones((), dtype=torch.bool, device=r.device)
            rho = torch.sqrt(rkk * rkk + uk * uk)
        zero = rho == 0
        inv_rho = torch.where(
            zero, torch.zeros_like(rho),
            1.0 / torch.where(zero, torch.ones_like(rho), rho))
        tail = cols > k
        here = cols == k
        # plane rotation zeroing u[k] against the pivot rkk: hyperbolic
        # (ch^2 - sh^2 = 1) preserves R^T R - u u^T; Givens preserves
        # R^T R + u u^T.
        c = rkk * inv_rho
        s = uk * inv_rho
        new_rk = c * rk - s * u if downdate else c * rk + s * u
        new_u = c * u - s * rk
        new_rk = torch.where(here, rho, torch.where(tail, new_rk, rk))
        u_drop = torch.where(here, torch.zeros_like(u), u)
        new_u = torch.where(tail, new_u, u_drop)
        # no-op guard: exactly-zero uk, or PD-loss skip (u[k] still dropped)
        noop = (uk == 0.0) | ~pd_ok
        r[k] = torch.where(noop, rk, new_rk)
        u = torch.where(noop, u_drop, new_u)
    return r


def chol_update_ref(r: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`chol_update`: k sweeps of n rotations."""
    for uk in torch.atleast_2d(u):
        r = _rank1_rotate(r, uk, downdate=False, eps=0.0)
    return r


def chol_downdate_ref(r: torch.Tensor, u: torch.Tensor,
                      eps: float = 1e-12) -> torch.Tensor:
    """Plain version of :func:`chol_downdate`: k sweeps of n rotations."""
    for uk in torch.atleast_2d(u):
        r = _rank1_rotate(r, uk, downdate=True, eps=eps)
    return r


def chol_update(r: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return chol_update_ref(r, u)


def chol_downdate(r: torch.Tensor, u: torch.Tensor,
                  eps: float = 1e-12) -> torch.Tensor:
    return chol_downdate_ref(r, u, eps)


def gmw_chol(a: torch.Tensor) -> torch.Tensor:
    return gmw_chol_ref(a)
