"""Square-root linear algebra on torch tensors.

Dense products and factorizations the JAX package leaves to XLA: here they go
to ``torch.matmul``/``torch.linalg`` (cuBLAS/cuSOLVER on the card). Float32
products on the card run in full FP32: nothing in this package enables TF32,
which keeps about three decimal digits and makes covariance Grams
indefinite.

``torch.linalg.cholesky`` raises on a non-PD input, where JAX's returns NaN;
the repair ladder below keys off ``cholesky_ex``'s ``info`` and fills a
failed factor with NaN as JAX does, so callers see JAX's failure
semantics.
"""

from __future__ import annotations

import torch


def gram(a: torch.Tensor) -> torch.Tensor:
    """A^T A at full precision of ``a``'s dtype."""
    return a.T @ a


def _chol_upper(g: torch.Tensor):
    """Upper Cholesky of the symmetrized ``g`` (JAX symmetrizes its input
    the same way). Returns (R, bad) with ``bad`` a Python bool, read on the
    host (one device sync); a failed factor is NaN on and above the diagonal
    and 0 below, as JAX returns it."""
    r, info = torch.linalg.cholesky_ex(0.5 * (g + g.T), upper=True)
    bad = bool((info != 0) | ~torch.isfinite(r).all())
    if bad:
        return torch.triu(torch.full_like(r, float("nan"))), bad
    # row-major copy: ``upper=True`` may hand back a transposed view, and the
    # products downstream round differently on another memory layout
    return r.contiguous(), bad


def chol_psd_flagged(g: torch.Tensor, jitter: float):
    """Upper Cholesky of a (near-)PSD matrix with escalating repair.

    An escalating scaled diagonal shift (jitter x 1, 1e2, 1e3, 1e6) keeps the
    factorization PD, the analogue of the reference's Gill-Murray-Wright
    repair (SLAM.cpp:2197-2327).

    Returns ``(R, level)``: ``level`` (Python int) is the number of jitter
    rungs the factorization needed — 0 clean, 1-3 minor floors, 4 the
    escalated 1e6x rung. If even that rung fails, R is NaN (on and above
    the diagonal).

    Each rung's test is read on the host: one device sync for a clean
    factorization, one more per extra rung. A clean factorization builds no
    shifted copy of ``g``.
    """
    scale = torch.clamp(torch.max(torch.abs(torch.diagonal(g))), min=1.0)
    r, bad = _chol_upper(g)
    level = 0
    for mult in (1.0, 1e2, 1e3, 1e6):
        if not bad:
            break
        level += 1
        shifted = g.clone()
        shifted.diagonal().add_((mult * jitter) * scale)
        r, bad = _chol_upper(shifted)
    return r, level


def _chol_psd(g: torch.Tensor, jitter: float) -> torch.Tensor:
    return chol_psd_flagged(g, jitter)[0]


def cholqr(a: torch.Tensor, jitter: float = 1e-6) -> torch.Tensor:
    """Single-pass CholeskyQR: R with R^T R = A^T A (columns equilibrated)."""
    d = torch.sqrt(torch.sum(a * a, dim=0))
    d = torch.where(d > 0, d, torch.ones_like(d))
    r = _chol_psd(gram(a / d[None, :]), jitter)
    return r * d[None, :]


def tri_solve(r: torch.Tensor, b: torch.Tensor, *, trans: bool = False,
              lower: bool = False) -> torch.Tensor:
    """Solve R x = b (or R^T x = b with trans=True) for triangular R.
    ``b`` is a vector (n,) or a matrix (n, k)."""
    a = r.T if trans else r
    vec = b.dim() == 1
    x = torch.linalg.solve_triangular(a, b[:, None] if vec else b,
                                      upper=(not lower) != trans)
    return x[:, 0] if vec else x
