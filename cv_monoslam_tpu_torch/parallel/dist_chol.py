"""Distributed blocked Cholesky: row-sharded right-looking panel
factorization (the counterpart of ``cv_monoslam_tpu/parallel/dist_chol.py``;
SURVEY.md §2.3 "map blocks of X/S sharded over devices").

Upper Cholesky R (A = R^T R) of an n x n SPD matrix whose rows are
block-distributed over the mesh, in panels of ``nb`` columns. Per panel
[k0, k1):

  1. the fully updated diagonal block A[k0:k1, k0:k1] reaches the panel's
     owner (the rank holding row k0) by ``broadcast`` from each rank that
     holds some of its rows — one when the panel lies inside a rank's
     rows, two when it spans ranks (``rows_loc % nb != 0``). It is the only
     part of the panel rows that is read: the JAX package psums the owner's
     rows plus zeros, which is the same values;
  2. the owner factorizes that block and inverts the factor with
     ``ops.linalg.tri_inv_upper`` (so the panel solve is a matrix product
     instead of a triangular solve over all trailing rows), and broadcasts
     both; a block that is not positive definite gives NaN, as JAX's
     Cholesky returns it;
  3. each rank solves the panel over its trailing rows (global rows >= k1):
     W^T_loc = A_loc[:, k0:k1] R_kk^{-1} — the trailing matrix is symmetric,
     so a rank's rows of the panel COLUMNS are the panel's trailing row
     entries read from their lower position;
  4. ``all_gather`` of W^T makes W replicated;
  5. the rank holding the panel's rows writes [R_kk, W] into them;
  6. each rank updates its unfinished rows, A_loc -= W^T_loc W, over the
     columns from k1 up to the end of its last row block: the only entries
     right of a rank's rows that are ever read are inside diagonal blocks,
     which lie within that bound.

The JAX package loops over column blocks in step 6 because XLA needs static
shapes; here the update is one matrix product per panel over the column
range (``addmm_`` in place) — the same nb products summed per element, with
one launch instead of one per block. Summed over the ranks, trailing work
tends to n^3/6 multiply-adds as the rank count grows; one rank updates its
whole trailing square (n^3/3).

Communication per panel: nb x nb (block), 2 nb x nb (factor and inverse),
n x nb (W): about n^2 elements in all against n^3/3 operations. All control
flow is decided from shapes and ranks on the host: no device value is read
and no host value is uploaded, so on an NCCL mesh the factorization can be
captured in a CUDA graph with its collectives (the JAX package calls it
inside ``jax.jit`` under ``set_mesh``). Each factorization of
:func:`chol_rowsharded_padded` is counted on the device, with those whose
factor is not finite (:func:`device_counts`).
"""

from __future__ import annotations

import math

import torch

from ..ops import control
from ..ops.linalg import chol_upper_ex, tri_inv_upper
from .mesh import Mesh


def chol_rowsharded(A_loc: torch.Tensor, mesh: Mesh,
                    panel: int = 64) -> torch.Tensor:
    """This rank's rows of the upper Cholesky factor of the SPD matrix whose
    rows ``[rank * n / size, (rank + 1) * n / size)`` are ``A_loc``
    (``(n / size, n)``). ``n`` must divide by both the mesh size and
    ``panel`` (:func:`chol_rowsharded_padded` takes any ``n``)."""
    rows_loc, n = A_loc.shape
    nb = panel
    if rows_loc * mesh.size != n or n % nb:
        raise ValueError(f"n={n} must divide by devices={mesh.size} and "
                         f"panel={nb}")
    row0 = mesh.rank * rows_loc
    row1 = row0 + rows_loc
    # the last column a rank's rows ever read: the end of its last panel
    c_end = min(n, -(-row1 // nb) * nb)
    A = A_loc.clone()                   # the trailing updates go in place
    R = torch.zeros_like(A)
    for k0 in range(0, n, nb):
        k1 = k0 + nb
        owner = k0 // rows_loc
        # (1) the updated diagonal block, from the ranks holding its rows
        a_kk = A.new_empty((nb, nb))
        for q in range(owner, (k1 - 1) // rows_loc + 1):
            lo, hi = max(k0, q * rows_loc), min(k1, (q + 1) * rows_loc)
            part = a_kk[lo - k0:hi - k0]
            if q == mesh.rank:
                part.copy_(A[lo - row0:hi - row0, k0:k1])
            mesh.broadcast(part, q)
        # (2) the owner factorizes and inverts, then broadcasts both
        rr = A.new_empty((2, nb, nb))
        if mesh.rank == owner:
            r_kk, info = chol_upper_ex(0.5 * (a_kk + a_kk.T))
            r_kk = r_kk.masked_fill(info != 0, float("nan"))
            rr[0] = r_kk
            # base=nb: one triangular solve against I. The recursion below
            # the base turns leaf solves into products for the TPU's
            # matrix unit; on the card each of its ~10 extra small ops
            # costs host time that the panel loop cannot hide
            rr[1] = tri_inv_upper(r_kk, base=nb)
        mesh.broadcast(rr, owner)
        r_kk, r_inv = rr[0], rr[1]
        # (3) panel solve over this rank's trailing rows (global >= k1)
        t0 = min(max(k1 - row0, 0), rows_loc)
        w_loc = A.new_zeros((rows_loc, nb))
        w_loc[t0:] = A[t0:, k0:k1] @ r_inv
        # (4) W replicated: row i of w_all is column i of W
        w_all = mesh.all_gather(w_loc)
        # (5) the panel's rows of R, where this rank holds them
        lo, hi = max(k0, row0), min(k1, row1)
        if lo < hi:
            R[lo - row0:hi - row0, k0:k1] = r_kk[lo - k0:hi - k0]
            R[lo - row0:hi - row0, k1:] = w_all[k1:, lo - k0:hi - k0].T
        # (6) trailing update of this rank's unfinished rows
        if t0 < rows_loc and k1 < c_end:
            A[t0:, k1:c_end].addmm_(w_loc[t0:], w_all[k1:c_end].T,
                                    alpha=-1.0)
    return R


def chol_rowsharded_padded(A: torch.Tensor, mesh: Mesh,
                           panel: int = 64) -> torch.Tensor:
    """Upper Cholesky factor of the replicated SPD ``A`` of any size ``n``,
    replicated on every rank. ``A`` is embedded in the top-left of
    blockdiag(A, I) of the next size that divides by both the mesh size and
    ``panel``: the padding block's factor is I, so the leading n x n of the
    result is exactly chol(A) (in a right-looking factorization the
    trailing rows never feed back into the leading block)."""
    n = A.shape[0]
    step = _lcm(mesh.size, panel)
    n_pad = -(-n // step) * step
    lo, hi = mesh.block(n_pad)
    A_loc = A.new_zeros((hi - lo, n_pad))
    if lo < n:
        A_loc[:min(hi, n) - lo, :n] = A[lo:min(hi, n)]
    p0, p1 = max(lo, n), max(hi, n)
    A_loc[p0 - lo:p1 - lo, p0:p1].diagonal().fill_(1.0)
    R = mesh.all_gather(chol_rowsharded(A_loc, mesh, panel))
    R = R if n_pad == n else R[:n, :n].contiguous()
    _count(R)
    return R


def _counts(dev) -> torch.Tensor:
    """(2,) int32 on ``dev``: factorizations, and those not finite."""
    dev = control.card(dev)
    return control.cached(("dist_chol_counts", dev), lambda: torch.zeros(
        2, dtype=torch.int32, device=dev))


def _count(R: torch.Tensor) -> None:
    """Add this factorization to the counters on the device (in a graph's
    warm-up, whose results are thrown away, to a scratch pair)."""
    counts = _counts(R.device)
    if control.warming():
        counts = control.cached(("dist_chol_warmup_counts", R.device),
                                lambda: torch.zeros_like(counts))
    counts[0:1] += 1
    counts[1:2] += (~torch.isfinite(R).all()).to(torch.int32)


def device_counts(dev) -> dict:
    """Factorizations of :func:`chol_rowsharded_padded` on ``dev`` since
    the last :func:`reset_device_counts`, and how many gave a factor that
    is not finite (each sends a filter frame to the 1e-3 rung); one device
    read."""
    calls, not_finite = _counts(dev).tolist()
    return dict(calls=calls, not_finite=not_finite)


def reset_device_counts(dev) -> None:
    _counts(dev).zero_()


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)
