"""PyTorch port: the two recurrences of ``ops/csrc/linalg_kernels.cu``.

``rank_rotate`` (the rotation sweep of ``chol_update`` / ``chol_downdate``)
and ``gmw_chol`` (the modified Cholesky) run only on the card. Here:

* their plain versions (the CPU route) against the JAX package's
  ``lax.scan`` forms, float64, on the cases the card checks (downdates that
  lose positive definiteness, zero entries of U, a zero U; indefinite, zero
  and non-finite A): 1e-10 relative / 1e-12 absolute on finite entries
  (the same operations in the same order; XLA may contract a product and
  a sum that torch rounds apart), non-finite entries in the same places;
* numpy models of the kernels' designs, thread by thread (``rank_rotate``:
  a thread per column, strided, the pivot handed on through two slots;
  ``gmw_chol``: the transposed working matrix, only the trailing block
  updated), against the plain versions: bit for bit, float32 and float64.
  The models take their square roots from torch, as the plain version on
  the CPU does: torch's CPU square root is not always the correctly
  rounded one (``sqrt(8.745118874300298)`` comes out one ulp low), which
  the kernels' ``__dsqrt_rn`` / ``__fsqrt_rn`` and torch's CUDA square
  root are;
* the wrappers: CPU tensors take the plain version and launch nothing; the
  checks the CUDA branch makes, called directly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_monoslam_tpu.ops import linalg as jla
from cv_monoslam_tpu_torch.ops import linalg as tla


def _upper(n, rng, scale=1.0):
    r = np.triu(rng.normal(size=(n, n)))
    r[np.diag_indices(n)] = np.abs(np.diag(r)) + 2.0
    return r * scale


def _rotate_case(case, n=12, k=2, seed=0):
    rng = np.random.default_rng(seed)
    r = _upper(n, rng)
    u = rng.normal(size=(k, n)) * (3.0 if case == "pd_loss" else 0.3)
    if case == "zeros_in_u":
        u[:, ::3] = 0.0
    elif case == "zero":
        u[:] = 0.0
    return r, u


def _gmw_case(case, n=10, seed=1):
    rng = np.random.default_rng(seed)
    b = rng.normal(size=(n, n))
    if case == "indefinite":
        return 0.5 * (b + b.T)
    if case == "zero":
        return np.zeros((n, n))
    a = b.T @ b / n + 0.01 * np.eye(n)
    if case == "gram_minus":
        v = rng.normal(size=n)
        a = a - 4.0 * np.outer(v, v)
    elif case == "nonfinite":
        a[2, 5] = np.inf
        a[5, 1] = np.nan
    return a


def _same(got, want, rtol=1e-10, atol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", ["random", "pd_loss", "zeros_in_u", "zero"])
@pytest.mark.parametrize("downdate", [True, False], ids=["down", "up"])
def test_rotation_sweep_plain_matches_jax(case, downdate):
    r, u = _rotate_case(case)
    t = (tla.chol_downdate_ref if downdate else tla.chol_update_ref)(
        torch.as_tensor(r), torch.as_tensor(u)).numpy()
    j = np.asarray((jla.chol_downdate if downdate else jla.chol_update)(
        jnp.asarray(r), jnp.asarray(u)))
    _same(t, j)
    if case == "zero":
        np.testing.assert_array_equal(t, r)


@pytest.mark.parametrize("case", ["spd", "gram_minus", "indefinite", "zero",
                                  "nonfinite"])
def test_gmw_plain_matches_jax(case):
    a = _gmw_case(case)
    t = tla.gmw_chol_ref(torch.as_tensor(a)).numpy()
    j = np.asarray(jla.gmw_chol(jnp.asarray(a)))
    _same(t, j)
    if case == "spd":
        np.testing.assert_allclose(t.T @ t, a, rtol=1e-10, atol=1e-12)


# -- numpy models of the kernels' designs --------------------------------------


def _sqrt(x):
    """torch's square root of one number, in its dtype."""
    return torch.sqrt(torch.as_tensor(x)).numpy()[()]


def _model_rank_rotate(r, u, downdate, eps, nt, order=1):
    """``rank_rotate_kernel`` thread by thread: ``nt`` threads, thread t
    owning columns t, t + nt, ...; between two barriers the threads run in
    ``order`` (1 or -1), so a value read in the same step another thread
    writes would show as a difference between the two orders."""
    dt = r.dtype.type
    n = r.shape[0]
    eps = dt(eps)
    out = r.copy()
    for row in np.atleast_2d(u):
        us = row.copy()
        bc_r, bc_u = [out[0, 0], dt(0)], [us[0], dt(0)]
        for p in range(n):
            rkk, uk = bc_r[p & 1], bc_u[p & 1]
            if downdate:
                t2 = rkk * rkk - uk * uk
                fl = (eps * rkk) * rkk
                pd_ok = t2 >= fl
                rho = _sqrt(fl if np.isnan(fl) else (
                    t2 if (np.isnan(t2) or t2 > fl) else fl))
            else:
                pd_ok = True
                rho = _sqrt(rkk * rkk + uk * uk)
            for tid in range(nt)[::order]:
                if not (uk == 0 or not pd_ok):
                    inv = dt(0) if rho == 0 else dt(1) / rho
                    c, s = rkk * inv, uk * inv
                    j = p + 1 + ((tid - (p + 1)) % nt + nt) % nt
                    while j < n:
                        rk, uj = out[p, j], us[j]
                        out[p, j] = c * rk - s * uj if downdate \
                            else c * rk + s * uj
                        us[j] = c * uj - s * rk
                        j += nt
                    if tid == p % nt:
                        out[p, p] = rho
                if p + 1 < n and tid == (p + 1) % nt:
                    bc_r[(p + 1) & 1] = out[p + 1, p + 1]
                    bc_u[(p + 1) & 1] = us[p + 1]
    return out


def _nanmax(a, b):
    return a if np.isnan(a) else (b if np.isnan(b) or b > a else a)


def _model_gmw(a, floors):
    """``gmw_block_kernel`` / ``gmw_grid_kernel``: the transposed working
    matrix, every pivot's column reduced with NaN propagating, row j of S
    written in full, only the trailing block updated."""
    dt = a.dtype.type
    n = a.shape[0]
    delta, beta2 = floors
    w = a.T.copy()
    s = np.empty_like(a)
    with np.errstate(all="ignore"):
        for j in range(n):
            theta = dt(0)
            for i in range(j + 1, n):
                theta = _nanmax(theta, np.abs(w[j, i]))
            dj = _nanmax(_nanmax(np.abs(w[j, j]), (theta * theta) / beta2),
                         delta)
            sq = _sqrt(dj)
            low = np.empty(n, dtype=a.dtype)
            for l in range(n):
                lf = dt(0) / dj if l < j else (dt(1) if l == j
                                               else w[j, l] / dj)
                s[j, l] = sq * lf
                low[l] = lf
            for i in range(j + 1, n):
                w[i, j + 1:] = w[i, j + 1:] - dj * (low[i] * low[j + 1:])
    return s


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    assert same.all(), f"{int((~same).sum())} entries differ"


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", ["random", "pd_loss", "zeros_in_u", "zero"])
def test_rotation_kernel_model_equals_plain(case, dtype):
    """Exact: a thread per column at n = 12 over 4 threads (three columns
    each) and over 16 (idle threads), threads in both orders."""
    r, u = _rotate_case(case, n=12, k=3, seed=4)
    r, u = r.astype(dtype), u.astype(dtype)
    for downdate in (True, False):
        want = (tla.chol_downdate_ref if downdate else tla.chol_update_ref)(
            torch.as_tensor(r), torch.as_tensor(u)).numpy()
        for nt in (4, 16):
            for order in (1, -1):
                got = _model_rank_rotate(r, u, downdate,
                                         1e-12 if downdate else 0.0, nt,
                                         order)
                _bits_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", ["spd", "gram_minus", "indefinite", "zero",
                                  "nonfinite"])
def test_gmw_kernel_model_equals_plain(case, dtype):
    """Exact, NaN where NaN: the entries the kernel leaves out (rows and
    columns a pivot has passed) are never read again by the plain loop."""
    a = _gmw_case(case, n=9, seed=5).astype(dtype)
    floors = tla._gmw_floors(torch.as_tensor(a)).numpy()
    want = tla.gmw_chol_ref(torch.as_tensor(a)).numpy()
    _bits_equal(_model_gmw(a, floors), want)


# -- the wrappers ------------------------------------------------------------


def test_wrappers_on_cpu_take_the_plain_version_and_launch_nothing(
        monkeypatch):
    launched = []
    monkeypatch.setattr(tla, "_launch", lambda *a, **k: launched.append(a))
    r, u = _rotate_case("random", n=9, k=2)
    r, u = torch.as_tensor(r), torch.as_tensor(u)
    assert torch.equal(tla.chol_downdate(r, u), tla.chol_downdate_ref(r, u))
    assert torch.equal(tla.chol_downdate(r, u, eps=1e-3),
                       tla.chol_downdate_ref(r, u, 1e-3))
    assert torch.equal(tla.chol_update(r, u[0]), tla.chol_update_ref(r, u[0]))
    assert torch.equal(tla.rank_rotate(r, u, True, 1e-12),
                       tla.chol_downdate_ref(r, u))
    a = torch.as_tensor(_gmw_case("gram_minus", n=9))
    assert torch.equal(tla.gmw_chol(a), tla.gmw_chol_ref(a))
    assert launched == []


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The checks the CUDA branch makes before a launch, called directly
    (no card here): float32 or float64, one device and dtype; and the
    shapes and devices, which every branch checks."""
    r = torch.eye(5, dtype=torch.float64)
    u = torch.ones(2, 5, dtype=torch.float64)
    tla._check_kernel_args("rank_rotate", r, u)
    tla._check_kernel_args("rank_rotate", r.float(), u.float())
    with pytest.raises(TypeError, match="float32 or float64"):
        tla._check_kernel_args("gmw_chol", r.half())
    with pytest.raises(TypeError, match="wants torch.float64"):
        tla._check_kernel_args("rank_rotate", r, u.float())
    with pytest.raises(ValueError, match="shapes"):
        tla.rank_rotate(r, u[:, :4], True)
    with pytest.raises(ValueError, match="shapes"):
        tla.rank_rotate(r[:4], u, False)
    with pytest.raises(ValueError, match="square"):
        tla.gmw_chol(u)
    with pytest.raises(ValueError, match="no kernel for meta"):
        tla.rank_rotate(r.to("meta"), u.to("meta"), True)
    with pytest.raises(ValueError, match="no kernel for meta"):
        tla.gmw_chol(r.to("meta"))
