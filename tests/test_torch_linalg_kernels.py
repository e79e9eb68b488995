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
  the k rows of U as one wavefront, a thread's columns strided, u[p] by a
  shuffle in one warp or through two slots and a barrier in more, R's rows
  all in shared memory or in a ring filled by delayed ``cp.async`` copies,
  and the wide kernel above n = 4096; ``gmw_chol``: A's packed lower
  triangle, the floors from the kernel's maxima, warp 0 taking the next
  pivot while the others update, and the panel-deferred grid), against the
  plain versions: bit for bit, float32 and float64; the floors against
  ``_gmw_floors``; the launchers' routes, from a copy of their rules with
  the shared-memory limit a parameter.
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

#: the launchers' rules (``linalg_kernels.cu``), copied for the models: the
#: shared memory of one block on sm_90, rank_rotate's one-warp limit, its
#: chain of 16 warps and at most 8 register columns a thread above, then
#: the wide kernel's 1024 threads; gmw_chol's panel
_SMEM = 232448
_ROTATE_ONE_WARP_MAX_N = 256
_ROTATE_WARPS = 16
_ROTATE_MAX_NS = 8
_WIDE_THREADS = 1024
_GMW_PANEL = 8


def _sqrt(x):
    """torch's square root of one number, in its dtype."""
    return torch.sqrt(torch.as_tensor(x)).numpy()[()]


def _nanmax(a, b):
    return a if np.isnan(a) else (b if np.isnan(b) or b > a else a)


def _vmax(v, start):
    """``start`` folded with every entry of ``v`` by :func:`_nanmax` (a
    warp's reduction: any NaN gives NaN, else the largest)."""
    v = np.asarray(v)
    if np.isnan(start) or np.isnan(v).any():
        return v.dtype.type(np.nan)
    return max(start, v.max()) if v.size else start


def _cols_per_thread(n, nt):
    """The kernel's NS: columns a thread of ``nt`` owns, a power of two."""
    ns = 1
    while ns < _ROTATE_MAX_NS and ns * nt < n:
        ns *= 2
    return ns


def _rotate_route(n):
    """``launch_rank_rotate``'s route: the chain's threads of the
    wavefront kernel, or None where a thread would own more than
    ``_ROTATE_MAX_NS`` columns (the wide kernel, one row of U a launch)."""
    nt = 32 * (1 if n <= _ROTATE_ONE_WARP_MAX_N else _ROTATE_WARPS)
    return nt if _ROTATE_MAX_NS * nt >= n else None


def _rotate_rows(n, kg, itemsize, nt, smem=_SMEM):
    """``launch_rotate_group``'s rows of R in shared memory (stride NS
    threads, beside diag, the slots and the spare row): all n where they
    fit, else a ring of at most 8 that holds a row ahead of the wavefront;
    None where not even that fits."""
    ld = _cols_per_thread(n, nt) * nt
    avail = smem // itemsize - (n + 2 * kg + ld)
    if avail >= n * ld:
        return n
    rows = min(8, avail // ld)
    return rows if rows > kg else None


class _AsyncCopies:
    """One thread's ``cp.async`` groups: a copy lands only when a wait
    lets it (``wait(k)``: all but the newest k groups)."""

    def __init__(self):
        self.groups, self.open = [], []

    def copy(self, dst, i, value):
        self.open.append((dst, i, value))

    def commit(self):
        self.groups.append(self.open)
        self.open = []

    def wait(self, k):
        while len(self.groups) > k:
            for dst, i, value in self.groups.pop(0):
                dst[i] = value


def _rotation(rkk, uk, downdate, eps):
    """One step's (rotate, rho, c, s) from the pivot and u[p], as the
    kernels take it (no rotation where uk == 0 or the downdate loses
    positive definiteness)."""
    dt = type(rkk)
    if downdate:
        t2 = rkk * rkk - uk * uk
        fl = (eps * rkk) * rkk
        pd_ok = t2 >= fl
        rho = _sqrt(_nanmax(t2, fl))
    else:
        pd_ok = True
        rho = _sqrt(rkk * rkk + uk * uk)
    inv = dt(0) if rho == 0 else dt(1) / rho
    return bool(uk != 0 and pd_ok), rho, rkk * inv, uk * inv


def _model_rotate_group(src, u, out, downdate, eps, nt, order, rows):
    """``rank_rotate_kernel``'s chain block, thread by thread, for the K
    rows of ``u`` (K <= 4) as one wavefront: ``nt`` threads (32: one warp,
    u_q[p] by a shuffle; more: through two shared slots and a barrier an
    interval), thread t owning columns t + s nt; R's rows (stride NS nt) in
    a NaN-filled shared array, all n loaded once when ``rows`` == n, else a
    ring of ``rows`` filled by delayed copies; the steps of an interval
    outside [0, n) write into a spare row. An interval takes every step's
    rho, c and s, then every update, writing back the old value where a
    select keeps it. Between barriers the threads of a block of more than
    one warp run one after another in ``order`` (1 or -1), so a value read
    in the interval another thread writes it shows as a difference between
    the orders."""
    dt = src.dtype.type
    n, K = src.shape[0], u.shape[0]
    ns = _cols_per_thread(n, nt)
    ld = ns * nt
    eps = dt(eps)
    one_warp = nt == 32
    whole = rows >= n
    ahead = rows - K
    cols = [[t + s * nt for s in range(ns)] for t in range(nt)]
    uu = [[[u[q, j] if j < n else dt(0) for j in cols[t]] for q in range(K)]
          for t in range(nt)]
    diag = np.array([src[j, j] for j in range(n)], dtype=src.dtype)
    rs = np.full((rows + 1) * ld, np.nan, dtype=src.dtype)
    spare = rows * ld
    copies = [_AsyncCopies() for _ in range(nt)]
    bc = np.full(2 * K, np.nan, dtype=src.dtype)
    dcar = [[dt(0)] * K for _ in range(nt)]

    def fetch(t, row, slot):
        if row < n:
            for j in cols[t]:
                if row <= j < n:
                    copies[t].copy(rs, slot * ld + j, src[row, j])
        copies[t].commit()

    for t in range(nt):
        for r in range(n if whole else ahead):
            fetch(t, r, r)
        if whole:
            copies[t].wait(0)
    if not one_warp:
        bc[0] = uu[0][0][0]

    def steps(t, tt, slot, uk_of):
        """Every row's step at interval tt as thread t takes it: (row
        base, go, c, s, new pivot) for each q."""
        out_ = []
        for q in range(K):
            p = tt - q
            valid = 0 <= p < n
            pc = min(max(p, 0), n - 1)
            base = (pc if whole else (slot - q) % rows) * ld if valid \
                else spare
            rkk = diag[pc] if q == 0 else dcar[t][q - 1]
            rot, rho, c, sn = _rotation(rkk, uk_of(q, pc), downdate, eps)
            out_.append((p, base, valid and rot, c, sn, rho if rot else rkk))
        return out_

    def update(t, tt, st):
        for q, (p, base, go, c, sn, _) in enumerate(st):
            for s, j in enumerate(cols[t]):
                rk, uj = rs[base + j], uu[t][q][s]
                nr = c * rk - sn * uj if downdate else c * rk + sn * uj
                nu = c * uj - sn * rk
                sel = go and j > p
                rs[base + j] = nr if sel else rk
                uu[t][q][s] = nu if sel else uj
            if not one_warp and 0 <= p + 1 < n:
                for s, j in enumerate(cols[t]):
                    if j == p + 1:
                        bc[((tt + 1) & 1) * K + q] = uu[t][q][s]
        pf = tt - (K - 1)
        if 0 <= pf < n:
            base = st[K - 1][1]
            for j in cols[t]:
                if j == pf:
                    rs[base + j] = st[K - 1][5]
                if not whole and pf <= j < n:
                    out[pf, j] = rs[base + j]
        dcar[t] = [x[5] for x in st]

    slot = 0
    threads = list(range(nt))[::order]
    with np.errstate(all="ignore"):
        for tt in range(n + K - 1):
            if not whole:
                for t in threads:
                    fetch(t, tt + ahead, (slot + ahead) % rows)
                    copies[t].wait(ahead)
            if one_warp:
                # lock step: every lane's steps (the shuffles read the
                # owners' registers before any update), then the updates
                def shuffled(q, pc):
                    owner = pc & 31
                    return next(uu[owner][q][s] for s, j in
                                enumerate(cols[owner]) if j == pc)

                sts = [steps(t, tt, slot, shuffled) for t in range(nt)]
                for t in threads:
                    update(t, tt, sts[t])
            else:
                for t in threads:   # one thread at a time, then the barrier
                    update(t, tt, steps(
                        t, tt, slot, lambda q, pc: bc[(tt & 1) * K + q]))
            if not whole:
                slot = (slot + 1) % rows
    if whole:
        for p in range(n):
            out[p, p:] = rs[p * ld + p:p * ld + n]


def _model_rotate_wide(src, u, out, downdate, eps, nt, order):
    """``rank_rotate_wide_kernel`` for one row ``u`` of U: ``nt`` threads,
    thread t owning columns t + s nt, U's row in a NaN-filled workspace,
    row p of R read from ``src`` and written to ``out`` at step p (``src``
    is ``out`` from the second row on), u[p + 1] through two slots, the new
    pivot after the step's barrier. Between barriers the threads run one
    after another in ``order``."""
    n = src.shape[0]
    eps = src.dtype.type(eps)
    uw = np.full(n, np.nan, dtype=src.dtype)
    bc = np.full(2, np.nan, dtype=src.dtype)
    threads = list(range(nt))[::order]
    for t in threads:
        uw[t::nt] = u[t::nt]
    bc[0] = u[0]
    with np.errstate(all="ignore"):
        for p in range(n):
            for t in threads:
                rkk = src[p, p]
                go, rho, c, sn = _rotation(rkk, bc[p & 1], downdate, eps)
                for j in range(t, n, nt):
                    if j <= p:
                        continue
                    r0, uj = src[p, j], uw[j]
                    nr = c * r0 - sn * uj if downdate else c * r0 + sn * uj
                    nu = c * uj - sn * r0
                    out[p, j] = nr if go else r0
                    if go:
                        uw[j] = nu
                    if j == p + 1:
                        bc[(p + 1) & 1] = nu if go else uj
                if t == p % nt:
                    pivot = rho if go else rkk
            out[p, p] = pivot   # after the barrier


def _model_rank_rotate(r, u, downdate, eps, nt, order=1, rows=None,
                       wide=False):
    """``launch_rank_rotate``: the lower triangle by the copy blocks, then
    U's rows in groups of up to four, one wavefront each (the first from
    ``r``, the next in place on ``out``); ``wide``: the wide kernel of
    ``nt`` threads instead, one row a launch. ``rows``: R's rows in
    shared memory (default: as the launcher sizes them, ``_rotate_rows``).
    ``out`` starts as NaN, so an entry no thread writes shows."""
    n = r.shape[0]
    u = np.atleast_2d(u)
    out = np.full_like(r, np.nan)
    low = np.tril_indices(n, -1)
    out[low] = r[low]
    if wide:
        for g in range(u.shape[0]):
            _model_rotate_wide(r if g == 0 else out, u[g], out, downdate,
                               eps, nt, order)
        return out
    for g in range(0, u.shape[0], 4):
        ug = u[g:g + 4]
        rg = rows or _rotate_rows(n, ug.shape[0], r.itemsize, nt)
        _model_rotate_group(r if g == 0 else out, ug, out, downdate, eps, nt,
                            order, min(rg, n))
    return out


def _packed_col(l, n):
    return l * n - l * (l - 1) // 2


def _model_floors(a, recip):
    """The kernels' floors from their two maxima (``gmw_floors``): gmax =
    max |A_ii|, xmax = max |A - diag(A_ii)| with inf - inf = NaN on the
    diagonal; the divisor of xi by a product with its reciprocal
    (``recip``: torch's CUDA route for a Python scalar divisor) or a
    quotient (its CPU route)."""
    dt = a.dtype.type
    n = a.shape[0]
    eps = dt(np.finfo(a.dtype).eps)

    def clamp(x, lo):
        return x if np.isnan(x) else (x if x > lo else dt(lo))

    with np.errstate(all="ignore"):
        d = np.diag(a)
        off = a.copy()
        off[np.diag_indices(n)] = d - d
        gmax = _vmax(np.abs(d), dt(0))
        xmax = _vmax(np.abs(off), dt(0))
        gamma = clamp(gmax, eps)
        xi = clamp(xmax, eps) if n > 1 else eps
        delta = eps * clamp(gamma + xi, dt(1))
        c = dt(max(float(n * n - 1.0) ** 0.5, 1.0))
        t = xi * (dt(1) / c) if recip else xi / c
        beta2 = clamp(_nanmax(gamma, t), eps)
    return np.array([delta, beta2], dtype=a.dtype)


def _model_gmw_block(a, nt, order=1, recip=False):
    """``gmw_block_kernel``: A's lower triangle packed by columns in a
    NaN-filled shared array, the floors from the kernel's maxima, two
    NaN-filled buffers of lows. Pivot 0 by warp 0 first; then each pivot j
    with one barrier: warp 0 brings column j + 1 through pivot j into the
    other buffer and takes pivot j + 1 from it (theta, dj, low, row j + 1 of
    S), while warps 1 .. bring columns j + 2 .. through pivot j, in blocks
    of four columns taken in turn (warp 0 before or after them:
    ``order``)."""
    dt = a.dtype.type
    n = a.shape[0]
    nw = nt // 32
    w = np.full(n * (n + 1) // 2, np.nan, dtype=a.dtype)
    lows = np.full((2, n), np.nan, dtype=a.dtype)
    djs = np.full(2, np.nan, dtype=a.dtype)
    s = np.full_like(a, np.nan)
    for l in range(n):
        w[_packed_col(l, n):_packed_col(l, n) + n - l] = a[l:, l]
    delta, beta2 = _model_floors(a, recip)

    def take_pivot(jn, lo, theta, cjj):
        dj = _nanmax(_nanmax(np.abs(cjj), (theta * theta) / beta2), delta)
        sq = _sqrt(dj)
        z = dt(0) if dj == dj else dj
        lo[jn + 1:] = lo[jn + 1:] / dj
        s[jn, jn + 1:] = sq * lo[jn + 1:]
        s[jn, :jn] = sq * z
        s[jn, jn] = sq
        djs[jn & 1] = dj

    def warp0(j):
        l = j + 1
        if l >= n:
            return
        c0 = _packed_col(l, n)
        lo, ln = lows[j & 1], lows[l & 1]
        ln[l:] = w[c0:c0 + n - l] - djs[j & 1] * (lo[l:] * lo[l])
        take_pivot(l, ln, _vmax(np.abs(ln[l + 1:]), dt(0)), ln[l])

    def others(j):
        lo, dj = lows[j & 1], djs[j & 1]
        first = j + 2
        for warp in range(1, nw)[::order]:
            for cb in range(first // 4 + warp - 1, -(-n // 4), nw - 1):
                for l in range(max(4 * cb, first), min(4 * cb + 4, n)):
                    c0 = _packed_col(l, n)
                    w[c0:c0 + n - l] = w[c0:c0 + n - l] - dj * (
                        lo[l:] * lo[l])

    with np.errstate(all="ignore"):
        lows[0] = w[:n]
        take_pivot(0, lows[0], _vmax(np.abs(w[1:n]), dt(0)), w[0])
        for j in range(n):
            for part in ((warp0, others) if order == 1 else (others, warp0)):
                part(j)
    return s


def _tile(k):
    """``gmw_grid_kernel``'s tile k of the trailing lower triangle: (row
    block, column block), from a float32 square root and two corrections."""
    rb = int((np.sqrt(np.float32(8 * k + 1)) - np.float32(1))
             * np.float32(0.5))
    while rb * (rb + 1) // 2 > k:
        rb -= 1
    while (rb + 1) * (rb + 2) // 2 <= k:
        rb += 1
    return rb, k - rb * (rb + 1) // 2


def _model_gmw_grid(a, B, blocks=3, order=1, tile=64, recip=False):
    """``gmw_grid_kernel``'s phases: 0, A's lower triangle into W (NaN
    elsewhere) and the floors; 1, block 0 factors panel 0 from A; 2 + p,
    block 0 brings panel p + 1's columns through panel p's B updates into
    its shared panel and factors it while blocks 1 .. ``blocks`` - 1 bring
    the columns past it through the same updates in W, ``tile`` x ``tile``
    tiles in turn (block 0 before or after them: ``order``). The lows and
    djs of a panel go to one of two NaN-filled buffers."""
    dt = a.dtype.type
    n = a.shape[0]
    W = np.full((n, n), np.nan, dtype=a.dtype)
    tri = np.tril_indices(n)
    W[tri] = a[tri]
    lows = np.full((2, B, n), np.nan, dtype=a.dtype)
    djs = np.full((2, B), np.nan, dtype=a.dtype)
    pan = np.full(B * n, np.nan, dtype=a.dtype)
    s = np.full_like(a, np.nan)
    delta, beta2 = _model_floors(a, recip)
    P = -(-n // B)

    def load(cols, c1, bq, p):
        prow = n - c1
        theta = None
        for q in range(bq):
            l = c1 + q
            v = cols[l:, l].copy()
            if p is not None:
                b = p & 1
                for qq in range(B):
                    v = v - djs[b, qq] * (lows[b, qq, l:] * lows[b, qq, l])
            pan[q * prow + q:q * prow + prow] = v
            if q == 0:
                theta = _vmax(np.abs(v[1:]), dt(0))
        return theta

    def factor(c1, bq, theta, buf):
        prow = n - c1
        for q in range(bq):
            j = c1 + q
            cq = q * prow
            dj = _nanmax(_nanmax(np.abs(pan[cq + q]),
                                 (theta * theta) / beta2), delta)
            sq, z = _sqrt(dj), dt(0) / dj
            djs[buf, q] = dj
            s[j, :j] = sq * z
            s[j, j] = sq
            lf = pan[cq + q + 1:cq + prow] / dj
            pan[cq + q + 1:cq + prow] = lf
            lows[buf, q, j + 1:] = lf
            s[j, j + 1:] = sq * lf
            for q2 in range(q + 1, bq):
                c2 = q2 * prow
                v = pan[c2 + q2:c2 + prow] - dj * (
                    pan[cq + q2:cq + prow] * pan[cq + q2])
                pan[c2 + q2:c2 + prow] = v
                if q2 == q + 1:
                    theta = _vmax(np.abs(v[1:]), dt(0))

    def trailing(p):
        c2 = (p + 2) * B
        if c2 >= n:
            return
        b = p & 1
        nb = -(-(n - c2) // tile)
        tiles = nb * (nb + 1) // 2
        for blk in range(1, blocks):
            for k in range(blk - 1, tiles, blocks - 1):
                rb, cb = _tile(k)
                for i in range(c2 + tile * rb, min(c2 + tile * rb + tile, n)):
                    l0, l1 = c2 + tile * cb, min(c2 + tile * cb + tile, i + 1)
                    if l1 <= l0:
                        continue
                    v = W[i, l0:l1]
                    for qq in range(B):
                        v = v - djs[b, qq] * (lows[b, qq, i]
                                              * lows[b, qq, l0:l1])
                    W[i, l0:l1] = v

    with np.errstate(all="ignore"):
        bq = min(B, n)
        factor(0, bq, load(a, 0, bq, None), 0)
        for p in range(P - 1):
            c1 = (p + 1) * B
            bq = min(B, n - c1)

            def panel():
                factor(c1, bq, load(W, c1, bq, p), (p + 1) & 1)

            for part in ((panel, lambda: trailing(p)) if order == 1
                         else (lambda: trailing(p), panel)):
                part()
    return s


def _gmw_route(n, itemsize, smem=_SMEM):
    """``launch_gmw``'s route: ("block", threads) where the packed lower
    triangle, two columns of lows and 66 slots fit ``smem`` (threads: a
    warp per eight columns, 2 to 32 warps); else ("grid", where block 0's
    panel lives: "shared" where 8 columns, 64 slots and 8 x 8 lows fit,
    else "global", the workspace)."""
    if (n * (n + 1) // 2 + 2 * n + 66) * itemsize <= smem:
        return "block", 32 * min(32, max(2, -(-n // 8)))
    b = _GMW_PANEL
    return "grid", ("shared" if (b * n + 64 + b * b) * itemsize <= smem
                    else "global")


def _model_gmw(a, smem=_SMEM, order=1, recip=False):
    """The launcher's route at a shared-memory limit ``smem``
    (:func:`_gmw_route`; the panel's place does not change the grid's
    arithmetic): one block or the grid (``tile`` 4, so that a small n spans
    several tiles)."""
    route, arg = _gmw_route(a.shape[0], a.itemsize, smem)
    if route == "block":
        return _model_gmw_block(a, arg, order, recip)
    return _model_gmw_grid(a, _GMW_PANEL, order=order, tile=4, recip=recip)


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    assert same.all(), f"{int((~same).sum())} entries differ"


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", ["random", "pd_loss", "zeros_in_u", "zero"])
def test_rotation_kernel_model_equals_plain(case, dtype):
    """Exact: the wavefront of k = 3 rows at n = 37 (not a multiple of 32)
    in one warp (two columns a lane, the shuffle) and in two (a column a
    thread, the slots and a barrier), and the wide kernel of 8 threads
    (five columns a thread, one row a launch, in place from the second),
    threads in both orders."""
    r, u = _rotate_case(case, n=37, k=3, seed=4)
    r, u = r.astype(dtype), u.astype(dtype)
    for downdate in (True, False):
        want = (tla.chol_downdate_ref if downdate else tla.chol_update_ref)(
            torch.as_tensor(r), torch.as_tensor(u)).numpy()
        for nt, wide in ((32, False), (64, False), (8, True)):
            for order in (1, -1):
                got = _model_rank_rotate(r, u, downdate,
                                         1e-12 if downdate else 0.0, nt,
                                         order, wide=wide)
                _bits_equal(got, want)


@pytest.mark.parametrize("k", [1, 2, 3, 5])
@pytest.mark.parametrize("rows", ["all", "deep", "shallow"])
def test_rotation_wavefront_rows_and_ring(k, rows):
    """Exact at k = 1, 2, 3 (one wavefront) and 5 (four, then one in place
    on the output), R's rows all in shared memory, in a ring of eight
    (seven fetched ahead at k = 1) or in a ring one row ahead of the
    wavefront, one warp and three (n = 45: two columns a lane, one a
    thread)."""
    r, u = _rotate_case("pd_loss", n=45, k=k, seed=7)
    u[:, 5] = 0.0
    want = tla.chol_downdate_ref(torch.as_tensor(r),
                                 torch.as_tensor(u)).numpy()
    ring = {"all": 45, "deep": 8, "shallow": min(k, 4) + 1}[rows]
    for nt in (32, 96):
        _bits_equal(_model_rank_rotate(r, u, True, 1e-12, nt, -1, ring),
                    want)


def test_rotation_rows_and_warps():
    """All rows of R in shared memory at the main paths' n = 196 (float32)
    and 100 (float64); a ring of eight at n = 196 in float64 and at n =
    580, of five at config 3's n = 3460 in float64 (and at n = 4096 with
    four rows of U), none where not one row fits ahead; one warp up to n =
    256, else 16, each thread owning at most 8 columns; above n = 4096 the
    wide kernel, at any n."""
    nt = _rotate_route
    assert _rotate_rows(196, 2, 4, nt(196)) == 196
    assert _rotate_rows(100, 2, 8, nt(100)) == 100
    assert _rotate_rows(196, 2, 8, nt(196)) == 8
    assert _rotate_rows(580, 2, 4, nt(580)) == 8
    assert _rotate_rows(3460, 1, 8, nt(3460)) == 5
    assert _rotate_rows(4096, 4, 8, nt(4096)) == 5
    assert _rotate_rows(3460, 4, 8, 512, smem=150000) is None
    assert [nt(n) for n in (16, 196, 256, 257, 580, 3460, 4096, 4097,
                            100000)] == [32] * 3 + [512] * 4 + [None] * 2
    r, u = _rotate_case("pd_loss", n=70, k=2, seed=8)
    want = tla.chol_downdate_ref(torch.as_tensor(r),
                                 torch.as_tensor(u)).numpy()
    _bits_equal(_model_rank_rotate(r, u, True, 1e-12, 32, wide=True), want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", ["spd", "gram_minus", "indefinite", "zero",
                                  "nonfinite"])
def test_gmw_kernel_model_equals_plain(case, dtype):
    """Exact, NaN where NaN, at n = 37: the one block (two warps, both
    orders) and the panel-deferred grid (panels of 8, the last of 5;
    tiles of 4), each with its own floors."""
    a = _gmw_case(case, n=37, seed=5).astype(dtype)
    want = tla.gmw_chol_ref(torch.as_tensor(a)).numpy()
    for order in (1, -1):
        _bits_equal(_model_gmw_block(a, 64, order), want)
        _bits_equal(_model_gmw_grid(a, 8, order=order, tile=4), want)


def _floors_case(case, dtype):
    if case == "n1":
        return (np.array([[np.nan]], dtype=dtype),
                np.array([[4.0]], dtype=dtype))
    if case == "n2":
        return (np.array([[2.0, np.inf], [0.5, 3.0]], dtype=dtype),
                np.array([[2.0, 0.75], [0.5, 3.0]], dtype=dtype))
    return (_gmw_case(case, n=11, seed=9).astype(dtype),
            _gmw_case(case, n=12, seed=10).astype(dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", ["nonfinite", "zero", "indefinite", "n1",
                                  "n2"])
def test_gmw_floors_in_kernel(case, dtype):
    """The kernels' floors, from their two block maxima, bit for bit
    ``_gmw_floors`` on the CPU (NaN where a diagonal entry is not finite,
    eps at n = 1), and both routes' S with them; the card's form (xi times
    the reciprocal of the divisor) gives the same delta and beta^2 within
    one unit in the last place. That the card's form is torch's on the
    card is held by the smoke."""
    for a in _floors_case(case, dtype):
        want = tla._gmw_floors(torch.as_tensor(a)).numpy()
        _bits_equal(_model_floors(a, recip=False), want)
        card = _model_floors(a, recip=True)
        _bits_equal(card[0], want[0])
        assert np.isfinite(card[1]) == np.isfinite(want[1])
        if np.isfinite(want[1]):
            assert abs(card[1] - want[1]) <= np.spacing(want[1])
        s = tla.gmw_chol_ref(torch.as_tensor(a)).numpy()
        _bits_equal(_model_gmw_block(a, 64), s)
        _bits_equal(_model_gmw_grid(a, _GMW_PANEL, tile=4), s)


@pytest.mark.parametrize("where", ["block", "shared", "global"])
@pytest.mark.parametrize("case", ["gram_minus", "nonfinite"])
def test_gmw_routes_at_a_shared_memory_limit(case, where):
    """With the limit a parameter, a small n takes every route: at n = 21
    the one block where the triangle fits, else the grid (panels of 8, 8
    and 5) with its panel in shared memory or, where that does not fit
    either, in the workspace; blocks in both orders and three or five
    blocks; every one bit for bit the plain version."""
    a = _gmw_case(case, n=21, seed=3)
    want = tla.gmw_chol_ref(torch.as_tensor(a)).numpy()
    smem = {"block": _SMEM, "shared": 2400, "global": 2000}[where]
    route = _gmw_route(21, a.itemsize, smem)
    assert route == (("block", 96) if where == "block" else ("grid", where))
    for order in (1, -1):
        _bits_equal(_model_gmw(a, smem, order), want)
        _bits_equal(_model_gmw_grid(a, _GMW_PANEL, blocks=5, order=order,
                                    tile=4), want)


def test_gmw_route_limits():
    """The one-block route's limit follows the dtype (n = 338 in float32,
    238 in float64), the grid's panel leaves shared memory above n = 7248
    in float32 and 3616 in float64 (config 3's n = 3460 keeps it there in
    both), and no n is refused; the block size follows n; the grid's tiles
    cover the trailing triangle once."""
    assert _gmw_route(338, 4)[0] == "block" != _gmw_route(339, 4)[0]
    assert _gmw_route(238, 8)[0] == "block" != _gmw_route(239, 8)[0]
    assert _gmw_route(196, 8)[0] == "block" != _gmw_route(388, 4)[0]
    assert _gmw_route(3460, 4) == _gmw_route(3460, 8) == ("grid", "shared")
    assert _gmw_route(7248, 4) == _gmw_route(3616, 8) == ("grid", "shared")
    assert _gmw_route(7249, 4) == _gmw_route(3617, 8) == ("grid", "global")
    assert _gmw_route(50000, 8) == ("grid", "global")
    assert [_gmw_route(n, 4)[1] for n in (2, 100, 196, 338)] == [
        64, 416, 800, 1024]
    for k in range(200):
        rb, cb = _tile(k)
        assert 0 <= cb <= rb and rb * (rb + 1) // 2 + cb == k


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
