"""Square-root linear algebra on torch tensors.

Dense products and factorizations the JAX package leaves to XLA: here they go
to ``torch.matmul``/``torch.linalg`` (cuBLAS/cuSOLVER on the card). Float32
products on the card run in full FP32: nothing in this package enables TF32,
which keeps about three decimal digits and makes covariance Grams
indefinite.

``torch.linalg.cholesky`` raises on a non-PD input, where JAX's returns NaN;
the repair ladder below keys off the factorization's ``info`` and fills a
failed factor with NaN as JAX does, so callers see JAX's failure
semantics. On the card the factorization is cuSOLVER's potrf called with a
handle of its own per stream (``_potrf_upper``), the call
``torch.linalg.cholesky_ex`` makes, so that a captured CUDA graph can hold
it inside a conditional node; on the CPU it is ``cholesky_ex``.

The two recurrences the JAX package runs as ``lax.scan`` loops, the
rotation sweep of :func:`chol_update` / :func:`chol_downdate` and the
modified Cholesky :func:`gmw_chol`, are hand-written CUDA kernels on the
card (``csrc/linalg_kernels.cu``), bit for bit their plain versions
(``*_ref``), which CPU tensors take.
"""

from __future__ import annotations

import contextvars
import ctypes

import torch

from . import control

#: ``(mesh, shard_sqrt)`` made ambient by ``parallel.mesh.set_mesh``: the
#: mesh the joint update factorizes across (``cfg.dist_chol_panel > 0``),
#: and whether :func:`gram_rows` sums S's row blocks across it. The filter
#: reads it here, so it never imports the multi-device package.
AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "ambient_mesh", default=(None, False))


def gram(a: torch.Tensor) -> torch.Tensor:
    """A^T A at full precision of ``a``'s dtype."""
    return a.T @ a


def gram_rows(a: torch.Tensor, b: torch.Tensor | None = None
              ) -> torch.Tensor:
    """``a^T b`` (``a^T a`` without ``b``): a contraction over the rows,
    which are S's rows at the call sites. On one device this is the local
    product, as :func:`gram`. Under a mesh made ambient with
    ``shard_sqrt=True`` each rank multiplies only its block of rows and
    one ``all_reduce`` sums the blocks (JAX's psum of local Grams)."""
    b = a if b is None else b
    mesh, shard_sqrt = AMBIENT.get()
    if not shard_sqrt:
        return a.T @ b
    lo, hi = mesh.block(a.shape[0])
    return mesh.all_reduce(a[lo:hi].T @ b[lo:hi])


# cuSOLVER's potrf through a handle of our own for each stream. PyTorch's
# one handle per thread moves between streams; inside a CUDA graph capture,
# a factorization large enough for cuSOLVER to call cuBLAS (config 3's) on
# a stream other than the one the handle last ran on makes cuSOLVER's
# internal cuBLAS allocate stream-ordered memory, which a conditional body
# cannot hold (graph instantiation fails). A handle that never leaves its
# stream does not. Same call as ``torch.linalg.cholesky_ex`` makes
# (cusolverDnXpotrf, default params), so the same bits.
_CUSOLVER = None
_HANDLES: dict = {}
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_CUDA_R = {torch.float32: 0, torch.float64: 1}       # cudaDataType
_UPPER = 1                                            # CUBLAS_FILL_MODE_UPPER


def _cusolver():
    global _CUSOLVER
    if _CUSOLVER is None:
        if control.capturing() is not None:
            raise RuntimeError("cuSOLVER first loaded inside a CUDA graph "
                               "capture")
        # the library PyTorch loaded (its linear algebra loads it lazily)
        torch.linalg.cholesky_ex(torch.ones((1, 1), device="cuda"))
        path = "libcusolver.so.11"
        with open("/proc/self/maps") as maps:
            for line in maps:
                if "libcusolver.so" in line:
                    path = line.split()[-1]
                    break
        lib = ctypes.CDLL(path)
        lib.cusolverDnCreate.argtypes = [ctypes.POINTER(_P)]
        lib.cusolverDnSetStream.argtypes = [_P, _P]
        lib.cusolverDnCreateParams.argtypes = [ctypes.POINTER(_P)]
        lib.cusolverDnXpotrf_bufferSize.argtypes = [
            _P, _P, ctypes.c_int, _I64, ctypes.c_int, _P, _I64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t)]
        lib.cusolverDnXpotrf.argtypes = [
            _P, _P, ctypes.c_int, _I64, ctypes.c_int, _P, _I64, ctypes.c_int,
            _P, ctypes.c_size_t, _P, ctypes.c_size_t, _P]
        _CUSOLVER = lib
    return _CUSOLVER


def _cusolver_check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} failed with cuSOLVER status {status}")


def _potrf_upper(sym: torch.Tensor):
    """cusolverDnXpotrf (upper) of the symmetric CUDA matrix ``sym``, in
    place, on the current stream with that stream's own handle. Returns
    (R row-major, info)."""
    lib = _cusolver()
    dev = sym.device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    key = (dev.index, stream)
    if key not in _HANDLES:
        if control.capturing() is not None:
            raise RuntimeError("a cuSOLVER handle first made inside a CUDA "
                               "graph capture")
        h, prm = _P(), _P()
        _cusolver_check(lib.cusolverDnCreate(ctypes.byref(h)), "create")
        _cusolver_check(lib.cusolverDnSetStream(h, _P(stream)), "set stream")
        _cusolver_check(lib.cusolverDnCreateParams(ctypes.byref(prm)),
                        "create params")
        _HANDLES[key] = (h, prm)
    h, prm = _HANDLES[key]
    n, dt = sym.shape[0], _CUDA_R[sym.dtype]
    dws, hws = ctypes.c_size_t(), ctypes.c_size_t()
    _cusolver_check(lib.cusolverDnXpotrf_bufferSize(
        h, prm, _UPPER, n, dt, _P(sym.data_ptr()), n, dt, ctypes.byref(dws),
        ctypes.byref(hws)), "potrf buffer size")
    if hws.value:
        raise RuntimeError("cusolverDnXpotrf asks for host workspace")
    work = torch.empty(max(dws.value, 1), dtype=torch.uint8, device=dev)
    info = torch.empty((), dtype=torch.int32, device=dev)
    _cusolver_check(lib.cusolverDnXpotrf(
        h, prm, _UPPER, n, dt, _P(sym.data_ptr()), n, dt,
        _P(work.data_ptr()), dws.value, None, 0, _P(info.data_ptr())),
        "potrf")
    # column-major upper factor -> row-major, zero below the diagonal
    return torch.triu(sym.T).contiguous(), info


def chol_upper_ex(sym: torch.Tensor):
    """``torch.linalg.cholesky_ex(sym, upper=True)`` of the symmetric
    ``sym``, safe inside a CUDA graph capture and its conditional bodies:
    (R row-major, info as a 0-d int32 device tensor). On CUDA, cuSOLVER's
    potrf through :func:`_potrf_upper` (``sym`` is overwritten); nothing
    is read back to the host."""
    if sym.is_cuda:
        return _potrf_upper(sym)
    r, info = torch.linalg.cholesky_ex(sym, upper=True)
    # row-major copy: ``upper=True`` may hand back a transposed view, and
    # the products downstream round differently on another layout
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


# ---------------------------------------------------------------------------
# the two recurrences as kernels (csrc/linalg_kernels.cu)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    "cvms_linalg_workspace": [_I, _I, _I, _I, _P],
    "cvms_rank_rotate": [_I, _P, _P, _P, _P, _I, _I, _I, _D, _I, _P, _P],
    "cvms_gmw_chol": [_I, _P, _P, _P, _I, _D, _P, _I, _P, _P],
    "cvms_chain_latency": [_I, _I, _I, _P, _P],
}
_KERNEL = {"rank_rotate": 0, "gmw_chol": 1}


def _check_kernel_args(name: str, *tensors: torch.Tensor) -> None:
    """What the CUDA kernels take: float32 or float64, every tensor on one
    device in one dtype (checked by the wrappers before a launch)."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: the kernel takes float32 or float64, got "
                        f"{dtype}")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise TypeError(f"{name}: wants {dtype} on {dev}, got "
                            f"{t.dtype} on {t.device}")


def _lib():
    from . import _build

    return _build.load(_SIGNATURES, "linalg_kernels")


def _launch(name: str, fn: str, dev: torch.device, *args) -> None:
    """Entry point ``fn(*args, stream)`` of ``linalg_kernels`` on ``dev``'s
    current stream (:func:`_build.launch`)."""
    from . import _build

    _build.launch(_lib(), fn, name, dev, *args)


def _workspace(name: str, like: torch.Tensor, route: int):
    """The device workspace that kernel ``name`` asks for at ``like``'s
    width, dtype and ``route`` (``cvms_linalg_workspace``: the launcher
    chooses every route), or None where it needs none."""
    elems = ctypes.c_longlong(0)
    err = _lib().cvms_linalg_workspace(
        int(like.dtype == torch.float64), _KERNEL[name], like.shape[0], route,
        ctypes.addressof(elems))
    if err:
        raise RuntimeError(f"{name}: workspace query failed ({err})")
    if not elems.value:
        return None
    return torch.empty(elems.value, dtype=like.dtype, device=like.device)


def rank_rotate(r: torch.Tensor, u: torch.Tensor, downdate: bool,
                eps: float = 0.0) -> torch.Tensor:
    """R' with R'^T R' = R^T R + U^T U (``downdate`` False) or R^T R - U^T U
    (True; a column whose downdate would lose positive definiteness, by
    ``eps``, is skipped). ``r`` (n, n), ``u`` (n,) or (k, n). On CUDA
    tensors ``csrc/linalg_kernels.cu``: the k rows of U as one wavefront
    (row q takes its step p at interval p + q; groups of four above k = 4,
    one launch each), one warp up to n = 256 and 16 above, each thread's
    columns of U in registers and of R in shared memory (all rows where
    they fit, else a ring filled ahead by ``cp.async``); above n = 4096 one
    row of U a launch, U's row in a workspace. Counted on the device once a
    call and bit for bit the plain version. On CPU tensors the plain
    version, :func:`chol_update_ref` / :func:`chol_downdate_ref`."""
    u2 = torch.atleast_2d(u)
    n = r.shape[0]
    if r.shape != (n, n) or u2.dim() != 2 or u2.shape[1] != n:
        raise ValueError(f"rank_rotate: shapes r {tuple(r.shape)}, u "
                         f"{tuple(u.shape)}")
    if r.device.type == "cpu":
        return (chol_downdate_ref(r, u, eps) if downdate
                else chol_update_ref(r, u))
    if r.device.type != "cuda":
        raise ValueError(f"rank_rotate: no kernel for {r.device}")
    _check_kernel_args("rank_rotate", r, u2)
    return _rotate_launch(r.contiguous(), u2.contiguous(), downdate, eps)


def _rotate_launch(r: torch.Tensor, u2: torch.Tensor, downdate: bool,
                   eps: float, route: int = 0) -> torch.Tensor:
    """One call of the kernel on contiguous CUDA tensors ``r`` (n, n) and
    ``u2`` (k, n). ``route`` 0 takes the launcher's route, 1 one row of U a
    launch at any n (the smoke's check of that route at small n)."""
    from . import vision

    n, dev = r.shape[0], r.device
    out = torch.empty_like(r)
    if not (n and u2.shape[0]):
        return out.copy_(r)
    ws = _workspace("rank_rotate", r, route)
    _launch("rank_rotate", "cvms_rank_rotate", dev,
            int(r.dtype == torch.float64), r.data_ptr(), u2.data_ptr(),
            out.data_ptr(), 0 if ws is None else ws.data_ptr(), n,
            u2.shape[0], int(downdate), float(eps), route,
            vision._device_counter(dev, "rank_rotate").data_ptr())
    return out


def chol_update(r: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Rank-k sqrt update: R' with R'^T R' = R^T R + U^T U, U (k, n): the
    rotation sweep of :func:`rank_rotate` (one kernel launch on the card)."""
    return rank_rotate(r, u, downdate=False)


def chol_downdate(r: torch.Tensor, u: torch.Tensor,
                  eps: float = 1e-12) -> torch.Tensor:
    """Rank-k sqrt downdate: R' with R'^T R' = R^T R - U^T U, U (k, n).

    The true hyperbolic-rotation downdate the reference approximates by
    recompose-refactor (SLAM.cpp:2106-2155); PD loss is clamped, not fatal.
    The rotation sweep of :func:`rank_rotate` (one kernel launch on the
    card).
    """
    return rank_rotate(r, u, downdate=True, eps=eps)


def _gmw_launch(a: torch.Tensor, s: torch.Tensor,
                floors: torch.Tensor | None = None, route: int = 0) -> None:
    """One call of the kernel: ``a`` (n, n) contiguous on a CUDA device, S
    into ``s``; the kernel's own floors (delta, beta^2) into ``floors`` when
    given. ``route`` 0 takes the launcher's route, 1 the grid with its
    panel in shared memory where it fits, 2 the grid with its panel in the
    workspace (the smoke's checks of the grid at small n)."""
    from . import vision

    n, dev = a.shape[0], a.device
    ws = _workspace("gmw_chol", a, route)
    # the divisor of beta^2's xi term, as _gmw_floors computes it
    cdiv = max(float(n * n - 1.0) ** 0.5, 1.0)
    _launch("gmw_chol", "cvms_gmw_chol", dev, int(a.dtype == torch.float64),
            a.data_ptr(), s.data_ptr(), 0 if ws is None else ws.data_ptr(),
            n, cdiv, 0 if floors is None else floors.data_ptr(), route,
            vision._device_counter(dev, "gmw_chol").data_ptr())


def gmw_chol(a: torch.Tensor) -> torch.Tensor:
    """Gill-Murray-Wright modified Cholesky: upper-triangular S with
    S^T S = A + E, E a minimal diagonal making A PD — the reference's
    forced-PD refactorization (SLAM.cpp:2197-2327), as a right-looking
    LDL^T loop (one rank-1 trailing update per pivot).

    The pivot floors (delta, beta^2) are the JAX package's, so the
    reference-faithful sequential update (downdate_mode="gmw") reproduces
    the reference's covariance repair. On CUDA tensors one call of
    ``csrc/linalg_kernels.cu``, which computes the floors itself as
    :func:`_gmw_floors` does on the card: where A's lower triangle fits one
    block's shared memory (n <= 338 in float32, 238 in float64), one block
    with the triangle there, one barrier a pivot; above, a cooperative grid
    that factors panels of 8 pivots in one block while the others bring the
    trailing triangle through the previous panel's updates, one
    ``grid.sync()`` a panel. Counted on the device and bit for bit
    :func:`gmw_chol_ref`; on CPU tensors :func:`gmw_chol_ref`.
    """
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError(f"gmw_chol: a square matrix, got {tuple(a.shape)}")
    if a.device.type == "cpu":
        return gmw_chol_ref(a)
    if a.device.type != "cuda":
        raise ValueError(f"gmw_chol: no kernel for {a.device}")
    _check_kernel_args("gmw_chol", a)
    s = torch.empty_like(a, memory_format=torch.contiguous_format)
    if n:
        _gmw_launch(a.contiguous(), s)
    return s
