// Two recurrences of the filter's reference-faithful sequential update for
// Hopper (sm_90a): the rank-k square-root update / downdate by plane
// rotations and the Gill-Murray-Wright modified Cholesky. Plain C
// interface, loaded with ctypes by cv_monoslam_tpu_torch/ops/_build.py;
// each entry point launches on the stream it is given and returns the CUDA
// error of its launch. float32 and float64 (faithful mode runs in float64
// on the card).
//
// Neither replaces a Pallas kernel. Both replace host loops of the port
// that the JAX package runs on the device as lax.scan recurrences
// (cv_monoslam_tpu/ops/linalg.py), so that a captured CUDA graph of a frame
// in update_mode="sequential" holds a few launches per matched landmark:
//
// * rank_rotate: _rank1_rotate scanned over the k rows of U by chol_update
//   (Givens) and chol_downdate (hyperbolic), linalg.py:191-271;
// * gmw_chol: gmw_chol, linalg.py:148-188.
//
// Exactness. Each kernel gives bit for bit what its plain version in
// cv_monoslam_tpu_torch/ops/linalg.py (chol_update_ref, chol_downdate_ref,
// gmw_chol_ref) gives on the card: every product, sum, quotient and square
// root is rounded once, in torch's order (one elementwise kernel per torch
// op), so they are written with the _rn intrinsics, which nvcc never
// contracts into an FMA; maxima propagate NaN as torch.maximum, torch.max
// and torch.clamp do. Each entry of a working matrix keeps its own chain of
// roundings; the designs below only move where it lives and when it is
// updated.
//
// What bounds them on an H100. Neither moves much (rank_rotate: R in, R'
// out, U; gmw_chol: A in, S out) nor does much arithmetic: at n = 196 both
// bounds are under a microsecond. What bounds them is a chain of dependent
// steps: rank_rotate's step p needs the pivot R[p][p] and u[p] the step
// before left; gmw_chol's pivot j needs the column pivot j - 1 left. So each
// design keeps the chain out of device memory and spends as few barriers
// on it as it can:
//
// * rank_rotate: ONE wavefront for all k rows of U (up to four; more go in
//   groups of four, one launch each). At interval t row q of U takes its
//   step p = t - q, so an entry R[p][j] still gets row 0's rotation before
//   row 1's, and n + k - 1 intervals replace k n steps. Thread t of the
//   chain owns the columns j = t (mod threads): it keeps its entries of
//   every row of U in registers and its entries of R's rows in shared
//   memory, all n rows where they fit (loaded once by cp.async, written out
//   once at the end, both by the whole block), else a ring of rows filled
//   ahead by cp.async (each thread copies and reads only its own columns,
//   so the ring needs no barrier). Every thread computes rho, c and s of
//   each step itself, so it also knows the new pivot R[p][p]; the only
//   value that crosses threads is u_q[p], by one __shfl_sync from the owner
//   of column p when the chain is one warp (up to n = 256: no barrier at
//   all), or through a double-buffered shared slot and one barrier an
//   interval for a chain of 16 warps (up to eight columns a thread, n =
//   4096). Wider, one row of U a launch with its row in the workspace and
//   R in place in the output, one barrier a step (rank_rotate_wide_kernel;
//   nothing the port runs is that wide). The lower triangle, which the
//   sweep copies through unchanged, is copied by extra blocks beside the
//   chain's.
// * gmw_chol: pivot j reads A_j[i][j] for i >= j only, and each entry (i, l)
//   with i >= l evolves by its own chain w <- w - dj (low_i low_l) and is
//   never read after pivot l, so the lower triangle of A is the whole
//   working set (A need not be symmetric). Where that triangle fits (n <=
//   338 in float32, 238 in float64) ONE block keeps it packed by columns in
//   shared memory, computes the floors (delta, beta^2) itself as one
//   reduction over A, and runs each pivot with ONE barrier: warp 0 brings
//   column j + 1 through pivot j and takes pivot j + 1 from it (theta, dj,
//   low into the other of two buffers, row j + 1 of S) while the other
//   warps bring columns j + 2 .. through pivot j. Above, a cooperative grid
//   defers the trailing update by panels of kGmwPanel pivots: block 0
//   factors a panel's columns over all their rows (in shared memory where
//   they fit, n <= 7248 in float32 and 3616 in float64, else in the
//   workspace) while the other blocks bring the trailing triangle through
//   the previous panel's updates in one pass, each entry applying them in
//   pivot order in registers (so its roundings are the plain version's);
//   one grid.sync() a panel, not a pivot.
//
// The launchers below choose every route, block size and shared-memory
// layout from n and the dtype; cvms_linalg_workspace says how much device
// workspace a call needs (none on the routes the port's shapes take).
//
// Launch counts: both kernels run inside conditional bodies of a captured
// graph (the per-landmark gate of the sequential update), where the host
// cannot see whether they ran. So thread 0 of block 0 of each call adds one
// to a device counter the wrapper passes in (vision.device_counts reads
// them).
//
// cvms_chain_latency is a measurement aid (chip_smoke.py phase 3c): ONE
// thread runs a step's dependent arithmetic, and nothing else, `steps` times
// in a row; its time is the latency bound of each recurrence.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
// the shared memory one block may hold on sm_90 (227 KB); every kernel here
// takes all of its shared memory dynamically
constexpr int kSmemMax = 232448;
constexpr int kMaxDevices = 64;
constexpr int kRingRows = 8;        // rank_rotate's ring of R's rows, at most
constexpr int kRotateOneWarpMaxN = 256;  // rank_rotate: one warp up to this n
constexpr int kRotateWarps = 16;    // rank_rotate's block above one warp
constexpr int kRotateMaxNs = 8;     // columns a thread keeps in registers
constexpr int kWideThreads = 1024;  // rank_rotate_wide_kernel's block

// rank_rotate's block: the chain's warps, and for a chain of one warp seven
// more that only load R and store R'
__host__ __device__ constexpr int rotate_block(int warps) {
  return warps == 1 ? 256 : warps * 32;
}
constexpr int kGridThreads = 512;  // gmw_chol's cooperative blocks
constexpr int kMaxGridBlocks = 1024;
constexpr int kGmwPanel = 8;  // pivots a panel of gmw_chol's grid defers

// one rounding per operation, as one torch elementwise op rounds
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
// 1 / a correctly rounded: the bits of div_rn(1, a), in fewer steps
__device__ __forceinline__ float rcp_rn(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double rcp_rn(double a) { return __drcp_rn(a); }

template <typename T>
struct Eps;
template <>
struct Eps<float> {
  static constexpr float value = FLT_EPSILON;
};
template <>
struct Eps<double> {
  static constexpr double value = DBL_EPSILON;
};

// torch.maximum / torch.max: a NaN operand gives NaN
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}

// torch.clamp(x, min=lo): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x != x ? x : (x > lo ? x : lo);
}

template <typename T>
__device__ __forceinline__ T warp_nanmax(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nanmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// cp.async of one element into shared memory, and its group bookkeeping
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T))
               : "memory");
}
// cp.async of 16 bytes (both addresses 16-byte aligned)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` of this thread's groups are in flight (the
// count is an immediate of the instruction)
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// The floors of gmw_chol from the reduced maxima, as linalg._gmw_floors
// computes them on the card: gmax = max |A_ii|, xmax = max |A - diag(A_ii)|
// (NaN where a diagonal entry is not finite: inf - inf); cdiv is the plain
// version's Python divisor max(sqrt(n^2 - 1), 1), and torch divides a CUDA
// tensor by a Python scalar as a product with its reciprocal, rounded in the
// tensor's type.
template <typename T>
__device__ __forceinline__ void gmw_floors(T gmax, T xmax, int n, double cdiv,
                                           T* delta, T* beta2) {
  const T eps = Eps<T>::value;
  const T gamma = clamp_min(gmax, eps);
  const T xi = n > 1 ? clamp_min(xmax, eps) : eps;
  *delta = mul_rn(eps, clamp_min(add_rn(gamma, xi), T(1)));
  *beta2 = clamp_min(nanmax(gamma, mul_rn(xi, div_rn(T(1), (T)cdiv))), eps);
}

// one element of A into the two running maxima of gmw_floors
template <typename T>
__device__ __forceinline__ void floors_take(T v, bool diag, T* gmax,
                                            T* xmax) {
  if (diag) {
    *gmax = nanmax(*gmax, fabs(v));
    *xmax = nanmax(*xmax, fabs(sub_rn(v, v)));
  } else {
    *xmax = nanmax(*xmax, fabs(v));
  }
}

// ---------------------------------------------------------------------------
// rank_rotate
//
// out = R, then for each row u of U (k, n), for p = 0 .. n-1 (the plain
// version's _rank1_rotate, rkk = R[p][p], uk = u[p]):
//   downdate: t2 = rkk*rkk - uk*uk; fl = (eps*rkk)*rkk; pd_ok = t2 >= fl;
//             rho = sqrt(max(t2, fl))
//   update:   pd_ok = true; rho = sqrt(rkk*rkk + uk*uk)
//   skip the step when uk == 0 or !pd_ok; else inv = rho == 0 ? 0 : 1/rho,
//   c = rkk*inv, s = uk*inv, R[p][p] = rho and for j > p
//   R[p][j] = c*R[p][j] -/+ s*u[j], u[j] = c*u[j] - s*R[p][j] (old R).
// u[p] itself is dropped after step p; nothing reads it again.
//
// One launch sweeps K rows of U (K <= 4) as a wavefront: at interval t row q
// takes step p = t - q. Row q's step p needs R[p][*] after row q - 1's step
// p (interval t - 1) and u_q after its own step p - 1 (interval t - 1). Row p
// of R is final after row K - 1's step p. An interval first takes the K
// steps' rho, c and s (independent of each other), then every update, with
// selects in place of branches so that the compiler interleaves them.
// Shared memory: rows of R of stride ld = NS x threads (so that no column
// index leaves its row), row p in slot p when all n rows fit (`rows` == n:
// loaded once, written out once at the end) or in slot p % rows of a ring
// filled `rows` - K rows ahead by cp.async; one spare row that the steps
// outside [0, n) of an interval write into; diag (n, R[p][p] before the
// sweep); bc (2 K, the handed-on u_q[p] of a chain of more than one warp).
// Blocks 1.. copy the lower triangle (copy_blocks).
// ---------------------------------------------------------------------------

template <typename T, int K, int NS, int WARPS>
__global__ void __launch_bounds__(rotate_block(WARPS))
    rank_rotate_kernel(const T* src, const T* __restrict__ u, T* out, int n,
                       int downdate, double eps_in, int rows,
                       int* __restrict__ launches) {
  constexpr int nt = WARPS * 32;  // the chain's threads
  constexpr int bt = rotate_block(WARPS);
  const int tid = threadIdx.x;
  if (blockIdx.x > 0) {  // the lower triangle, which the sweep leaves as is
    for (int i = blockIdx.x - 1; i < n; i += gridDim.x - 1)
      for (int j = tid; j < i; j += bt)
        out[(long)i * n + j] = src[(long)i * n + j];
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = NS * nt;
  constexpr bool one_warp = WARPS == 1;
  T* rs = reinterpret_cast<T*>(smem);  // rows start 16-byte aligned
  T* spare = rs + (long)rows * ld;
  T* diag = spare + ld;
  T* bc = diag + n;
  const bool whole = rows >= n;
  const int ahead = rows - K;  // the ring's rows fetched ahead of the chain
  const T eps = (T)eps_in;     // torch casts a Python scalar to the dtype
  if (tid == 0 && launches) atomicAdd(launches, 1);

  for (int j = tid; j < n; j += bt) diag[j] = src[(long)j * n + j];
  if (whole) {  // R's rows by cp.async, every thread of the block
    constexpr int per = 16 / sizeof(T);
    if (n % per == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      const int chunks = n / per;
      for (int e = tid; e < n * chunks; e += bt) {
        const int r = e / chunks, c = (e - r * chunks) * per;
        cp_async16(rs + (long)r * ld + c, src + (long)r * n + c);
      }
    } else {
      for (int r = 0; r < n; ++r)
        for (int j = tid; j < n; j += bt)
          cp_async(rs + (long)r * ld + j, src + (long)r * n + j);
    }
    cp_async_commit();
    cp_async_wait(0);
  }
  // the chain's threads (a chain of one warp: the block's first; the
  // others only load R and store R')
  const bool chain = tid < nt;
  T uu[K][NS];
#pragma unroll
  for (int q = 0; q < K; ++q)
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int j = tid + s * nt;
      uu[q][s] = chain && j < n ? u[(long)q * n + j] : T(0);
    }
  // this thread's columns j >= row of R's row `row` into slot `slot`
  auto fetch = [&](int row, int slot) {
    if (row < n) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int j = tid + s * nt;
        if (j >= row && j < n)
          cp_async(rs + (long)slot * ld + j, src + (long)row * n + j);
      }
    }
    cp_async_commit();
  };
  if (chain && !whole)
    for (int r = 0; r < ahead; ++r) fetch(r, r);
  // u_q at row q's next pivot, on the thread that owns its column (column 0
  // first); the next interval reads it by a shuffle or from bc
  T nxt[K];
#pragma unroll
  for (int q = 0; q < K; ++q) nxt[q] = uu[q][0];
  if (!one_warp && tid == 0) bc[0] = uu[0][0];  // row 0's step 0
  __syncthreads();  // R in

  T dcar[K];  // R[p][p] as row q's step at the previous interval left it
#pragma unroll
  for (int q = 0; q < K; ++q) dcar[q] = T(0);
  int slot = 0;  // t % rows (ring)
  const int intervals = chain ? n + K - 1 : 0;
  for (int t = 0; t < intervals; ++t) {
    if (!whole) {
      int s2 = slot + ahead;
      if (s2 >= rows) s2 -= rows;
      fetch(t + ahead, s2);
      cp_async_wait(ahead);  // row t has landed
    }
    // the K steps of this interval: rho, c and s, stage by stage over the
    // rows so that their independent chains interleave
    T rkk[K], uk[K], rho[K], cq[K], sq[K], dnew[K];
    bool go[K];
    T* row[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int p = t - q;
      const bool valid = p >= 0 && p < n;
      const int pc = p < 0 ? 0 : (p < n ? p : n - 1);
      int sl = whole ? pc : slot - q;
      if (sl < 0) sl += rows;
      row[q] = valid ? rs + (long)sl * ld : spare;
      rkk[q] = q == 0 ? diag[pc] : dcar[q - 1];
      uk[q] = one_warp ? __shfl_sync(kFull, nxt[q], pc & 31)
                       : bc[(t & 1) * K + q];
      go[q] = valid;
    }
#pragma unroll
    for (int q = 0; q < K; ++q) {
      if (downdate) {
        const T t2 = sub_rn(mul_rn(rkk[q], rkk[q]), mul_rn(uk[q], uk[q]));
        const T fl = mul_rn(mul_rn(eps, rkk[q]), rkk[q]);
        go[q] = go[q] && t2 >= fl;
        rho[q] = nanmax(t2, fl);
      } else {
        rho[q] = add_rn(mul_rn(rkk[q], rkk[q]), mul_rn(uk[q], uk[q]));
      }
      go[q] = go[q] && uk[q] != T(0);
    }
#pragma unroll
    for (int q = 0; q < K; ++q) rho[q] = sqrt_rn(rho[q]);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const T inv = rho[q] == T(0) ? T(0) : rcp_rn(rho[q]);
      cq[q] = mul_rn(rkk[q], inv);
      sq[q] = mul_rn(uk[q], inv);
      // skipped (uk == 0, PD loss): the pivot stays
      dnew[q] = go[q] ? rho[q] : rkk[q];
    }
    // the updates: this thread's columns right of each step's pivot, every
    // load first, selects in place of branches; the owner of column p + 1
    // keeps u_q[p + 1] for the next interval
    T rk[K][NS];
#pragma unroll
    for (int q = 0; q < K; ++q)
#pragma unroll
      for (int s = 0; s < NS; ++s) rk[q][s] = row[q][tid + s * nt];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int p = t - q;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int j = tid + s * nt;
        const T r0 = rk[q][s], uj = uu[q][s];
        const T nr = downdate ? sub_rn(mul_rn(cq[q], r0), mul_rn(sq[q], uj))
                              : add_rn(mul_rn(cq[q], r0), mul_rn(sq[q], uj));
        const T nu = sub_rn(mul_rn(cq[q], uj), mul_rn(sq[q], r0));
        const bool sel = go[q] && j > p;
        row[q][j] = sel ? nr : r0;
        uu[q][s] = sel ? nu : uj;
        nxt[q] = j == p + 1 ? uu[q][s] : nxt[q];
      }
      if (!one_warp && tid == (p + 1) % nt)
        bc[((t + 1) & 1) * K + q] = nxt[q];
    }
    // row t - K + 1 is final: its pivot from the last row's step, into the
    // row (all rows: written out at the end) or with the row into `out`
    const int pf = t - (K - 1);
    if (pf >= 0 && pf < n) {
      T* rf = row[K - 1];
      if (tid == pf % nt) rf[pf] = dnew[K - 1];
      if (!whole) {
        T* dst = out + (long)pf * n;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int j = tid + s * nt;
          if (j >= pf && j < n) dst[j] = rf[j];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < K; ++q) dcar[q] = dnew[q];
    if (!whole && ++slot == rows) slot = 0;
    if (!one_warp) __syncthreads();
  }
  __syncthreads();  // the sweep done
  if (whole)  // R' out, by every thread of the block, four rows at once
    for (int p0 = 0; p0 < n; p0 += 4)
      for (int j = tid; j < n; j += bt) {
        T v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          v[r] = p0 + r < n ? rs[(long)(p0 + r) * ld + j] : T(0);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (p0 + r < n && j >= p0 + r) out[(long)(p0 + r) * n + j] = v[r];
      }
}

// Wider than kRotateMaxNs columns a thread of the 16-warp chain (n > 4096):
// ONE row u of U a launch, kWideThreads threads, thread t owning columns j =
// t (mod threads), u in the workspace uw (n), R's row p read from src and
// written to out at step p (in place from the second row on; the new
// pivot after the step's barrier, once every thread has read the old one),
// u[p + 1] handed on through a double-buffered shared slot, one barrier a
// step. The
// arithmetic is rank_rotate_kernel's, step for step.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    rank_rotate_wide_kernel(const T* src, const T* __restrict__ u, T* out,
                            T* __restrict__ uw, int n, int downdate,
                            double eps_in, int* __restrict__ launches) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (blockIdx.x > 0) {  // the lower triangle, which the sweep leaves as is
    for (int i = blockIdx.x - 1; i < n; i += gridDim.x - 1)
      for (int j = tid; j < i; j += nt)
        out[(long)i * n + j] = src[(long)i * n + j];
    return;
  }
  __shared__ T bc[2];
  const T eps = (T)eps_in;
  if (tid == 0 && launches) atomicAdd(launches, 1);
  for (int j = tid; j < n; j += nt) uw[j] = u[j];
  if (tid == 0) bc[0] = u[0];
  __syncthreads();
  for (int p = 0; p < n; ++p) {
    const T rkk = src[(long)p * n + p], uk = bc[p & 1];
    bool go;
    T rho;
    if (downdate) {
      const T t2 = sub_rn(mul_rn(rkk, rkk), mul_rn(uk, uk));
      const T fl = mul_rn(mul_rn(eps, rkk), rkk);
      go = t2 >= fl;
      rho = nanmax(t2, fl);
    } else {
      go = true;
      rho = add_rn(mul_rn(rkk, rkk), mul_rn(uk, uk));
    }
    go = go && uk != T(0);
    rho = sqrt_rn(rho);
    const T inv = rho == T(0) ? T(0) : rcp_rn(rho);
    const T c = mul_rn(rkk, inv), sn = mul_rn(uk, inv);
    const T* rp = src + (long)p * n;
    T* op = out + (long)p * n;
    for (int j = tid; j < n; j += nt) {
      if (j <= p) continue;
      const T r0 = rp[j], uj = uw[j];
      const T nr = downdate ? sub_rn(mul_rn(c, r0), mul_rn(sn, uj))
                            : add_rn(mul_rn(c, r0), mul_rn(sn, uj));
      const T nu = sub_rn(mul_rn(c, uj), mul_rn(sn, r0));
      op[j] = go ? nr : r0;
      if (go) uw[j] = nu;
      if (j == p + 1) bc[(p + 1) & 1] = go ? nu : uj;
    }
    __syncthreads();  // every thread has read the pivot (in place: op[p])
    if (tid == p % nt) op[p] = go ? rho : rkk;
  }
}

// ---------------------------------------------------------------------------
// gmw_chol
//
// For j = 0 .. n-1 (col_i = A_j[i][j] for i > j, 0 else):
//   theta = max |col|; dj = max(max(|A_j[j][j]|, theta*theta / beta2),
//   delta); low = col / dj; S[j][l] = sqrt(dj) * (l == j ? 1 : low[l]);
//   A_{j+1} = A_j - dj * (low_i * low_l).
// ---------------------------------------------------------------------------

// offset of column l of the lower triangle packed by columns (rows l .. n-1)
__device__ __forceinline__ int packed_col(int l, int n) {
  return l * n - (l * (l - 1)) / 2;
}

// max over values that are >= 0 or NaN (a magnitude, or a product or
// quotient of such), as torch.maximum: their bit patterns order as unsigned
// integers and a NaN's lies above every number's (the card's arithmetic
// gives the positive NaN)
__device__ __forceinline__ float absmax(float a, float b) {
  return __uint_as_float(max(__float_as_uint(a), __float_as_uint(b)));
}
__device__ __forceinline__ double absmax(double a, double b) {
  return __longlong_as_double((long long)max(
      (unsigned long long)__double_as_longlong(a),
      (unsigned long long)__double_as_longlong(b)));
}
__device__ __forceinline__ float warp_absmax(float v) {
  return __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(v)));
}
__device__ __forceinline__ double warp_absmax(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = absmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One block: shared memory = w (the packed lower triangle, n (n+1) / 2),
// low (2 x n: the lows of pivots j and j + 1), djs (2), red (2 x 32: the
// floors' maxima). Pivot j: every warp but warp 0 updates columns j + 2 ..
// of the trailing triangle with low and dj of pivot j, in blocks of four
// columns; warp 0 updates column j + 1 and from it takes pivot j + 1 whole
// (theta, dj, low, row j + 1 of S) into the other buffers; one barrier.
template <typename T>
__global__ void __launch_bounds__(1024)
    gmw_block_kernel(const T* __restrict__ a, T* __restrict__ s, int n,
                     double cdiv, T* __restrict__ floors_out,
                     int* __restrict__ launches) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* w = reinterpret_cast<T*>(smem);
  T* lows = w + n * (n + 1) / 2;
  T* djs = lows + 2 * n;
  T* red = djs + 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  if (tid == 0) atomicAdd(launches, 1);

  // A once: the floors' maxima over all of it (rows by warps), its lower
  // triangle into w (columns by warps, rows by lanes)
  T gmax = T(0), xmax = T(0);
  for (int i = warp; i < n; i += nw)
    for (int l = lane; l < n; l += 32)
      floors_take(a[i * n + l], l == i, &gmax, &xmax);
  for (int l = warp; l < n; l += nw) {
    T* cl = w + packed_col(l, n) - l;
    for (int i = l + lane; i < n; i += 32) cp_async(cl + i, a + i * n + l);
  }
  cp_async_commit();
  cp_async_wait(0);
  gmax = warp_nanmax(gmax);
  xmax = warp_nanmax(xmax);
  if (lane == 0) {
    red[warp] = gmax;
    red[32 + warp] = xmax;
  }
  __syncthreads();
  gmax = red[0];
  xmax = red[32];
  for (int q = 1; q < nw; ++q) {
    gmax = nanmax(gmax, red[q]);
    xmax = nanmax(xmax, red[32 + q]);
  }
  T delta, beta2;
  gmw_floors(gmax, xmax, n, cdiv, &delta, &beta2);
  if (tid == 0 && floors_out) {
    floors_out[0] = delta;
    floors_out[1] = beta2;
  }

  // warp 0: pivot jn from column jn's values, this lane's rows i = jn +
  // lane + 32 r parked in lo (its low buffer), lane 0's first the pivot
  // entry cjj: theta, dj, low, row jn of S
  auto take_pivot = [&](int jn, T* lo, T theta, T cjj) {
    theta = warp_absmax(theta);
    cjj = __shfl_sync(kFull, cjj, 0);
    const T dj =
        absmax(absmax(fabs(cjj), div_rn(mul_rn(theta, theta), beta2)), delta);
    const T sq = sqrt_rn(dj);
    const T z = dj == dj ? T(0) : dj;  // 0 / dj
    T* srow = s + (long)jn * n;
    for (int i0 = jn; i0 < n; i0 += 128) {  // four rows a lane at once
      T c[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + lane + 32 * r;
        c[r] = i > jn && i < n ? lo[i] : T(0);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + lane + 32 * r;
        if (i > jn && i < n) {
          const T lf = div_rn(c[r], dj);
          lo[i] = lf;
          srow[i] = mul_rn(sq, lf);
        }
      }
    }
    for (int l = lane; l < jn; l += 32) srow[l] = mul_rn(sq, z);
    if (lane == 0) {
      srow[jn] = sq;  // sqrt(dj) * 1
      djs[jn & 1] = dj;
    }
  };
  if (warp == 0) {
    T m = T(0);
    for (int i = lane; i < n; i += 32) {
      lows[i] = w[i];
      if (i > 0) m = absmax(m, fabs(w[i]));
    }
    take_pivot(0, lows, m, w[0]);
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const T dj = djs[j & 1];
    const T* lo = lows + (j & 1) * n;
    if (warp == 0) {
      if (j + 1 < n) {
        const int l = j + 1;
        const T* cl = w + packed_col(l, n) - l;
        T* ln = lows + (l & 1) * n;
        const T ll = lo[l];
        T m = T(0), cjj = T(0);
        for (int i0 = l; i0 < n; i0 += 128) {  // four rows a lane at once
          T c[4], li[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + lane + 32 * r;
            c[r] = i < n ? cl[i] : T(0);
            li[r] = i < n ? lo[i] : T(0);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + lane + 32 * r;
            const T v = sub_rn(c[r], mul_rn(dj, mul_rn(li[r], ll)));
            if (i < n) ln[i] = v;
            if (i > l && i < n) m = absmax(m, fabs(v));
            if (i == l) cjj = v;
          }
        }
        take_pivot(l, ln, m, cjj);
      }
    } else {
      // columns j + 2 .. in blocks of four, warps 1 .. in turn; a lane
      // takes one row of a block's 32-row chunk, its four entries at once
      const int first = j + 2;
      for (int cb = first / 4 + warp - 1; 4 * cb < n; cb += nw - 1) {
        const int l0 = 4 * cb;
        T ll[4];
        T* cl[4];
        bool live[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int l = l0 + c;
          live[c] = l >= first && l < n;
          ll[c] = live[c] ? lo[l] : T(0);
          cl[c] = w + (live[c] ? packed_col(l, n) - l : 0);
        }
        for (int i = l0 + lane; i < n; i += 32) {
          const T li = lo[i];
          T v[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            v[c] = live[c] && i >= l0 + c ? cl[c][i] : T(0);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (live[c] && i >= l0 + c)
              cl[c][i] = sub_rn(v[c], mul_rn(dj, mul_rn(li, ll[c])));
        }
      }
    }
    __syncthreads();
  }
}

// Above the shared-memory limit: a cooperative grid of kGridThreads-thread
// blocks, panels of B pivots. Workspace ws: W (n x n, the lower triangle by
// rows, W[i n + l] = A_j[i][l] for i >= l), lows (2 x B x n: panel buffer b,
// pivot q, row i), djs (2 x B), floors (2), partial maxima (2 x
// kMaxGridBlocks), then block 0's panel (B x n) where it is not in shared
// memory (PG: a template flag, so that the shared panel's accesses compile
// as shared-memory ones).
// Phases (one grid.sync() between two):
//   0: every block: A's lower triangle into W, partial maxima of the floors;
//   1: block 0: the floors, then panel 0 from A, factored;
//   2 + p (p = 0 .. P-2): block 0 brings panel p + 1's columns through panel
//      p's B updates into shared memory and factors them; the other blocks
//      bring the columns past panel p + 1 through panel p's B updates in W.
// Shared memory: unless PG, the panel (B columns of n - c1 rows, rows from
// the panel's first column c1; with PG block 0's threads order their
// accesses to it by __syncthreads(), which orders global memory within a
// block as well), then 64 slots (per warp: the next pivot's theta; in phase
// 0 the floors' maxima) and B x B lows of the previous panel at the panel's
// rows.

template <typename T, int B>
__device__ void gmw_panel_load(const T* __restrict__ src, int ld,
                               const T* __restrict__ plow,
                               const T* __restrict__ pdj, bool apply, int n,
                               int c1, int bq, T* pan, T* slots, T* lcol) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31,
            warp = tid >> 5;
  const int prow = n - c1;
  T djr[B];
  if (apply) {
    for (int e = tid; e < B * bq; e += nt) {
      const int qq = e / bq, q = e - qq * bq;
      lcol[qq * B + q] = plow[(long)qq * n + c1 + q];
    }
#pragma unroll
    for (int qq = 0; qq < B; ++qq) djr[qq] = pdj[qq];
    __syncthreads();
  }
  T m = T(0);  // column c1's maximum below its pivot
  for (int i = c1 + tid; i < n; i += nt) {
    T lr[B];
    if (apply) {
#pragma unroll
      for (int qq = 0; qq < B; ++qq) lr[qq] = plow[(long)qq * n + i];
    }
    for (int q = 0; q < bq && c1 + q <= i; ++q) {
      T v = src[(long)i * ld + c1 + q];
      if (apply) {
#pragma unroll
        for (int qq = 0; qq < B; ++qq)
          v = sub_rn(v, mul_rn(djr[qq], mul_rn(lr[qq], lcol[qq * B + q])));
      }
      pan[q * prow + i - c1] = v;
      if (q == 0 && i > c1) m = nanmax(m, fabs(v));
    }
  }
  m = warp_nanmax(m);
  if (lane == 0) slots[warp] = m;
  __syncthreads();
}

// block 0: the panel's bq pivots c1 .. c1 + bq - 1 in shared memory; lows
// to lows_out (B x n), djs to dj_out, rows of S
template <typename T>
__device__ void gmw_panel_factor(T* pan, T* slots, int n, int c1, int bq,
                                 T delta, T beta2, T* __restrict__ lows_out,
                                 T* __restrict__ dj_out, T* __restrict__ s) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31,
            warp = tid >> 5, nw = nt >> 5;
  const int prow = n - c1;
  for (int q = 0; q < bq; ++q) {
    const int j = c1 + q;
    T* cq = pan + q * prow;  // A_j[i][j] at cq[i - c1]
    T theta = slots[0];
    for (int w2 = 1; w2 < nw; ++w2) theta = nanmax(theta, slots[w2]);
    const T dj =
        nanmax(nanmax(fabs(cq[q]), div_rn(mul_rn(theta, theta), beta2)),
               delta);
    const T sq = sqrt_rn(dj), z = div_rn(T(0), dj);
    T* srow = s + (long)j * n;
    if (tid == 0) {
      dj_out[q] = dj;
      srow[j] = sq;
    }
    for (int l = tid; l < j; l += nt) srow[l] = mul_rn(sq, z);
    for (int i = c1 + tid; i < n; i += nt)
      if (i > j) {
        const T lf = div_rn(cq[i - c1], dj);
        cq[i - c1] = lf;  // column j is dead: it holds low from here on
        lows_out[(long)q * n + i] = lf;
        srow[i] = mul_rn(sq, lf);
      }
    __syncthreads();
    // the panel's columns past j for this thread's rows, column j + 1 first
    T m = T(0);
    for (int i = c1 + tid; i < n; i += nt) {
      if (i <= j) continue;
      const T li = cq[i - c1];
      for (int q2 = q + 1; q2 < bq && c1 + q2 <= i; ++q2) {
        T* c2 = pan + q2 * prow;
        const T v = sub_rn(c2[i - c1], mul_rn(dj, mul_rn(li, cq[q2])));
        c2[i - c1] = v;
        if (q2 == q + 1 && i > c1 + q2) m = nanmax(m, fabs(v));
      }
    }
    m = warp_nanmax(m);
    if (lane == 0) slots[warp] = m;
    __syncthreads();
  }
}

template <typename T, int B, bool PG>
__global__ void __launch_bounds__(kGridThreads)
    gmw_grid_kernel(const T* __restrict__ a, T* __restrict__ s,
                    T* __restrict__ ws, int n, double cdiv,
                    T* __restrict__ floors_out,
                    int* __restrict__ launches) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5, G = gridDim.x;
  T* W = ws;
  T* lows = W + (long)n * n;
  T* djs = lows + 2L * B * n;
  T* fl = djs + 2 * B;
  T* part = fl + 2;
  T* pan = PG ? part + 2 * kMaxGridBlocks : reinterpret_cast<T*>(smem);
  T* slots = reinterpret_cast<T*>(smem) + (PG ? 0 : (long)B * n);
  T* lcol = slots + 64;
  if (blockIdx.x == 0 && tid == 0) atomicAdd(launches, 1);
  const int P = (n + B - 1) / B;
  for (int ph = 0; ph <= P; ++ph) {
    if (ph > 0) cg::this_grid().sync();
    if (ph == 0) {
      T gmax = T(0), xmax = T(0);
      const int gw = blockIdx.x * nw + warp, nwg = G * nw;
      for (int i = gw; i < n; i += nwg)
        for (int l = lane; l < n; l += 32) {
          const long e = (long)i * n + l;
          const T v = a[e];
          floors_take(v, l == i, &gmax, &xmax);
          if (i >= l) W[e] = v;
        }
      gmax = warp_nanmax(gmax);
      xmax = warp_nanmax(xmax);
      if (lane == 0) {
        slots[warp] = gmax;
        slots[32 + warp] = xmax;
      }
      __syncthreads();
      if (tid == 0) {
        for (int q = 1; q < nw; ++q) {
          gmax = nanmax(gmax, slots[q]);
          xmax = nanmax(xmax, slots[32 + q]);
        }
        part[2 * blockIdx.x] = gmax;
        part[2 * blockIdx.x + 1] = xmax;
      }
    } else if (blockIdx.x == 0) {
      T delta, beta2;
      if (ph == 1) {
        T gmax = part[0], xmax = part[1];
        for (int b = 1; b < G; ++b) {
          gmax = nanmax(gmax, part[2 * b]);
          xmax = nanmax(xmax, part[2 * b + 1]);
        }
        gmw_floors(gmax, xmax, n, cdiv, &delta, &beta2);
        if (tid == 0) {
          fl[0] = delta;
          fl[1] = beta2;
          if (floors_out) {
            floors_out[0] = delta;
            floors_out[1] = beta2;
          }
        }
        const int bq = n < B ? n : B;
        gmw_panel_load<T, B>(a, n, nullptr, nullptr, false, n, 0, bq, pan,
                             slots, lcol);
        gmw_panel_factor(pan, slots, n, 0, bq, delta, beta2, lows, djs, s);
      } else {
        delta = fl[0];
        beta2 = fl[1];
        const int p = ph - 2, c1 = (p + 1) * B;
        const int bq = n - c1 < B ? n - c1 : B;
        const T* plow = lows + (long)(p & 1) * B * n;
        gmw_panel_load<T, B>(W, n, plow, djs + (p & 1) * B, true, n, c1, bq,
                             pan, slots, lcol);
        gmw_panel_factor(pan, slots, n, c1, bq, delta, beta2,
                         lows + (long)((p + 1) & 1) * B * n,
                         djs + ((p + 1) & 1) * B, s);
      }
    } else if (ph >= 2) {
      // the columns past panel p + 1 through panel p's updates: tiles of
      // 64 x 64 over the trailing lower triangle, blocks 1 .. G-1 in turn
      const int p = ph - 2, c2 = (p + 2) * B;
      if (c2 >= n) continue;
      const T* plow = lows + (long)(p & 1) * B * n;
      T djr[B];
#pragma unroll
      for (int qq = 0; qq < B; ++qq) djr[qq] = djs[(p & 1) * B + qq];
      const int nb = (n - c2 + 63) / 64, tiles = nb * (nb + 1) / 2;
      for (int k = blockIdx.x - 1; k < tiles; k += G - 1) {
        int rb = (int)((sqrtf(8.f * k + 1.f) - 1.f) * 0.5f);
        while (rb * (rb + 1) / 2 > k) --rb;
        while ((rb + 1) * (rb + 2) / 2 <= k) ++rb;
        const int cb = k - rb * (rb + 1) / 2;
        const int r0 = c2 + 64 * rb, l0 = c2 + 64 * cb + lane;
        T lc[2][B];
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int qq = 0; qq < B; ++qq) {
            const int l = l0 + 32 * c;
            lc[c][qq] = l < n ? plow[(long)qq * n + l] : T(0);
          }
        const int r1 = r0 + 64 < n ? r0 + 64 : n;
        for (int i = r0 + warp; i < r1; i += nw) {
          T lr[B];
#pragma unroll
          for (int qq = 0; qq < B; ++qq) lr[qq] = plow[(long)qq * n + i];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int l = l0 + 32 * c;
            if (l < n && l <= i) {
              T v = W[(long)i * n + l];
#pragma unroll
              for (int qq = 0; qq < B; ++qq)
                v = sub_rn(v, mul_rn(djr[qq], mul_rn(lr[qq], lc[c][qq])));
              W[(long)i * n + l] = v;
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the chain latency probe: one thread, `steps` dependent steps
// ---------------------------------------------------------------------------

template <typename T>
__global__ void chain_latency_kernel(int kind, int steps, T* __restrict__ io) {
  // io: r, u, ua, rb, eps, a0, a1, beta2, delta, then the result; read from
  // memory, so that nothing folds
  const T r = io[0], ua = io[2], rb = io[3], eps = io[4];
  const T a0 = io[5], a1 = io[6], beta2 = io[7], delta = io[8];
  T uk = io[1], theta = io[1], acc = T(0);
  for (int i = 0; i < steps; ++i) {
    if (kind == 0) {
      // an interval of the wavefront: u[p] from its owner, rho, c and s (as
      // rank_rotate_kernel: rcp_rn), then the owner of column p + 1 forms
      // u[p + 1]
      const T v = __shfl_sync(1u, uk, 0);
      const T t2 = sub_rn(mul_rn(r, r), mul_rn(v, v));
      const T fl = mul_rn(mul_rn(eps, r), r);
      const T rho = sqrt_rn(nanmax(t2, fl));
      const T inv = rcp_rn(rho);
      const T c = mul_rn(r, inv), sn = mul_rn(v, inv);
      uk = sub_rn(mul_rn(c, ua), mul_rn(sn, rb));
      acc = add_rn(acc, rho);
    } else {
      // a pivot: dj from theta, low from dj, the next column's entry and
      // its magnitude (the next theta)
      const T dj =
          nanmax(nanmax(fabs(a0), div_rn(mul_rn(theta, theta), beta2)),
                 delta);
      const T lf = div_rn(theta, dj);
      theta = fabs(sub_rn(a1, mul_rn(dj, mul_rn(lf, lf))));
      acc = add_rn(acc, sqrt_rn(dj));
    }
  }
  io[9] = kind == 0 ? add_rn(uk, acc) : add_rn(theta, acc);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// cudaFuncSetAttribute (the shared-memory limit) once per kernel and device;
// `done` is the caller's table for that kernel
cudaError_t allow_smem(const void* kernel, unsigned char* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
    if (e != cudaSuccess) return e;
    done[dev] = 1;
  }
  return cudaSuccess;
}

// rank_rotate's route at width n: the chain's warps (1 up to
// kRotateOneWarpMaxN: u[p] by a shuffle; else kRotateWarps) and the columns
// a thread keeps in registers (a power of two); 0 where that would pass
// kRotateMaxNs (rank_rotate_wide_kernel)
int rotate_warps(int n) { return n <= kRotateOneWarpMaxN ? 1 : kRotateWarps; }
int rotate_ns(int n) {
  const int threads = 32 * rotate_warps(n);
  int ns = 1;
  while (ns < kRotateMaxNs && ns * threads < n) ns *= 2;
  return ns * threads < n ? 0 : ns;
}

// gmw_chol's routes: one block where the packed triangle, two columns of
// lows and 66 slots fit its shared memory; the block's threads (a warp per
// eight columns of the first trailing triangle, at least two warps: warp 0
// takes the next pivot, the others the trailing update; n = 196: 800, n =
// 100: 416); the grid's panel in shared memory where B columns, 64 slots and
// B x B lows fit
size_t gmw_block_smem(int n, size_t itemsize) {
  return ((size_t)n * (n + 1) / 2 + 2 * (size_t)n + 66) * itemsize;
}
int gmw_block_threads(int n) {
  const int warps = (n + 7) / 8;
  return 32 * (warps < 2 ? 2 : (warps > 32 ? 32 : warps));
}
bool gmw_pan_fits(int n, size_t itemsize) {
  return ((size_t)kGmwPanel * n + 64 + kGmwPanel * kGmwPanel) * itemsize <=
         (size_t)kSmemMax;
}

// route: 0 the launcher's (one block where it fits, else the grid), 1 the
// grid, its panel in shared memory where it fits, 2 the grid, its panel in
// the workspace (1 and 2 check the grid at small n)
bool gmw_grid(int n, size_t itemsize, int route) {
  return route != 0 || gmw_block_smem(n, itemsize) > (size_t)kSmemMax;
}
bool gmw_pan_global(int n, size_t itemsize, int route) {
  return route == 2 || !gmw_pan_fits(n, itemsize);
}
long long gmw_workspace(int n, size_t itemsize, int route) {
  if (!gmw_grid(n, itemsize, route)) return 0;
  const long long b = kGmwPanel;
  return (long long)n * n + 2 * b * n + 2 * b + 2 + 2 * kMaxGridBlocks +
         (gmw_pan_global(n, itemsize, route) ? b * n : 0);
}

template <typename T, int K, int NS, int WARPS>
cudaError_t launch_rotate_group(const T* src, const T* u, T* out, int n,
                                int downdate, double eps, int copy_blocks,
                                int* launches, cudaStream_t st) {
  static unsigned char done[kMaxDevices];
  const void* fn = (const void*)rank_rotate_kernel<T, K, NS, WARPS>;
  cudaError_t e = allow_smem(fn, done);
  if (e != cudaSuccess) return e;
  // all n rows of R where they fit, else a ring of at most kRingRows rows
  // that holds at least one row ahead of the wavefront
  const long ld = (long)NS * WARPS * 32, fixed = n + 2 * K + ld;
  const long avail = (long)kSmemMax / (long)sizeof(T) - fixed;
  long rows = avail >= (long)n * ld ? n : avail / ld;
  if (rows < n && rows > kRingRows) rows = kRingRows;
  if (rows < n && rows <= K) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(fixed + rows * ld) * sizeof(T);
  rank_rotate_kernel<T, K, NS, WARPS>
      <<<1 + copy_blocks, rotate_block(WARPS), smem, st>>>(
          src, u, out, n, downdate, eps, (int)rows, launches);
  return cudaGetLastError();
}

template <typename T, int K, int WARPS>
cudaError_t launch_rotate_ns(int ns, const T* src, const T* u, T* out, int n,
                             int downdate, double eps, int copy_blocks,
                             int* launches, cudaStream_t st) {
  switch (ns) {
    case 1:
      return launch_rotate_group<T, K, 1, WARPS>(src, u, out, n, downdate,
                                                 eps, copy_blocks, launches,
                                                 st);
    case 2:
      return launch_rotate_group<T, K, 2, WARPS>(src, u, out, n, downdate,
                                                 eps, copy_blocks, launches,
                                                 st);
    case 4:
      return launch_rotate_group<T, K, 4, WARPS>(src, u, out, n, downdate,
                                                 eps, copy_blocks, launches,
                                                 st);
    default:
      return launch_rotate_group<T, K, kRotateMaxNs, WARPS>(
          src, u, out, n, downdate, eps, copy_blocks, launches, st);
  }
}

template <typename T, int K>
cudaError_t launch_rotate_k(int ns, const T* src, const T* u, T* out, int n,
                            int downdate, double eps, int copy_blocks,
                            int* launches, cudaStream_t st) {
  return rotate_warps(n) == 1
             ? launch_rotate_ns<T, K, 1>(ns, src, u, out, n, downdate, eps,
                                         copy_blocks, launches, st)
             : launch_rotate_ns<T, K, kRotateWarps>(ns, src, u, out, n,
                                                    downdate, eps,
                                                    copy_blocks, launches,
                                                    st);
}

template <typename T>
int launch_rank_rotate(const void* r, const void* u, void* out, void* ws,
                       int n, int k, int downdate, double eps, int route,
                       void* launches, cudaStream_t st) {
  const T* rp = (const T*)r;
  const T* up = (const T*)u;
  T* op = (T*)out;
  const int copy_blocks = n > 1 ? (n < 64 ? n : 64) : 0;
  const int ns = rotate_ns(n);
  if (route == 1 || ns == 0) {  // one row of U a launch
    if (!ws) return (int)cudaErrorInvalidValue;
    for (int g = 0; g < k; ++g) {
      rank_rotate_wide_kernel<T>
          <<<1 + (g == 0 ? copy_blocks : 0), kWideThreads, 0, st>>>(
              g == 0 ? rp : op, up + (long)g * n, op, (T*)ws, n, downdate,
              eps, g == 0 ? (int*)launches : nullptr);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaSuccess;
  }
  // groups of up to four rows, one wavefront each
  for (int g = 0; g < k; g += 4) {
    const int kg = k - g < 4 ? k - g : 4;
    const T* src = g == 0 ? rp : op;
    int* cnt = g == 0 ? (int*)launches : nullptr;
    const int cb = g == 0 ? copy_blocks : 0;
    const T* ug = up + (long)g * n;
    cudaError_t e;
    switch (kg) {
      case 1:
        e = launch_rotate_k<T, 1>(ns, src, ug, op, n, downdate, eps, cb, cnt,
                                  st);
        break;
      case 2:
        e = launch_rotate_k<T, 2>(ns, src, ug, op, n, downdate, eps, cb, cnt,
                                  st);
        break;
      case 3:
        e = launch_rotate_k<T, 3>(ns, src, ug, op, n, downdate, eps, cb, cnt,
                                  st);
        break;
      default:
        e = launch_rotate_k<T, 4>(ns, src, ug, op, n, downdate, eps, cb, cnt,
                                  st);
        break;
    }
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

template <typename T>
int launch_gmw_block(const void* a, void* s, int n, double cdiv,
                     void* floors_out, void* launches, cudaStream_t st) {
  static unsigned char done[kMaxDevices];
  const void* fn = (const void*)gmw_block_kernel<T>;
  cudaError_t e = allow_smem(fn, done);
  if (e != cudaSuccess) return (int)e;
  gmw_block_kernel<T>
      <<<1, gmw_block_threads(n), gmw_block_smem(n, sizeof(T)), st>>>(
          (const T*)a, (T*)s, n, cdiv, (T*)floors_out, (int*)launches);
  return (int)cudaGetLastError();
}

template <typename T, bool PG>
int launch_gmw_grid(const void* a, void* s, void* ws, int n, double cdiv,
                    void* floors_out, void* launches, cudaStream_t st) {
  static unsigned char done[kMaxDevices];
  static int sms[kMaxDevices];
  constexpr int B = kGmwPanel;
  const void* fn = (const void*)gmw_grid_kernel<T, B, PG>;
  if (!ws) return (int)cudaErrorInvalidValue;
  const size_t smem = ((PG ? 0 : (size_t)B * n) + 64 + B * B) * sizeof(T);
  cudaError_t e = allow_smem(fn, done);
  if (e != cudaSuccess) return (int)e;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (!sms[dev]) {
    int v = 0;
    e = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    sms[dev] = v;
  }
  // one block per SM, all resident at once for grid.sync()
  const int blocks = sms[dev] < kMaxGridBlocks ? sms[dev] : kMaxGridBlocks;
  if (blocks < 2) return (int)cudaErrorInvalidConfiguration;
  const T* ap = (const T*)a;
  T* sp = (T*)s;
  T* wp = (T*)ws;
  T* fp = (T*)floors_out;
  int* lp = (int*)launches;
  void* args[] = {&ap, &sp, &wp, &n, &cdiv, &fp, &lp};
  e = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kGridThreads), args,
                                  smem, st);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T>
int launch_gmw(const void* a, void* s, void* ws, int n, double cdiv,
               void* floors_out, int route, void* launches, cudaStream_t st) {
  if (route < 0 || route > 2) return (int)cudaErrorInvalidValue;
  if (!gmw_grid(n, sizeof(T), route))
    return launch_gmw_block<T>(a, s, n, cdiv, floors_out, launches, st);
  return gmw_pan_global(n, sizeof(T), route)
             ? launch_gmw_grid<T, true>(a, s, ws, n, cdiv, floors_out,
                                        launches, st)
             : launch_gmw_grid<T, false>(a, s, ws, n, cdiv, floors_out,
                                         launches, st);
}

}  // namespace

extern "C" {

// Elements of device workspace (of the call's dtype) that a call of
// cvms_rank_rotate (kernel 0) or cvms_gmw_chol (kernel 1) at width n and
// `route` needs, into *elems (0: none; the routes of n <= 4096 and of n <=
// 338 / 238 need none).
int cvms_linalg_workspace(int f64, int kernel, int n, int route,
                          void* elems) {
  const size_t itemsize = f64 ? sizeof(double) : sizeof(float);
  long long* out = (long long*)elems;
  if (n < 0 || !out) return (int)cudaErrorInvalidValue;
  if (kernel == 0)
    *out = route == 1 || rotate_ns(n) == 0 ? n : 0;
  else
    *out = gmw_workspace(n, itemsize, route);
  return (int)cudaSuccess;
}

// f64: 0 float32, 1 float64. r (n, n), u (k, n) -> out (n, n): R'^T R' =
// R^T R + U^T U (downdate 0) or - U^T U (downdate 1, PD-loss guard eps);
// route 0 the launcher's, 1 one row of U a launch (the wide kernel, at any
// n); ws: cvms_linalg_workspace's; launches: the device counter this call
// adds one to.
int cvms_rank_rotate(int f64, const void* r, const void* u, void* out,
                     void* ws, int n, int k, int downdate, double eps,
                     int route, void* launches, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return f64 ? launch_rank_rotate<double>(r, u, out, ws, n, k, downdate, eps,
                                          route, launches, st)
             : launch_rank_rotate<float>(r, u, out, ws, n, k, downdate, eps,
                                         route, launches, st);
}

// f64: 0 float32, 1 float64. a (n, n) in, s (n, n) out; cdiv: the floors'
// divisor max(sqrt(n^2 - 1), 1); floors_out: (delta, beta^2) or NULL;
// route: see gmw_grid; ws: cvms_linalg_workspace's.
int cvms_gmw_chol(int f64, const void* a, void* s, void* ws, int n,
                  double cdiv, void* floors_out, int route, void* launches,
                  void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return f64 ? launch_gmw<double>(a, s, ws, n, cdiv, floors_out, route,
                                  launches, st)
             : launch_gmw<float>(a, s, ws, n, cdiv, floors_out, route,
                                 launches, st);
}

// f64: 0 float32, 1 float64; kind 0: an interval of rank_rotate's
// wavefront, 1: a pivot of gmw_chol. One thread runs `steps` of that step's
// dependent arithmetic; io (10,): nine inputs (chain_latency_kernel), then
// the result.
int cvms_chain_latency(int f64, int kind, int steps, void* io,
                       void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (f64)
    chain_latency_kernel<double><<<1, 1, 0, st>>>(kind, steps, (double*)io);
  else
    chain_latency_kernel<float><<<1, 1, 0, st>>>(kind, steps, (float*)io);
  return (int)cudaGetLastError();
}

}  // extern "C"
