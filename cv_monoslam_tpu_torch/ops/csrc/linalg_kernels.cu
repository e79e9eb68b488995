// Two recurrences of the filter's reference-faithful sequential update for
// Hopper (sm_90a): the rank-k square-root update / downdate by plane
// rotations and the Gill-Murray-Wright modified Cholesky. Plain C
// interface, loaded with ctypes by cv_monoslam_tpu_torch/ops/_build.py;
// each entry point launches on the stream it is given and returns
// cudaGetLastError() of its launch. float32 and float64 (faithful mode runs
// in float64 on the card).
//
// Neither replaces a Pallas kernel. Both replace host loops of the port
// that the JAX package runs on the device as lax.scan recurrences
// (cv_monoslam_tpu/ops/linalg.py), so that a captured CUDA graph of a frame
// in update_mode="sequential" holds a few launches per matched landmark
// instead of ~10 device ops per pivot and ~25 per rotation:
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
// contracts into an FMA; maxima propagate NaN as torch.maximum and
// torch.max do. gmw_chol's floors (delta, beta^2) are computed by the
// wrapper with the plain version's own torch ops and passed in.
//
// What bounds them on an H100. Neither moves much (rank_rotate: R in, R'
// out, U: 0.31 MB at n = 196 in float32; gmw_chol: A in, S out) nor does
// much arithmetic (rank_rotate ~3 k n^2 operations, gmw_chol ~n^3): at n =
// 196 both bounds are under a microsecond. What bounds them is a chain of
// dependent steps: rank_rotate's step p needs the pivot R[p][p] and u[p]
// the step before left; gmw_chol's pivot j needs the trailing matrix pivot
// j - 1 left. So:
//
// * rank_rotate: ONE block, a thread per column (strided above 1024
//   columns). Thread t owns columns j = t (mod blockDim), the whole column
//   of R' and the entries of u: the rotation at step p touches row p in the
//   columns j >= p only, so a thread reads and writes only its own columns
//   and the only value it needs from another is (R[p][p], u[p]), which the
//   owner of column p publishes at the end of step p - 1 into one of two
//   shared slots. One block barrier per step; k n steps in all, all k rows
//   of U in the same launch.
// * gmw_chol: the working matrix is kept TRANSPOSED (the rank-1 update
//   dj * outer(low, low) is symmetric, so the transpose evolves by the same
//   formula), so that pivot j's column of A is a contiguous row. Every
//   pivot reduces its column (max |.|), takes dj, writes row j of S and
//   updates the trailing block (rows and columns > j, the only entries a
//   later pivot reads; the plain version also updates the rest of the
//   matrix, which nothing reads again). Up to GMW_ONE_BLOCK_MAX_N (linalg.py)
//   one block of 1024 threads, three barriers a pivot; above, a cooperative
//   grid (one block per SM) that splits the trailing rows between blocks,
//   every block reducing the pivot's column itself, and one grid.sync() a
//   pivot.
//
// Launch counts: both kernels run inside conditional bodies of a captured
// graph (the per-landmark gate of the sequential update), where the host
// cannot see whether they ran. So thread 0 of block 0 of each launch adds one
// to a device counter the wrapper passes in (vision.device_counts reads
// them).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;

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

// torch.maximum / torch.max: a NaN operand gives NaN
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

template <typename T>
__device__ __forceinline__ T warp_nanmax(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nanmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
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
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(1024)
    rank_rotate_kernel(const T* __restrict__ r, const T* __restrict__ u,
                       T* __restrict__ out, int n, int k, int downdate,
                       double eps_in, int* __restrict__ launches) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* us = reinterpret_cast<T*>(smem);  // the row of U being swept
  __shared__ T bc_r[2], bc_u[2];       // (R[p][p], u[p]) for step p
  const int tid = threadIdx.x, nt = blockDim.x;
  const T eps = (T)eps_in;  // torch casts a Python scalar to the dtype
  if (tid == 0) atomicAdd(launches, 1);
  for (long i = tid; i < (long)n * n; i += nt) out[i] = r[i];
  for (int row = 0; row < k; ++row) {
    for (int j = tid; j < n; j += nt) us[j] = u[(long)row * n + j];
    __syncthreads();
    if (tid == 0) {
      bc_r[0] = out[0];
      bc_u[0] = us[0];
    }
    __syncthreads();
    for (int p = 0; p < n; ++p) {
      const T rkk = bc_r[p & 1], uk = bc_u[p & 1];
      T rho;
      bool pd_ok = true;
      if (downdate) {
        const T t2 = sub_rn(mul_rn(rkk, rkk), mul_rn(uk, uk));
        const T fl = mul_rn(mul_rn(eps, rkk), rkk);
        pd_ok = t2 >= fl;
        rho = sqrt_rn(nanmax(t2, fl));
      } else {
        rho = sqrt_rn(add_rn(mul_rn(rkk, rkk), mul_rn(uk, uk)));
      }
      T* rowp = out + (long)p * n;
      if (!(uk == T(0) || !pd_ok)) {
        const T inv = rho == T(0) ? T(0) : div_rn(T(1), rho);
        const T c = mul_rn(rkk, inv), s = mul_rn(uk, inv);
        // this thread's first column after p
        const int j0 = p + 1 + ((tid - (p + 1)) % nt + nt) % nt;
        for (int j = j0; j < n; j += nt) {
          const T rk = rowp[j], uj = us[j];
          rowp[j] = downdate ? sub_rn(mul_rn(c, rk), mul_rn(s, uj))
                             : add_rn(mul_rn(c, rk), mul_rn(s, uj));
          us[j] = sub_rn(mul_rn(c, uj), mul_rn(s, rk));
        }
        if (tid == p % nt) rowp[p] = rho;
      }
      // the owner of column p + 1 publishes the next step's pivot: row
      // p + 1 is untouched so far in this sweep
      if (p + 1 < n && tid == (p + 1) % nt) {
        bc_r[(p + 1) & 1] = out[(long)(p + 1) * n + p + 1];
        bc_u[(p + 1) & 1] = us[p + 1];
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// gmw_chol
//
// w = A^T (n, n), updated in place; s (n, n); floors = (delta, beta^2).
// For j = 0 .. n-1 (col_i = A_j[i][j] for i > j, 0 else):
//   theta = max |col|; dj = max(max(|A_j[j][j]|, theta*theta / beta2),
//   delta); low = col / dj; S[j][l] = sqrt(dj) * (l == j ? 1 : low[l]);
//   A_{j+1} = A_j - dj * (low_i * low_l).
// ---------------------------------------------------------------------------

// One pivot's column: theta (every thread of the block gets it) and the
// pivot dj. red holds 32 values.
template <typename T>
__device__ __forceinline__ T pivot_dj(const T* __restrict__ wj, int j, int n,
                                      T delta, T beta2, T* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T m = T(0);  // the plain column's zeros (rows <= j) are in the maximum
  for (int i = j + 1 + tid; i < n; i += blockDim.x) m = nanmax(m, fabs(wj[i]));
  m = warp_nanmax(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  T theta = T(0);
  for (int q = 0; q < (int)(blockDim.x >> 5); ++q) theta = nanmax(theta, red[q]);
  return nanmax(nanmax(fabs(wj[j]), div_rn(mul_rn(theta, theta), beta2)),
                delta);
}

// Row j of S and low[l] = col_l / dj for l > j (into shared memory).
template <typename T>
__device__ __forceinline__ void pivot_row(const T* __restrict__ wj, int j,
                                          int n, T dj, T* __restrict__ srow,
                                          T* low, bool write_s) {
  const T sq = sqrt_rn(dj);
  for (int l = threadIdx.x; l < n; l += blockDim.x) {
    const T lf = l < j ? div_rn(T(0), dj) : (l == j ? T(1) : div_rn(wj[l], dj));
    if (write_s) srow[l] = mul_rn(sq, lf);
    if (l > j) low[l] = lf;
  }
}

template <typename T>
__global__ void __launch_bounds__(1024)
    gmw_block_kernel(T* __restrict__ w, T* __restrict__ s,
                     const T* __restrict__ floors, int n,
                     int* __restrict__ launches) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* low = reinterpret_cast<T*>(smem);
  __shared__ T red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (threadIdx.x == 0) atomicAdd(launches, 1);
  const T delta = floors[0], beta2 = floors[1];
  for (int j = 0; j < n; ++j) {
    const T* wj = w + (long)j * n;
    const T dj = pivot_dj(wj, j, n, delta, beta2, red);
    pivot_row(wj, j, n, dj, s + (long)j * n, low, true);
    __syncthreads();
    for (int i = j + 1 + warp; i < n; i += nw) {
      T* wi = w + (long)i * n;
      const T li = low[i];
      for (int l = j + 1 + lane; l < n; l += 32)
        wi[l] = sub_rn(wi[l], mul_rn(dj, mul_rn(li, low[l])));
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    gmw_grid_kernel(T* __restrict__ w, T* __restrict__ s,
                    const T* __restrict__ floors, int n,
                    int* __restrict__ launches) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* low = reinterpret_cast<T*>(smem);
  __shared__ T red[32];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1);
  const T delta = floors[0], beta2 = floors[1];
  for (int j = 0; j < n; ++j) {
    const T* wj = w + (long)j * n;
    const T dj = pivot_dj(wj, j, n, delta, beta2, red);
    pivot_row(wj, j, n, dj, s + (long)j * n, low, blockIdx.x == 0);
    __syncthreads();
    for (int i = j + 1 + blockIdx.x * nw + warp; i < n; i += gridDim.x * nw) {
      T* wi = w + (long)i * n;
      const T li = low[i];
      for (int l = j + 1 + lane; l < n; l += 32)
        wi[l] = sub_rn(wi[l], mul_rn(dj, mul_rn(li, low[l])));
    }
    grid.sync();  // also orders red's reuse by the next pivot
  }
}

template <typename T>
int launch_rank_rotate(const void* r, const void* u, void* out, int n, int k,
                       int downdate, double eps, void* launches,
                       cudaStream_t st) {
  const int threads = n >= 1024 ? 1024 : ((n + 31) / 32) * 32;
  const size_t smem = (size_t)n * sizeof(T);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(rank_rotate_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  rank_rotate_kernel<T><<<1, threads, smem, st>>>(
      (const T*)r, (const T*)u, (T*)out, n, k, downdate, eps, (int*)launches);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gmw(void* w, void* s, const void* floors, int n, int use_grid,
               void* launches, cudaStream_t st) {
  const size_t smem = (size_t)n * sizeof(T);
  if (!use_grid) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(gmw_block_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    gmw_block_kernel<T><<<1, 1024, smem, st>>>(
        (T*)w, (T*)s, (const T*)floors, n, (int*)launches);
    return (int)cudaGetLastError();
  }
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(gmw_grid_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gmw_grid_kernel<T>,
                                                256, smem);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // every block must be resident at once for grid.sync(): one per SM
  const int blocks = sms;
  T* wp = (T*)w;
  T* sp = (T*)s;
  const T* fp = (const T*)floors;
  int* lp = (int*)launches;
  void* args[] = {&wp, &sp, &fp, &n, &lp};
  cudaLaunchCooperativeKernel((void*)gmw_grid_kernel<T>, dim3(blocks),
                              dim3(256), args, smem, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// f64: 0 float32, 1 float64. r (n, n), u (k, n) -> out (n, n): R'^T R' =
// R^T R + U^T U (downdate 0) or - U^T U (downdate 1, PD-loss guard eps);
// launches: the device counter this launch adds one to.
int cvms_rank_rotate(int f64, const void* r, const void* u, void* out, int n,
                     int k, int downdate, double eps, void* launches,
                     void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return f64 ? launch_rank_rotate<double>(r, u, out, n, k, downdate, eps,
                                          launches, st)
             : launch_rank_rotate<float>(r, u, out, n, k, downdate, eps,
                                         launches, st);
}

// f64: 0 float32, 1 float64. w (n, n) = A^T, overwritten; s (n, n) out;
// floors (2,) = (delta, beta^2); grid: 1 for the cooperative grid.
int cvms_gmw_chol(int f64, void* w, void* s, const void* floors, int n,
                  int grid, void* launches, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return f64 ? launch_gmw<double>(w, s, floors, n, grid, launches, st)
             : launch_gmw<float>(w, s, floors, n, grid, launches, st);
}

}  // extern "C"
