// Two sequential recurrences of the frame for Hopper (sm_90a), each one
// block: the stored-table slot policy of store_features and GFTT's greedy
// min-distance separation. Plain C interface, loaded with ctypes by
// cv_monoslam_tpu_torch/ops/_build.py; each entry point launches on the
// stream it is given and returns cudaGetLastError() of its launch.
//
// Neither replaces a Pallas kernel. Both replace host loops of the port
// that the JAX package runs on the device as lax.scan recurrences, so that
// a captured CUDA graph of a chunk reads nothing back to the host:
//
// * store_slots: cv_monoslam_tpu/filter/lifecycle.py::store_features
//   (lax.scan over records, lax.cond per masked record);
// * gftt_greedy_nms: the greedy separation of
//   cv_monoslam_tpu/frontend/detect.py::gftt_candidates (an unrolled chain
//   for K <= 64, a blocked lax.scan above).
//
// Both are decisions, so both equal their plain PyTorch versions in
// cv_monoslam_tpu_torch/ops/vision.py (store_slots_ref, gftt_greedy_nms_ref)
// exactly; chip_smoke.py holds them to that on the card.
//
// What bounds them on an H100. Neither moves more than a few kilobytes
// (store_slots: M = 576 records and an S = 64 table, ~5 KB; the greedy
// pass: K = 768 corners, ~10 KB), 3 ns at 3.35 TB/s, and neither does
// more than K^2 / 2 = 0.3 M comparisons. What bounds them is the chain of
// dependent steps, one block-wide barrier each: a record's slot depends on
// the table the record before it left, a corner's fate on every corner
// kept before it. So one block does all of it, the state lives in shared
// memory, and each step is one barrier (__syncthreads_or for the greedy
// test) or a few (the slot choice's block-wide minimum). Records that are
// not stored, and corners that are not candidates, are skipped without a
// barrier: the test is uniform across the block.
//
// Launch counts: both kernels run inside conditional bodies of a captured
// graph (the store branch of update_features; the detect branch when
// detection is gated per frame), where the host cannot see whether they
// ran. So thread 0 of each launch adds one to a device counter the wrapper
// passes in (vision.device_counts reads them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w < v ? w : v;
  }
  return v;
}

// ---------------------------------------------------------------------------
// store_slots
//
// For each record j in order with mask[j]: dup = valid & (tlid == lid[j]);
// slot = first dup, else the first free slot, else the valid slot with the
// smallest stamp (the first such). Then valid[slot] = 1, stamp[slot] = seq,
// tlid[slot] = lid[j], seq += 1, src[slot] = j. Outputs: slot_out (M) (-1
// where not stored), src (S) (-1 where no record landed), the new valid and
// stamp (S) and seq.
//
// Each thread owns table slots t, t + blockDim, ...; per stored record
// three block-wide minima of 64-bit keys are taken in one pass: the first
// dup and the first free slot keyed by slot, the oldest by (stamp << 32 |
// slot), so ties go to the lower slot as argmin's do.
// ---------------------------------------------------------------------------

__global__ void store_slots_kernel(const bool* __restrict__ mask,
                                   const int* __restrict__ lid, int m,
                                   const bool* __restrict__ valid_in,
                                   const int* __restrict__ tlid_in,
                                   const int* __restrict__ stamp_in,
                                   const int* __restrict__ seq_in, int s,
                                   int* __restrict__ slot_out,
                                   int* __restrict__ src_out,
                                   bool* __restrict__ valid_out,
                                   int* __restrict__ stamp_out,
                                   int* __restrict__ seq_out,
                                   int* __restrict__ launches) {
  extern __shared__ int sh[];
  int* tvalid = sh;              // s
  int* tlid = tvalid + s;        // s
  int* tstamp = tlid + s;        // s
  int* tsrc = tstamp + s;        // s
  __shared__ unsigned long long red[3][kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = (blockDim.x + 31) >> 5;
  if (t == 0) atomicAdd(launches, 1);
  for (int i = t; i < s; i += blockDim.x) {
    tvalid[i] = valid_in[i] ? 1 : 0;
    tlid[i] = tlid_in[i];
    tstamp[i] = stamp_in[i];
    tsrc[i] = -1;
  }
  for (int j = t; j < m; j += blockDim.x) slot_out[j] = -1;
  int seq = *seq_in;
  __syncthreads();

  const unsigned long long none = ~0ull;
  for (int j = 0; j < m; ++j) {
    if (!mask[j]) continue;               // uniform: every thread reads it
    const int lj = lid[j];
    unsigned long long kdup = none, kfree = none, kold = none;
    for (int i = t; i < s; i += blockDim.x) {
      const unsigned long long key = (unsigned long long)i;
      if (tvalid[i]) {
        if (tlid[i] == lj && key < kdup) kdup = key;
        // stamps are >= 0 (seq counts up from 0): unsigned order is theirs
        const unsigned long long ko =
            ((unsigned long long)(unsigned)tstamp[i] << 32) | key;
        if (ko < kold) kold = ko;
      } else if (key < kfree) {
        kfree = key;
      }
    }
    kdup = warp_min(kdup);
    kfree = warp_min(kfree);
    kold = warp_min(kold);
    if (lane == 0) {
      red[0][warp] = kdup;
      red[1][warp] = kfree;
      red[2][warp] = kold;
    }
    __syncthreads();
    if (t == 0) {
      for (int w = 1; w < nwarps; ++w) {
        kdup = red[0][w] < kdup ? red[0][w] : kdup;
        kfree = red[1][w] < kfree ? red[1][w] : kfree;
        kold = red[2][w] < kold ? red[2][w] : kold;
      }
      const int slot = kdup != none    ? (int)kdup
                       : kfree != none ? (int)kfree
                                       : (int)(kold & 0xffffffffull);
      tvalid[slot] = 1;
      tstamp[slot] = seq;
      tlid[slot] = lj;
      tsrc[slot] = j;
      slot_out[j] = slot;
    }
    ++seq;
    __syncthreads();
  }
  for (int i = t; i < s; i += blockDim.x) {
    valid_out[i] = tvalid[i] != 0;
    stamp_out[i] = tstamp[i];
    src_out[i] = tsrc[i];
  }
  if (t == 0) *seq_out = seq;
}

// ---------------------------------------------------------------------------
// gftt_greedy_nms
//
// kept[i] = cand[i] & !any(kept[j] & close(i, j), j < i), in index (response)
// order, close(i, j) = (dx*dx + dy*dy) < min_dist2 in float32 as the plain
// version rounds it (no FMA contraction); then raw_rank = inclusive prefix
// sum of kept - 1.
//
// Each thread owns corners t, t + blockDim, ... and their kept flags; at
// step i the owners of earlier kept corners test them against corner i and
// one __syncthreads_or decides.
// ---------------------------------------------------------------------------

__global__ void gftt_greedy_nms_kernel(const float* __restrict__ pix,
                                       const bool* __restrict__ cand, int k,
                                       float min_dist2,
                                       bool* __restrict__ kept_out,
                                       int* __restrict__ rank_out,
                                       int* __restrict__ launches) {
  extern __shared__ float shf[];
  float* px = shf;                       // k
  float* py = px + k;                    // k
  int* kept = (int*)(py + k);            // k
  __shared__ int warp_sum[kWarps];
  __shared__ int carry;

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = (blockDim.x + 31) >> 5;
  if (t == 0) {
    atomicAdd(launches, 1);
    carry = 0;
  }
  for (int i = t; i < k; i += blockDim.x) {
    px[i] = pix[2 * i];
    py[i] = pix[2 * i + 1];
    kept[i] = 0;
  }
  __syncthreads();

  for (int i = 0; i < k; ++i) {
    if (!cand[i]) continue;               // uniform: every thread reads it
    const float xi = px[i], yi = py[i];
    int clash = 0;
    for (int j = t; j < i; j += blockDim.x) {
      if (kept[j]) {
        const float dx = __fsub_rn(xi, px[j]);
        const float dy = __fsub_rn(yi, py[j]);
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        clash |= d2 < min_dist2;
      }
    }
    // the owner of i writes kept[i]; only the owner reads it later
    if (!__syncthreads_or(clash) && t == i % blockDim.x) kept[i] = 1;
  }
  __syncthreads();

  // inclusive prefix sum of kept, blockDim corners per pass
  for (int base = 0; base < k; base += blockDim.x) {
    const int i = base + t;
    const int v = i < k ? kept[i] : 0;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (t == 0) {
      int acc = 0;
      for (int w = 0; w < nwarps; ++w) {
        const int ws = warp_sum[w];
        warp_sum[w] = acc;
        acc += ws;
      }
    }
    __syncthreads();
    const int c = carry;
    if (i < k) {
      kept_out[i] = v != 0;
      rank_out[i] = c + warp_sum[warp] + x - 1;
    }
    __syncthreads();
    if (t == blockDim.x - 1) carry = c + warp_sum[warp] + x;
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// mask (m) bool, lid (m) int32; table valid (s) bool, tlid / stamp (s)
// int32, seq () int32 -> slot (m), src (s), valid (s), stamp (s), seq ();
// launches: the device counter this launch adds one to.
int cvms_store_slots(const void* mask, const void* lid, int m,
                     const void* valid, const void* tlid, const void* stamp,
                     const void* seq, int s, void* slot, void* src,
                     void* valid_out, void* stamp_out, void* seq_out,
                     void* launches, void* stream) {
  const int threads = s < 32 ? 32 : (s > kThreads ? kThreads
                                                  : ((s + 31) / 32) * 32);
  const size_t smem = 4 * (size_t)s * sizeof(int);
  store_slots_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      (const bool*)mask, (const int*)lid, m, (const bool*)valid,
      (const int*)tlid, (const int*)stamp, (const int*)seq, s, (int*)slot,
      (int*)src, (bool*)valid_out, (int*)stamp_out, (int*)seq_out,
      (int*)launches);
  return (int)cudaGetLastError();
}

// pix (k, 2) float32, cand (k) bool -> kept (k) bool, raw_rank (k) int32.
int cvms_gftt_greedy_nms(const void* pix, const void* cand, int k,
                         float min_dist2, void* kept, void* raw_rank,
                         void* launches, void* stream) {
  const int threads = k < 32 ? 32 : (k > kThreads ? kThreads
                                                  : ((k + 31) / 32) * 32);
  const size_t smem = 3 * (size_t)k * sizeof(float);
  gftt_greedy_nms_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pix, (const bool*)cand, k, min_dist2, (bool*)kept,
      (int*)raw_rank, (int*)launches);
  return (int)cudaGetLastError();
}

}  // extern "C"
