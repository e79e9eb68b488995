// Two sequential recurrences of the frame for Hopper (sm_90a): the
// stored-table slot policy of store_features and GFTT's greedy min-distance
// separation. Plain C interface, loaded with ctypes by
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
// pass: K = 768 corners, ~10 KB), 3 ns at 3.35 TB/s, and neither does more
// than K^2 / 2 = 0.3 M comparisons, 5 ns at 67 TFLOP/s. What bounds them is
// a chain of dependent steps, counted here in steps:
//
// * store_slots: a record's slot depends on the table the record before it
//   left, so the chain has one step per STORED record (2 on a config-3
//   frame that stores, ~170 on a full table with 30 % of 576 stored).
//   Design: the records that are not stored are no steps. One block
//   compacts the stored ones (index and lid, in record order) into shared
//   memory with a ballot and a popc prefix per 32 records, and then ONE
//   warp walks them, holding the table in registers (lane l: slots l,
//   l + 32, ...; in shared memory above S = 1024). Each step is one warp
//   minimum of a priority key per slot, (class 0, slot) for a valid slot
//   holding the record's lid, (class 1, slot) for a free one, (class 2,
//   stamp, slot) for any other: the smallest is the first dup, else the
//   first free slot, else the oldest, ties to the lower slot. It is taken
//   as one __reduce_min_sync of the 32-bit (class, stamp) part and a
//   ballot per 32 slots for the lowest slot that holds it; a table in
//   shared memory takes the 64-bit key in two __reduce_min_sync instead
//   (pick_slot). The owner lane of the winning slot updates it by
//   selects. No block barrier is in the chain.
// * gftt_greedy_nms: a corner's fate depends on every corner kept before
//   it, but the pair tests do not, so they go first, in parallel, into a
//   clash bitmask (phase A: row i, word w: bit b set when corner 32w + b
//   comes after i and lies within min_dist of it; one ballot per row and
//   word). The chain (phase B) then settles 32 corners per step in one
//   warp: ceil(K / 32) word-steps (24 at K = 768), where the first version
//   waited on a block barrier per corner. In a step the warp walks, in
//   order, only the alive corners whose in-word row clears another alive
//   one (most words have none or a few), and every lane clears the kept
//   rows from its own later words of the alive set. Phase C: ranks from
//   popc of the kept words.
//   Where the mask lives: for K <= GREEDY_ONE_BLOCK_MAX_K (vision.py) one
//   block does all three phases with the mask in shared memory. Above, the
//   pair tests of one block would take longer than the chain, so phase A
//   is spread over a grid, a warp per 32 x 32 task, into a scratch tensor
//   of the wrapper (L2-resident: 74 KB at K = 768, 2.1 MB at K = 4096); the
//   last block to arrive copies it into its shared memory when it fits
//   (K <= 1344: 226,464 of the 227 KB a block may hold) and resolves it
//   there, else reads it from the scratch.
//
// Launch counts: both kernels run inside conditional bodies of a captured
// graph (the store branch of update_features; the detect branch when
// detection is gated per frame), where the host cannot see whether they
// ran. So thread 0 of block 0 of each launch adds one to a device counter
// the wrapper passes in (vision.device_counts reads them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

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
// The priority key of a slot: class in bits 63-62, stamp in 61-31 (stamps
// are int32 >= 0: seq counts up from 0), slot in 30-0. Exact for every
// such stamp and every S < 2^31.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned long long slot_key(bool valid, int tlid,
                                                       int stamp, int lj,
                                                       int slot) {
  const unsigned long long s = (unsigned)slot;
  if (!valid) return (1ull << 62) | s;
  if (tlid == lj) return s;
  return (2ull << 62) | ((unsigned long long)(unsigned)stamp << 31) | s;
}

// The same order without the slot, in 32 bits: 0 a dup, 1 a free slot,
// stamp + 2 any other valid slot (<= 2^31 + 1).
__device__ __forceinline__ unsigned class_key(bool valid, int tlid, int stamp,
                                              int lj) {
  if (!valid) return 1u;
  if (tlid == lj) return 0u;
  return (unsigned)stamp + 2u;
}

// The warp's smallest slot_key, in two __reduce_min_sync: the high words,
// then the low words of the lanes holding the high minimum.
__device__ __forceinline__ unsigned long long warp_min_key(
    unsigned long long key) {
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned hmin = __reduce_min_sync(kFull, hi);
  const unsigned lmin = __reduce_min_sync(kFull, hi == hmin ? lo : ~0u);
  return ((unsigned long long)hmin << 32) | lmin;
}

// The table of one warp: lane l owns slots l + 32 q. In registers for
// S <= 32 * SQ ...
template <int SQ>
struct RegTable {
  static constexpr int kThreads = SQ <= 4 ? 1024 : 256;  // registers a thread
  static constexpr bool kInRegisters = true;
  int valid[SQ], lid[SQ], stamp[SQ], src[SQ];
  __device__ RegTable(int*, int) {}
  __device__ static constexpr int nq() { return SQ; }
  __device__ int& v(int q) { return valid[q]; }
  __device__ int& l(int q) { return lid[q]; }
  __device__ int& st(int q) { return stamp[q]; }
  __device__ int& sr(int q) { return src[q]; }
  // the owner lane's update, by selects (no branch)
  __device__ void set(int qs, int lj, int seq, int j) {
#pragma unroll
    for (int q = 0; q < SQ; ++q) {
      const bool hit = q == qs;
      valid[q] = hit ? 1 : valid[q];
      lid[q] = hit ? lj : lid[q];
      stamp[q] = hit ? seq : stamp[q];
      src[q] = hit ? j : src[q];
    }
  }
};

// ... and in shared memory above: 4 arrays of 32 ceil(S / 32) ints.
struct SharedTable {
  static constexpr int kThreads = 1024;
  static constexpr bool kInRegisters = false;
  int *valid, *lid, *stamp, *src;
  int nq_, lane;
  __device__ SharedTable(int* sh, int s)
      : nq_((s + 31) / 32), lane(threadIdx.x & 31) {
    const int n = 32 * nq_;
    valid = sh;
    lid = sh + n;
    stamp = sh + 2 * n;
    src = sh + 3 * n;
  }
  __device__ int nq() const { return nq_; }
  __device__ int& v(int q) { return valid[32 * q + lane]; }
  __device__ int& l(int q) { return lid[32 * q + lane]; }
  __device__ int& st(int q) { return stamp[32 * q + lane]; }
  __device__ int& sr(int q) { return src[32 * q + lane]; }
  __device__ void set(int qs, int lj, int seq, int j) {
    if (qs < 0) return;
    v(qs) = 1;
    l(qs) = lj;
    st(qs) = seq;
    sr(qs) = j;
  }
};

// The slot record lid lj takes: the table's smallest priority key. A table
// in registers takes the minimum of the 32-bit class_key, then the lowest
// slot holding it by one ballot per 32 slots; a table in shared memory
// takes the 64-bit slot_key by warp_min_key (a ballot per 32 slots, each
// reloading its slots, is the slower there).
template <class Table>
__device__ __forceinline__ int pick_slot(Table& tab, int lj, int s,
                                         int lane) {
  if constexpr (Table::kInRegisters) {
    unsigned best = ~0u;
#pragma unroll
    for (int q = 0; q < tab.nq(); ++q) {
      const unsigned key = class_key(tab.v(q), tab.l(q), tab.st(q), lj);
      best = 32 * q + lane < s && key < best ? key : best;
    }
    const unsigned win = __reduce_min_sync(kFull, best);
    int slot = -1;  // the lowest q with a hit wins: q runs down
#pragma unroll
    for (int q = tab.nq() - 1; q >= 0; --q) {
      const unsigned b = __ballot_sync(
          kFull, 32 * q + lane < s &&
                     class_key(tab.v(q), tab.l(q), tab.st(q), lj) == win);
      slot = b ? 32 * q + __ffs(b) - 1 : slot;
    }
    return slot;
  } else {
    unsigned long long best = ~0ull;
#pragma unroll
    for (int q = 0; q < tab.nq(); ++q) {
      const int i = 32 * q + lane;
      const unsigned long long key =
          slot_key(tab.v(q), tab.l(q), tab.st(q), lj, i);
      best = i < s && key < best ? key : best;
    }
    return (int)(warp_min_key(best) & 0x7fffffffull);
  }
}

template <class Table>
__global__ void __launch_bounds__(Table::kThreads) store_slots_kernel(
    const bool* __restrict__ mask, const int* __restrict__ lid, int m,
    const bool* __restrict__ valid_in, const int* __restrict__ tlid_in,
    const int* __restrict__ stamp_in, const int* __restrict__ seq_in, int s,
    int* __restrict__ slot_out, int* __restrict__ src_out,
    bool* __restrict__ valid_out, int* __restrict__ stamp_out,
    int* __restrict__ seq_out, int* __restrict__ launches) {
  extern __shared__ int table_sh[];  // SharedTable only
  __shared__ int rec_j[Table::kThreads], rec_lid[Table::kThreads];
  __shared__ int warp_n[Table::kThreads / 32];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  if (t == 0) atomicAdd(launches, 1);

  Table tab(table_sh, s);
  int seq = 0;
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < tab.nq(); ++q) {
      const int i = 32 * q + lane;
      const bool in = i < s;
      tab.v(q) = in && valid_in[i];
      tab.l(q) = in ? tlid_in[i] : 0;
      tab.st(q) = in ? stamp_in[i] : 0;
      tab.sr(q) = -1;
    }
    seq = *seq_in;
  }

  for (int base = 0; base < m; base += blockDim.x) {
    // compaction: the stored records of this pass, in record order
    const int j = base + t;
    const bool in = j < m;
    const bool stored = in && mask[j];
    const int lj = stored ? lid[j] : 0;
    if (in && !stored) slot_out[j] = -1;
    const unsigned bits = __ballot_sync(kFull, stored);
    if (lane == 0) warp_n[warp] = __popc(bits);
    __syncthreads();
    int before = 0, n = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int c = warp_n[w];
      before += w < warp ? c : 0;
      n += c;
    }
    if (stored) {
      const int p = before + __popc(bits & ((1u << lane) - 1u));
      rec_j[p] = j;
      rec_lid[p] = lj;
    }
    __syncthreads();

    // the chain: one warp minimum per stored record, the next record's
    // index and lid loaded ahead
    if (warp == 0 && n > 0) {
      int jn = rec_j[0], ln = rec_lid[0];
      for (int r = 0; r < n; ++r) {
        const int jr = jn, lr = ln;
        if (r + 1 < n) {
          jn = rec_j[r + 1];
          ln = rec_lid[r + 1];
        }
        const int slot = pick_slot(tab, lr, s, lane);
        tab.set((slot & 31) == lane ? slot >> 5 : -1, lr, seq, jr);
        if (lane == 0) slot_out[jr] = slot;
        ++seq;
      }
    }
    __syncthreads();  // rec_j / rec_lid are refilled by the next pass
  }

  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < tab.nq(); ++q) {
      const int i = 32 * q + lane;
      if (i < s) {
        valid_out[i] = tab.v(q) != 0;
        stamp_out[i] = tab.st(q);
        src_out[i] = tab.sr(q);
      }
    }
    if (lane == 0) *seq_out = seq;
  }
}

template <class Table>
void launch_store(const void* mask, const void* lid, int m, const void* valid,
                  const void* tlid, const void* stamp, const void* seq, int s,
                  void* slot, void* src, void* valid_out, void* stamp_out,
                  void* seq_out, void* launches, cudaStream_t stream,
                  size_t smem) {
  store_slots_kernel<Table><<<1, Table::kThreads, smem, stream>>>(
      (const bool*)mask, (const int*)lid, m, (const bool*)valid,
      (const int*)tlid, (const int*)stamp, (const int*)seq, s, (int*)slot,
      (int*)src, (bool*)valid_out, (int*)stamp_out, (int*)seq_out,
      (int*)launches);
}

// ---------------------------------------------------------------------------
// gftt_greedy_nms
//
// kept[i] = cand[i] & !any(kept[j] & close(i, j), j < i), in index (response)
// order, close(i, j) = (dx*dx + dy*dy) < min_dist2 in float32 as the plain
// version rounds it (no FMA contraction; dx = xi - xj is exactly -(xj - xi),
// so close is symmetric bit for bit); then raw_rank = inclusive prefix sum
// of kept - 1.
//
// The mask, word-major: word w of row i at mask[w * pitch + i], pitch =
// 32 nw + 4 (nw = ceil(K / 32); the 4 stagger the word-columns across the
// shared-memory banks for 16-byte loads), written for w >= i / 32 only
// (what the chain reads); rows K .. 32 nw - 1 are 0.
// ---------------------------------------------------------------------------

constexpr int kGreedyThreads = 512;
constexpr int kGreedyTasksPerBlock = kGreedyThreads / 32;
constexpr int kGreedyMaxK = 4096;
constexpr int kGreedyMaxWords = kGreedyMaxK / 32;
constexpr int kMaskPad = 4;
constexpr int kMaskSmemWords = 42;  // nw whose mask fits in shared memory
constexpr size_t kMaskSmemBytes =
    (size_t)kMaskSmemWords * (32 * kMaskSmemWords + kMaskPad) *
    sizeof(uint32_t);

__host__ __device__ __forceinline__ size_t mask_words(int nw) {
  return (size_t)nw * (32 * nw + kMaskPad);
}

__device__ __forceinline__ bool close_rn(float xi, float yi, float xj,
                                         float yj, float min_dist2) {
  const float dx = __fsub_rn(xi, xj);
  const float dy = __fsub_rn(yi, yj);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < min_dist2;
}

// Phase A: the mask's words, a task at a time. A task is (row block rb,
// word w >= rb), 32 rows by 32 columns: 32 ballots, one per row, each
// testing the row's corner against the word's 32, and one coalesced store
// of the 32 words. Tasks, numbered row block by row block, are dealt to
// the warps of all blocks in turn (one each at kGreedyTasksPerBlock).
__device__ void clash_rows(const float* __restrict__ pix, int k, int nw,
                           float min_dist2, uint32_t* mask) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int gw = blockIdx.x * nwarps + (threadIdx.x >> 5);
  const int pitch = 32 * nw + kMaskPad;
  const int tasks = nw * (nw + 1) / 2;
  int rb = 0, first = 0;  // row block rb's tasks: [first, first + nw - rb)
  for (int t = gw; t < tasks; t += gridDim.x * nwarps) {
    while (t >= first + nw - rb) first += nw - rb++;
    const int w = rb + t - first;
    const int i = 32 * rb + lane, j = 32 * w + lane;
    const float xi = i < k ? pix[2 * i] : 0.f;
    const float yi = i < k ? pix[2 * i + 1] : 0.f;
    const float xj = j < k ? pix[2 * j] : 0.f;
    const float yj = j < k ? pix[2 * j + 1] : 0.f;
    const unsigned live = __ballot_sync(kFull, j < k);
    uint32_t row = 0;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const float x = __shfl_sync(kFull, xi, r);
      const float y = __shfl_sync(kFull, yi, r);
      uint32_t bits =
          __ballot_sync(kFull, close_rn(x, y, xj, yj, min_dist2)) & live;
      if (w == rb) bits &= r == 31 ? 0u : ~0u << (r + 1);
      row = lane == r ? bits : row;
    }
    mask[w * pitch + i] = i < k ? row : 0u;
  }
}

// A load of the mask: from global memory through L2 (ld.global.cg: the
// other blocks of the launch wrote it), else from shared memory.
template <bool kGlobal, class T>
__device__ __forceinline__ T load_mask(const T* p) {
  if constexpr (kGlobal) return __ldcg(p);
  else return *p;
}

// The 32 words of rows 32 w .. 32 w + 31 in word-column c, as 8 16-byte
// loads.
template <bool kGlobal>
__device__ __forceinline__ void load_rows(const uint32_t* mask, int pitch,
                                          int c, int w, uint32_t (&v)[32]) {
  const uint4* p = reinterpret_cast<const uint4*>(mask + c * pitch + 32 * w);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint4 u = load_mask<kGlobal>(p + e);
    v[4 * e] = u.x;
    v[4 * e + 1] = u.y;
    v[4 * e + 2] = u.z;
    v[4 * e + 3] = u.w;
  }
}

// OR of the rows v[b] whose bit b is set in kw (four accumulators).
__device__ __forceinline__ uint32_t or_kept(uint32_t kw,
                                            const uint32_t (&v)[32]) {
  uint32_t acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    if (kw & (1u << b)) acc[b & 3] |= v[b];
  }
  return (acc[0] | acc[1]) | (acc[2] | acc[3]);
}

// Phase B, one warp: the word-serial chain. Lane l holds words l + 32 q of
// the alive set (candidates not removed yet). Step w: the owner's word is
// broadcast; lane b loads the in-word row of corner 32 w + b, and the warp
// walks, in order, only the alive corners whose row clears another alive
// one (one ballot finds them; most words have none or a few), fetching
// each row by a shuffle; then each lane clears the kept rows' bits from its
// own later words. The loads of a step do not wait on its chain: the mask
// is fixed. keptw[w] and base[w] (kept corners before word w) go to shared
// memory at the end. kGlobal: the mask is the grid's scratch in global
// memory, read through L2.
template <int NQ, bool kGlobal>
__device__ void resolve_words(const uint32_t* mask, int nw,
                              const uint32_t* cw, uint32_t* keptw,
                              int* base) {
  const int lane = threadIdx.x & 31;
  const int pitch = 32 * nw + kMaskPad;
  uint32_t alive[NQ], keep[NQ];
  int before[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int w = 32 * q + lane;
    alive[q] = w < nw ? cw[w] : 0u;
    keep[q] = 0;
    before[q] = 0;
  }
  int running = 0;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    for (int o = 0; o < 32; ++o) {
      const int w = 32 * q + o;
      if (w >= nw) break;
      const int mine = 32 * q + lane;  // this lane's word in block q
      const bool later = lane > o && mine < nw;
      const uint32_t row =
          load_mask<kGlobal>(mask + w * pitch + 32 * w + lane);
      uint32_t cross[32];  // read by every lane, used by the later ones
      load_rows<kGlobal>(mask, pitch, mine < nw ? mine : w, w, cross);
      uint32_t a = __shfl_sync(kFull, alive[q], o);
      uint32_t c = __ballot_sync(kFull, (a >> lane & 1u) && (row & a));
      while (c) {
        const int b = __ffs(c) - 1;  // alive: keep it, clear its row
        a &= ~__shfl_sync(kFull, row, b);
        c &= a & (~1u << b);
      }
      keep[q] = lane == o ? a : keep[q];
      before[q] = lane == o ? running : before[q];
      running += __popc(a);
      alive[q] &= ~(or_kept(a, cross) & (later ? ~0u : 0u));
#pragma unroll
      for (int q2 = q + 1; q2 < NQ; ++q2) {
        const int w2 = 32 * q2 + lane;
        if (w2 < nw) {
          load_rows<kGlobal>(mask, pitch, w2, w, cross);
          alive[q2] &= ~or_kept(a, cross);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int w = 32 * q + lane;
    if (w < nw) {
      keptw[w] = keep[q];
      base[w] = before[q];
    }
  }
}

// gmask == nullptr: one block, the mask in shared memory. Otherwise the
// blocks write their tasks' words to gmask, and the last to arrive
// (arrive: a device counter, reset by that block) runs phases B and C.
// The counter is shared by every grid launch on its device, so those
// launches must be stream-ordered (vision._greedy_arrivals).
template <int NQ>
__global__ void __launch_bounds__(kGreedyThreads, 1) gftt_greedy_nms_kernel(
    const float* __restrict__ pix, const bool* __restrict__ cand, int k,
    float min_dist2, uint32_t* gmask, int* arrive, bool* __restrict__ kept_out,
    int* __restrict__ rank_out, int* __restrict__ launches) {
  extern __shared__ uint4 smask4[];
  uint32_t* smask = reinterpret_cast<uint32_t*>(smask4);
  __shared__ uint32_t cw[kGreedyMaxWords], keptw[kGreedyMaxWords];
  __shared__ int base[kGreedyMaxWords];
  __shared__ int last;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nw = (k + 31) / 32;
  if (t == 0 && blockIdx.x == 0) atomicAdd(launches, 1);

  if (gmask == nullptr) {
    clash_rows(pix, k, nw, min_dist2, smask);
  } else {
    clash_rows(pix, k, nw, min_dist2, gmask);
    __threadfence();
    __syncthreads();
    if (t == 0) last = atomicAdd(arrive, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (t == 0) *arrive = 0;  // ready for the next launch (graph replays)
    if (nw <= kMaskSmemWords) {  // into shared memory, 8 loads in flight
      const int n = (int)(mask_words(nw) / 4), step = blockDim.x;
      const uint4* g4 = reinterpret_cast<const uint4*>(gmask);
      for (int e0 = t; e0 < n; e0 += 8 * step) {
        uint4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (e0 + u * step < n) v[u] = __ldcg(g4 + e0 + u * step);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (e0 + u * step < n) smask4[e0 + u * step] = v[u];
        }
      }
    }
  }
  for (int w = warp; w < nw; w += nwarps) {
    const int j = 32 * w + lane;
    const uint32_t c = __ballot_sync(kFull, j < k && cand[j]);
    if (lane == 0) cw[w] = c;
  }
  __syncthreads();

  if (warp == 0) {  // the mask's own pointer: shared loads where it can
    if (nw <= kMaskSmemWords)
      resolve_words<NQ, false>(smask, nw, cw, keptw, base);
    else
      resolve_words<NQ, true>(gmask, nw, cw, keptw, base);
  }
  __syncthreads();

  // Phase C: kept flags and ranks from the kept words
  for (int i = t; i < k; i += blockDim.x) {
    const int w = i >> 5, b = i & 31;
    const uint32_t kw = keptw[w];
    kept_out[i] = (kw >> b) & 1u;
    rank_out[i] = base[w] + __popc(kw & (kFull >> (31 - b))) - 1;
  }
}

template <int NQ>
void launch_greedy(const void* pix, const void* cand, int k, float min_dist2,
                   void* kept, void* raw_rank, void* scratch, void* arrive,
                   void* launches, int blocks, size_t smem,
                   cudaStream_t stream) {
  gftt_greedy_nms_kernel<NQ><<<blocks, kGreedyThreads, smem, stream>>>(
      (const float*)pix, (const bool*)cand, k, min_dist2, (uint32_t*)scratch,
      (int*)arrive, (bool*)kept, (int*)raw_rank, (int*)launches);
}

// The greedy kernel asks for up to kMaskSmemBytes of dynamic shared memory
// (above the 48 KB default): allowed once per device, at its first call,
// which the eager warm-up frame before any capture makes.
cudaError_t allow_greedy_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  const int bytes = (int)kMaskSmemBytes;
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if ((err = cudaFuncSetAttribute(gftt_greedy_nms_kernel<1>, a, bytes)) ||
      (err = cudaFuncSetAttribute(gftt_greedy_nms_kernel<2>, a, bytes)) ||
      (err = cudaFuncSetAttribute(gftt_greedy_nms_kernel<3>, a, bytes)) ||
      (err = cudaFuncSetAttribute(gftt_greedy_nms_kernel<4>, a, bytes)))
    return err;
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
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
  const cudaStream_t st = (cudaStream_t)stream;
  const int sq = (s + 31) / 32;
#define CVMS_STORE(T, SMEM)                                                 \
  launch_store<T>(mask, lid, m, valid, tlid, stamp, seq, s, slot, src,     \
                  valid_out, stamp_out, seq_out, launches, st, SMEM)
  if (sq <= 1) CVMS_STORE(RegTable<1>, 0);
  else if (sq <= 2) CVMS_STORE(RegTable<2>, 0);
  else if (sq <= 4) CVMS_STORE(RegTable<4>, 0);
  else if (sq <= 8) CVMS_STORE(RegTable<8>, 0);
  else if (sq <= 16) CVMS_STORE(RegTable<16>, 0);
  else if (sq <= 32) CVMS_STORE(RegTable<32>, 0);
  else {
    const size_t smem = 4 * (size_t)(32 * sq) * sizeof(int);
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(store_slots_kernel<SharedTable>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    CVMS_STORE(SharedTable, smem);
  }
#undef CVMS_STORE
  return (int)cudaGetLastError();
}

// pix (k, 2) float32, cand (k) bool -> kept (k) bool, raw_rank (k) int32.
// scratch: NULL for one block with the mask in shared memory (k <= 1344),
// else nw * (32 * nw + 4) int32 words, nw = ceil(k / 32), and one block per
// 16 tasks of phase A; arrive: an int32 device counter at 0, left at 0.
int cvms_gftt_greedy_nms(const void* pix, const void* cand, int k,
                         float min_dist2, void* kept, void* raw_rank,
                         void* scratch, void* arrive, void* launches,
                         void* stream) {
  const int nw = (k + 31) / 32;
  if (k < 0 || k > kGreedyMaxK || (!scratch && nw > kMaskSmemWords))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_greedy_smem();
  if (err != cudaSuccess) return (int)err;
  const int tasks = nw * (nw + 1) / 2;
  const int blocks =
      scratch && nw > 0
          ? (tasks + kGreedyTasksPerBlock - 1) / kGreedyTasksPerBlock
          : 1;
  const size_t smem =
      nw <= kMaskSmemWords ? mask_words(nw) * sizeof(uint32_t) : 0;
  const int nq = nw <= 32 ? 1 : (nw + 31) / 32;
  const cudaStream_t st = (cudaStream_t)stream;
  if (nq == 1)
    launch_greedy<1>(pix, cand, k, min_dist2, kept, raw_rank, scratch, arrive,
                     launches, blocks, smem, st);
  else if (nq == 2)
    launch_greedy<2>(pix, cand, k, min_dist2, kept, raw_rank, scratch, arrive,
                     launches, blocks, smem, st);
  else if (nq == 3)
    launch_greedy<3>(pix, cand, k, min_dist2, kept, raw_rank, scratch, arrive,
                     launches, blocks, smem, st);
  else
    launch_greedy<4>(pix, cand, k, min_dist2, kept, raw_rank, scratch, arrive,
                     launches, blocks, smem, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
