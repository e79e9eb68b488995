// Vision hot-loop kernels for Hopper (sm_90a): zero-mean NCC active search,
// bilinear patch warp, and the two fused with the region gather into one
// launch (the one the matcher runs). Plain C interface, loaded with ctypes
// by cv_monoslam_tpu_torch/ops/_build.py; each entry point launches on the
// stream it is given and returns cudaGetLastError() of its launch.
//
// Every kernel computes the same function as its plain PyTorch version in
// cv_monoslam_tpu_torch/ops/vision.py (ncc_score_map_ref, warp_bilinear_ref,
// warp_ncc_score_map_ref), which chip_smoke.py holds it against on the card.
//
// Launch counts: a launch captured in a CUDA graph runs on every replay
// without a call of its wrapper, so thread 0 of block 0 of every launch adds
// one to the int32 device counter the wrapper passes in
// (vision.device_counts reads them). The stage marks at the end of the file
// time a frame's stages on the device (vision.stage_times reads them).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// NCC score map
//
// Replaces cv_monoslam_tpu/ops/pallas_vision.py::ncc_score_map: the kernel
// body _ncc_kernel AND the template normalization its wrapper does before
// the call. For each landmark m, with raw template p (pm, pm) and search
// region reg (rg, rg), rg = w1 + pm - 1:
//
//   c           = (p - mean(p)) - mean(p - mean(p))        centred twice
//   p_hat       = c / sqrt(sum c^2), or 0 for a flat template
//   num[oy,ox]  = sum_{py,px} p_hat[py,px] * reg[oy+py, ox+px]
//   wsum, wsq   = window sum and sum of squares of reg over the same taps
//   wvar        = max(wsq - wsum^2 / n, 0)
//   score       = num / sqrt(wvar), or 0 where sqrt(wvar) == 0
//
// One launch does all of it; p_hat is also written out (second output) so
// that the normalization and the score arithmetic can be checked apart.
//
// What bounds it on an H100. Bytes (M = 576): regions 3.15 MB + templates
// 0.67 MB + scores 1.02 MB, 1.4 us at 3.35 TB/s. Operations: 2*289*441*M
// ~ 147 MFLOP of FP32 multiply-add plus the separable window sums, 2.6 us at
// 67 TFLOP/s. So the bound is operations, a few microseconds, and below it
// sits the card's launch floor: a kernel that does nothing reads 0.0048 ms
// when timed as this one is (empty_kernel at the end of this file;
// chip_smoke.py prints it as launch_floor_ms). The first version of this
// kernel (one thread per offset, every tap two shared-memory loads for one
// multiply-add, wsum and wsq recomputed by every thread, the template
// normalized by eight torch launches before it) was bound by shared-memory
// loads and by those launches: 0.038 / 0.067 ms at M = 32 / 576. This one
// read 0.010 / 0.016 ms with FMA taps and reads 0.0118 / 0.0183 ms with the
// taps rounded as the plain version rounds them (H100 80GB HBM3 at 700 W,
// chip_smoke.py, both in one call); what is left above the floor is a chain
// of short phases (copy in, normalize, column sums, window sums) that each
// wait on memory or on a barrier, and the tap loop.
//
// Design.
// * Mapping. The TPU kernel puts landmarks on the 128-wide lane axis for
//   its vector unit. Here a block owns one landmark; in the tap loop a
//   thread owns a 1 x TW strip of neighbouring offsets of one output row, so
//   a landmark takes w1 * ceil(w1 / TW) = 63 threads there at the default
//   shape.
// * Taps from registers. Per template row a thread loads the row's pm
//   template values (16-byte broadcast loads from rows padded to a multiple
//   of 4) and its pm + TW - 1 region values into registers once and does
//   TW * pm multiply-adds on them: (5 + 23) / 119 = 0.24 shared-memory
//   loads per multiply-add instead of 2. Threads of a warp take neighbouring
//   rows and the region's row pitch is odd, so its scalar loads are free of
//   bank conflicts but for a few two-way ones where a warp wraps to the next
//   strip. 16-byte region loads would need strips that start on a multiple
//   of 4, that is TW = 8 and 24 columns for 21 offsets: 14 % more
//   multiply-adds for the same shared-memory traffic.
// * Window sums separably, in the plain version's order and with every
//   operation rounded on its own, so that wsum and wsq round exactly as in
//   ncc_score_map_ref: column sums cs and cs2 over the px window once per
//   staged region row (a sliding window of TW values in registers), then a
//   phase of its own that adds pm of them per offset, each task loading a
//   column sum once for WG neighbouring rows. (Added inside the tap loop,
//   every thread reloaded pm column sums per offset and shared-memory
//   traffic bound the loop at M = 576: wrapper 0.0164 ms against 0.0157.)
// * Template normalization in a fixed order. Every warp reduces the whole
//   template itself: lane-strided partial sums, then an xor-shuffle tree,
//   which leaves the same bits in every lane of every warp in every run. No
//   atomics, no cross-warp exchange, so no barrier inside the reduction. It
//   runs while the region's copies are still in flight.
// * Blocks. A block owns its whole landmark, so the region is staged once,
//   and has one thread per column-sum task (rg * 3 = 111 -> 128 threads):
//   576 blocks at M = 576, 4-5 resident on each of the 132 SMs, and 32
//   blocks at M = 32. The other split that was tried, a grid of (M, 3) in
//   which a block owns a band of 7 output rows and stages the 23 region rows
//   it needs (96 blocks at M = 32), was no faster, because a thread's serial
//   work, not the number of SMs in use, sets the time there: kernel only,
//   M = 32, 0.0103 ms whole against 0.0106 ms in bands; M = 576, 0.0156
//   against 0.0216 ms (H100 80GB HBM3 at 700 W, both timed by a version of
//   chip_smoke.py that could launch either). The bands were taken out.
// * Taps rounded as the plain version rounds them. num += p_hat * reg is a
//   product and a sum rounded on their own (torch's separate mul and add),
//   not an FMA: the partial sums of a zero-mean template run up to ~10^3
//   while the final num can be far smaller, and on a low-texture window
//   sqrt(wvar) is small, so the FMA's other rounding reached 3.1e-5 in a
//   score on config-4 frames (the 2e-5 the check allows on the kernel's own
//   p_hat). With both roundings the scores on a given p_hat are the plain
//   version's bits.
// * Shapes. pm and w1 are template parameters; <17, 21> is the shape every
//   configuration uses and unrolls the px loops. <0, 0> is the same kernel
//   with run-time bounds for any other shape (taps in chunks of 4).
//
// Deliberately not used. Tensor cores / wgmma: each landmark's product is a
// (441 x 289) by (289 x 1) matrix-vector product in full float32 against
// its own template; no operand is shared between landmarks, so there is no
// tile to form, and TF32 would break the 1e-4 tolerance. TMA and multi-stage
// cp.async rings: a block stages one 5.5 KB region and one 1.2 KB template
// once; there is no second tile whose load could overlap compute. Plain
// cp.async is used for that one staging, because it measured faster
// (0.0153 -> 0.0117 ms at M = 32 with load-then-store pairs replaced).
//
// The main path runs these phases inside warp_ncc_score_map_kernel (below),
// on a template it warps itself and a region it copies from the frame;
// ncc_score_map_kernel stays as the counterpart of pallas_vision.
// ncc_score_map and of the port's public vision.ncc_score_map.
// ---------------------------------------------------------------------------

constexpr int TW = 7;   // offsets per thread: a 1 x TW strip of an output row
constexpr int WG = 4;   // output rows per window-sum task (one column each)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// The NCC arithmetic exists once, as the device functions below; both
// ncc_score_map_kernel and warp_ncc_score_map_kernel (further down) are a
// staging prologue followed by calls of them.
//
// Sizes of one landmark's problem. With PM, W1 > 0 every field is a
// compile-time constant; <0, 0> takes pm and w1 at run time. With
// C = TW * ceil(w1 / TW), tp = pm rounded up to a multiple of 4 and
// pitch = (C + tp - 1) | 1, a block's dynamic shared memory holds
// (vision.ncc_launch_plan computes the same):
//   float  ph[pm][tp]       normalized template, rows zero-padded
//   float2 cs[rg][C]        column sums (.x) and sums of squares (.y)
//   float2 ws[w1][C]        window sums
//   float  reg[rg][pitch]   region rows, pad columns zeroed
//   float  tpl[pm*pm]       raw template
template <int PM, int W1>
struct NccShape {
  int pm, w1, rg, n_tap, ntx, csw, tp, pitch;
  __device__ __forceinline__ NccShape(int pm_rt, int w1_rt)
      : pm(PM > 0 ? PM : pm_rt),
        w1(W1 > 0 ? W1 : w1_rt),
        rg(w1 + pm - 1),
        n_tap(pm * pm),
        ntx((w1 + TW - 1) / TW),            // strips per output row
        csw(ntx * TW),
        tp((pm + 3) / 4 * 4),
        pitch((csw + tp - 1) | 1) {}
};

struct NccSmem {
  float* ph;
  float2* cs;
  float2* ws;
  float* reg;
  float* tpl;
  float* end;                               // first float past the layout
  template <class S>
  __device__ __forceinline__ NccSmem(float* base, const S& s) {
    ph = base;
    cs = reinterpret_cast<float2*>(ph + s.pm * s.tp);
    ws = cs + s.rg * s.csw;
    reg = reinterpret_cast<float*>(ws + s.w1 * s.csw);
    tpl = reg + s.rg * s.pitch;
    end = tpl + s.n_tap;
  }
};

// Start copying the region's rg rows, rg floats each, `stride` floats apart at
// `src`, into reg as cp.async copies of 4 bytes each (a region's origin is
// not 16-byte aligned). The caller commits the group.
template <class S>
__device__ __forceinline__ void ncc_stage_region(const S& s,
                                                 const NccSmem& sm,
                                                 const float* src,
                                                 size_t stride, int tid,
                                                 int nt) {
  for (int i = tid; i < s.rg * s.rg; i += nt) {
    const int r = i / s.rg;
    const int c = i - r * s.rg;
    __pipeline_memcpy_async(&sm.reg[r * s.pitch + c], &src[r * stride + c],
                            sizeof(float));
  }
}

// columns >= rg of a shared row feed only offsets >= w1, which are never
// stored, and taps past pm, which are skipped: zeroed to keep them finite;
// then the template rows' padding
template <class S>
__device__ __forceinline__ void ncc_zero_pads(const S& s, const NccSmem& sm,
                                              int tid, int nt) {
  for (int r = tid; r < s.rg; r += nt)
    for (int c = s.rg; c < s.pitch; ++c) sm.reg[r * s.pitch + c] = 0.0f;
  for (int py = tid; py < s.pm; py += nt)
    for (int px = s.pm; px < s.tp; ++px) sm.ph[py * s.tp + px] = 0.0f;
}

// Template statistics, the same bits in every lane of every warp; centred
// twice so that sum(p_hat) is at the roundoff of one value, not of n_tap.
// Reads the whole raw template (the caller's barrier makes it visible),
// writes ph and, unless p_hat_m is null, the landmark's p_hat row.
template <class S>
__device__ __forceinline__ void ncc_normalize_template(const S& s,
                                                       const NccSmem& sm,
                                                       float* p_hat_m,
                                                       int tid, int nt) {
  const int lane = tid & 31;
  const float n = (float)s.n_tap;
  float acc = 0.0f;
#pragma unroll
  for (int i = lane; i < s.n_tap; i += 32) acc += sm.tpl[i];
  const float mean1 = warp_sum(acc) / n;
  acc = 0.0f;
#pragma unroll
  for (int i = lane; i < s.n_tap; i += 32) acc += sm.tpl[i] - mean1;
  const float mean2 = warp_sum(acc) / n;
  acc = 0.0f;
#pragma unroll
  for (int i = lane; i < s.n_tap; i += 32) {
    const float c = (sm.tpl[i] - mean1) - mean2;
    acc = fmaf(c, c, acc);
  }
  const float norm = sqrtf(warp_sum(acc));
  for (int i = tid; i < s.n_tap; i += nt) {
    const float c = (sm.tpl[i] - mean1) - mean2;
    const float v = norm > 0.0f ? c / norm : 0.0f;
    const int py = i / s.pm;
    sm.ph[py * s.tp + (i - py * s.pm)] = v;
    if (p_hat_m != nullptr) p_hat_m[i] = v;
  }
}

// Column sums, window sums, taps and scores, once ph and reg are in shared
// memory (the caller's barrier). Every thread of the block calls it; the
// first w1 * ntx threads go on to the taps and write the landmark's
// (w1, w1) scores at scores_m.
template <int PM, class S>
__device__ __forceinline__ void ncc_score_phases(const S& s,
                                                 const NccSmem& sm,
                                                 float* scores_m, int tid,
                                                 int nt) {
  const int pm = s.pm, w1 = s.w1, rg = s.rg, csw = s.csw, pitch = s.pitch;

  // column sums over the px window for every staged row, one 1 x TW strip
  // per task, in the plain version's order: cs = r0, cs2 = r0*r0, then
  // cs += r, cs2 += r*r for px = 1..pm-1, each operation rounded on its own
  for (int t = tid; t < rg * s.ntx; t += nt) {
    const int r = t % rg;
    const int c0 = (t / rg) * TW;
    const float* row = sm.reg + r * pitch + c0;
    float win[TW], a[TW], b[TW];
#pragma unroll
    for (int j = 0; j < TW; ++j) {
      win[j] = row[j];
      a[j] = win[j];
      b[j] = __fmul_rn(win[j], win[j]);
    }
#pragma unroll
    for (int px = 1; px < pm; ++px) {
#pragma unroll
      for (int j = 0; j < TW - 1; ++j) win[j] = win[j + 1];
      win[TW - 1] = row[px + TW - 1];
#pragma unroll
      for (int j = 0; j < TW; ++j) {
        a[j] = __fadd_rn(a[j], win[j]);
        b[j] = __fadd_rn(b[j], __fmul_rn(win[j], win[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < TW; ++j)
      sm.cs[r * csw + c0 + j] = make_float2(a[j], b[j]);
  }
  __syncthreads();

  // window sums: a task takes one column and WG neighbouring output rows,
  // loads each of the WG + pm - 1 column sums it needs once and adds it to
  // the rows it belongs to, py ascending as in the plain version. (Done in
  // the tap loop, every thread would load pm column sums per offset.)
  for (int t = tid; t < (w1 + WG - 1) / WG * csw; t += nt) {
    const int o0 = t / csw * WG;
    const int ox = t % csw;
    float sa[WG], sb[WG];
#pragma unroll
    for (int i = 0; i < WG; ++i) sa[i] = sb[i] = 0.0f;
#pragma unroll
    for (int r = 0; r < WG + pm - 1; ++r) {
      if (o0 + r < rg) {
        const float2 c = sm.cs[(o0 + r) * csw + ox];
#pragma unroll
        for (int i = 0; i < WG; ++i) {
          if (r - i >= 0 && r - i < pm) {
            sa[i] = __fadd_rn(sa[i], c.x);
            sb[i] = __fadd_rn(sb[i], c.y);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < WG; ++i)
      if (o0 + i < w1) sm.ws[(o0 + i) * csw + ox] = make_float2(sa[i], sb[i]);
  }
  __syncthreads();

  if (tid >= w1 * s.ntx) return;
  // neighbouring threads take neighbouring output rows (odd pitch: no bank
  // conflicts), then the next strip of columns
  const int oy = tid % w1;
  const int ox0 = (tid / w1) * TW;
  float num[TW];
#pragma unroll
  for (int j = 0; j < TW; ++j) num[j] = 0.0f;
  // taps whose operands are loaded into registers at once: a whole template
  // row for the compiled shape (as 16-byte broadcast loads), 4 at a time
  // under run-time bounds
  constexpr int KC = PM > 0 ? (PM + 3) / 4 * 4 : 4;
  // two template rows per loop body: the second row's loads start under the
  // first row's multiply-adds (with one row per body the compiler waits out
  // every load; the whole loop unrolled outgrows the instruction cache)
#pragma unroll 2
  for (int py = 0; py < pm; ++py) {
    const float* row = sm.reg + (oy + py) * pitch + ox0;
    const float4* trow = reinterpret_cast<const float4*>(sm.ph + py * s.tp);
    for (int px0 = 0; px0 < pm; px0 += KC) {
      float t[KC], r[KC + TW - 1];
#pragma unroll
      for (int q = 0; q < KC / 4; ++q) {
        const float4 v = trow[px0 / 4 + q];
        t[4 * q] = v.x;
        t[4 * q + 1] = v.y;
        t[4 * q + 2] = v.z;
        t[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int k = 0; k < KC + TW - 1; ++k)
        if (PM == 0 || k < PM + TW - 1) r[k] = row[px0 + k];
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (px0 + k < pm) {
#pragma unroll
          for (int j = 0; j < TW; ++j)
            num[j] = __fadd_rn(num[j], __fmul_rn(t[k], r[k + j]));
        }
      }
    }
  }

  const float inv_n = 1.0f / (float)s.n_tap;
  const float2* wrow = sm.ws + oy * csw + ox0;
  float* g_out = scores_m + oy * w1 + ox0;
  float sc[TW];
#pragma unroll
  for (int j = 0; j < TW; ++j) {
    const float2 w = wrow[j];             // (wsum, wsq)
    // wsq and wsum^2/n nearly cancel on a low-texture window; an FMA here
    // would round that difference otherwise than the plain version does, so
    // each step is rounded on its own
    const float wvar = fmaxf(
        __fsub_rn(w.y, __fmul_rn(__fmul_rn(w.x, w.x), inv_n)), 0.0f);
    const float den = sqrtf(wvar);
    sc[j] = den > 0.0f ? num[j] / den : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < TW; ++j)
    if (ox0 + j < w1) g_out[j] = sc[j];
}

// One block per landmark. blockDim.x is a multiple of 32 and >= w1 *
// ceil(w1 / TW); the wrapper gives rg * ceil(w1 / TW) threads rounded up, one
// per column-sum task, of which the first w1 * ceil(w1 / TW) go on to the
// taps.
template <int PM, int W1>
__global__ void ncc_score_map_kernel(const float* __restrict__ regions,
                                     const float* __restrict__ patches,
                                     float* __restrict__ scores,
                                     float* __restrict__ p_hat,
                                     int pm_rt, int w1_rt,
                                     int* __restrict__ launches) {
  const NccShape<PM, W1> s(pm_rt, w1_rt);
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (m == 0 && tid == 0) atomicAdd(launches, 1);
  extern __shared__ float4 smem4[];
  const NccSmem sm(reinterpret_cast<float*>(smem4), s);

  // Stage the raw template, then the region's rows (contiguous in
  // device memory), as two groups of asynchronous copies. All of a
  // thread's copies are in flight at once (as load-then-store pairs each
  // waited out a trip to device memory in turn), and the template is
  // normalized while the region is still on its way.
  const float* g_tpl = patches + (size_t)m * s.n_tap;
  for (int i = tid; i < s.n_tap; i += nt)
    __pipeline_memcpy_async(&sm.tpl[i], &g_tpl[i], sizeof(float));
  __pipeline_commit();
  ncc_stage_region(s, sm, regions + (size_t)m * s.rg * s.rg, (size_t)s.rg,
                   tid, nt);
  __pipeline_commit();
  ncc_zero_pads(s, sm, tid, nt);
  __pipeline_wait_prior(1);               // the template has landed
  __syncthreads();

  ncc_normalize_template(
      s, sm, p_hat != nullptr ? p_hat + (size_t)m * s.n_tap : nullptr, tid,
      nt);
  __pipeline_wait_prior(0);               // the region has landed
  __syncthreads();
  ncc_score_phases<PM>(s, sm, scores + (size_t)m * s.w1 * s.w1, tid, nt);
}

// ---------------------------------------------------------------------------
// Bilinear patch warp
//
// Replaces cv_monoslam_tpu/ops/pallas_vision.py::warp_bilinear (kernel body
// _warp_kernel). Each landmark's (Pi, Pi) init patch is resampled at the
// fractional coordinates (su, sv) of its (Po, Po) output grid. A sample is
// valid iff u0 >= 0, u0+1 <= Pi-1, v0 >= 0 and v0+1 <= Pi-1 (u0 = floor(su),
// v0 = floor(sv)); invalid samples are 0, so the last row/column of an
// identity grid is zeroed. Indices are clipped to Pi-2.
//
// Mapping: the TPU kernel builds one-hot row/column weight matrices and
// contracts them on the MXU only because the TPU gathers badly. Here one
// thread computes one output sample by a direct 4-tap gather
// (bilinear_sample, which the fused kernel below calls too).
//
// Bound on an H100 (M = 576): ~3.0 MB moved (patches 1.02 MB, su and sv
// 0.67 MB each, output 0.67 MB), ~0.9 us at 3.35 TB/s; ~15 FLOP per sample
// is negligible. That bound is below what any launch on the card takes, so
// the yardstick is the launch floor (empty_kernel below): timed the same
// way on an H100 80GB HBM3 at 700 W (chip_smoke.py), a launch that does
// nothing reads 0.0048 ms bare and 0.0049 ms after the output's torch.empty,
// this kernel 0.0056 ms at M = 32 and 0.0066 ms at M = 576, 1.16 and 1.36
// times the floor. Staging patches in shared memory could win back at most
// that 1.7 us. So the main path no longer launches this kernel: its warp
// runs inside warp_ncc_score_map_kernel, whose NCC phases consume the warped
// template from shared memory, and the launch is gone instead of shortened.
// The kernel stays as the counterpart of pallas_vision.warp_bilinear and of
// the port's public vision.warp_bilinear.
// ---------------------------------------------------------------------------

// One sample of a (pi, pi) patch p at column u, row v: 0 unless its 2x2
// neighbourhood lies inside the patch (also for a NaN coordinate), else
// p00*(1-du)*(1-dv) + p01*du*(1-dv) + p10*(1-du)*dv + p11*du*dv, left to
// right, each operation rounded on its own like the plain version's
// separate tensor ops.
__device__ __forceinline__ float bilinear_sample(const float* p, int pi,
                                                 float u, float v) {
  const float u0 = floorf(u);
  const float v0 = floorf(v);
  const float hi = (float)(pi - 1);
  const bool valid = (u0 >= 0.0f) && (u0 + 1.0f <= hi) && (v0 >= 0.0f) &&
                     (v0 + 1.0f <= hi);
  if (!valid) return 0.0f;
  const float du = __fsub_rn(u, u0);
  const float dv = __fsub_rn(v, v0);
  const int iu = min(max((int)u0, 0), pi - 2);
  const int iv = min(max((int)v0, 0), pi - 2);
  const float* q = p + iv * pi + iu;
  const float cu = __fsub_rn(1.0f, du);
  const float cv = __fsub_rn(1.0f, dv);
  float s = __fmul_rn(__fmul_rn(q[0], cu), cv);
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(q[1], du), cv));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(q[pi], cu), dv));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(q[pi + 1], du), dv));
  return s;
}

__global__ void warp_bilinear_kernel(const float* __restrict__ patches,
                                     const float* __restrict__ su,
                                     const float* __restrict__ sv,
                                     float* __restrict__ out,
                                     int m, int pi, int po,
                                     int* __restrict__ launches) {
  const long long total = (long long)m * po * po;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx == 0) atomicAdd(launches, 1);
  if (idx >= total) return;
  const int k = (int)(idx / ((long long)po * po));
  out[idx] = bilinear_sample(patches + (size_t)k * pi * pi, pi, su[idx],
                             sv[idx]);
}

// ---------------------------------------------------------------------------
// Warp + region + NCC in one launch
//
// Replaces, composed, cv_monoslam_tpu/ops/pallas_vision.py::warp_bilinear
// (:178), the region slice of cv_monoslam_tpu/frontend/matching.py::
// ncc_scores (:151-153) and pallas_vision.py::ncc_score_map (:92): what
// frontend/matching.py ran as warp_coords -> warp_bilinear -> gather_regions
// -> ncc_score_map. For landmark m, with A = warp matrix (2, 2) in the
// (dv, du) basis, hp_m = (pm - 1) / 2, hp_i = (w1 - 1) / 2:
//
//   sv[py,px]   = (hp_i + A00*dv) + A01*du,  dv = py - hp_m, du = px - hp_m
//   su[py,px]   = (hp_i + A10*dv) + A11*du   (every operation rounded alone)
//   warped      = bilinear_sample(init_patch[m], su, sv)     (pm, pm)
//   region      = frame[bv .. bv+rg-1, bu .. bu+rg-1],  (bu, bv) = base[m]
//   scores      = the NCC phases above on (region, warped)   (w1, w1)
//
// warped is also written out (the matcher stores accepted templates), and
// p_hat when asked for (the checks).
//
// Why fused. Alone, warp_bilinear's bound (0.05 / 0.9 us at M = 32 / 576)
// sits far below the card's launch floor (~0.005 ms), and it read 1.16-1.38
// times that floor; a standalone redesign could win back at most 1.7 us.
// The only design that moves it is to give the warp no launch of its own:
// its output is the NCC phases' input, so it runs in their block and the
// warped template never leaves shared memory before the NCC reads it. The
// region gather (torch index arithmetic and an (M, rg, rg) intermediate in
// device memory) goes the same way: the block copies its region straight
// from the frame. What the main path saves per tracked frame is the warp
// launch, ~15 torch operations (the coordinate arithmetic and the gather)
// and two wrapper calls' host time.
//
// Bound on an H100, counted per call: bytes = init patches, A, base, warped
// out, scores out, and the frame's region bytes once, min(M rg^2, H W)
// floats; operations = the NCC kernel's, plus 15 per warped sample and 4 per
// coordinate. At M = 576: 2.6 us (operations); at M = 32: 0.15 us. Like the
// NCC kernel, below the launch floor.
//
// Design, per block (one landmark, the NCC kernel's 128 threads at the
// default shape):
// 1. Both copies in flight first: the init patch (pi^2 floats) as one
//    cp.async group, the region's rg rows from the frame (row stride W, 4
//    bytes per copy: a region's origin is arbitrary) as a second.
// 2. Wait for the patch only; warp from shared memory while the region is
//    still arriving. A thread's samples are computed from A in registers:
//    no su / sv arrays are read from device memory. Written to the raw
//    template slot of the NCC layout and to `warped`.
// 3. The NCC phases, the same device functions as ncc_score_map_kernel
//    (normalization, wait for the region, column sums, window sums, taps),
//    so both kernels give the same bits on the same region and template.
// The layout is the NCC kernel's plus the init patch (pi^2 floats after it):
// 18.3 + 1.8 KB at the default shape (vision.warp_ncc_launch_plan).
// No tensor cores, for the NCC kernel's reason (a per-landmark FP32
// matrix-vector product; TF32 would break the score limit).
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 3, kernel
// only): 0.0118-0.0121 ms at M = 32 and 0.0168-0.0172 ms at M = 576, 2.4-2.5
// times the launch floor, where the chain it replaces (the coordinate
// arithmetic, warp_bilinear_kernel, the torch gather, ncc_score_map_kernel)
// took 0.055-0.058 / 0.067-0.071 ms of device time and 0.32-0.63 ms of host
// time per call. It is 1.4-1.7 us above ncc_score_map_kernel alone. With its
// inputs resident in L2 it reads the same within 0.4 us, so its copies'
// trips to device memory are not where that time goes, and TMA was not
// tried; loading the origin before the patch copy, so that the region copy
// does not wait on it, moved it by at most 0.1 us. What is left is the warp
// phase on the critical path (patch landed, samples, barrier, normalization).
// ---------------------------------------------------------------------------

template <int PM, int W1, int PI>
__global__ void warp_ncc_score_map_kernel(const float* __restrict__ image,
                                          const int* __restrict__ base,
                                          const float* __restrict__ A,
                                          const float* __restrict__ patches,
                                          float* __restrict__ scores,
                                          float* __restrict__ warped,
                                          float* __restrict__ p_hat,
                                          int img_h, int img_w, int pm_rt,
                                          int w1_rt, int pi_rt,
                                          int* __restrict__ launches) {
  const NccShape<PM, W1> s(pm_rt, w1_rt);
  const int pi = PI > 0 ? PI : pi_rt;
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (m == 0 && tid == 0) atomicAdd(launches, 1);
  extern __shared__ float4 smem4[];
  const NccSmem sm(reinterpret_cast<float*>(smem4), s);
  float* pat = sm.end;                    // the init patch (pi, pi)

  // 1. the region origin and the warp first (the region's copies wait on
  // the origin), then the init patch, then the region rows from the frame,
  // in flight. matching.region_origins clamps the origins into the frame
  // already; the clamp here only keeps any other base from reading outside.
  const int bu = min(max(base[2 * m], 0), img_w - s.rg);
  const int bv = min(max(base[2 * m + 1], 0), img_h - s.rg);
  const float a00 = A[4 * m], a01 = A[4 * m + 1];
  const float a10 = A[4 * m + 2], a11 = A[4 * m + 3];
  const float* g_pat = patches + (size_t)m * pi * pi;
  for (int i = tid; i < pi * pi; i += nt)
    __pipeline_memcpy_async(&pat[i], &g_pat[i], sizeof(float));
  __pipeline_commit();
  ncc_stage_region(s, sm, image + (size_t)bv * img_w + bu, (size_t)img_w,
                   tid, nt);
  __pipeline_commit();
  ncc_zero_pads(s, sm, tid, nt);
  __pipeline_wait_prior(1);               // the init patch has landed
  __syncthreads();

  // 2. the warp, into the raw template slot; the coordinates round as
  // vision.warp_sample_coords' separate torch operations do (no FMA: a
  // contracted a*b+c moves su / sv by an ulp and can flip floor())
  const int hp_m = (s.pm - 1) / 2;
  const float hp_i = (float)((s.w1 - 1) / 2);
  float* g_warp = warped + (size_t)m * s.n_tap;
  for (int i = tid; i < s.n_tap; i += nt) {
    const int py = i / s.pm;
    const float dv = (float)(py - hp_m);
    const float du = (float)(i - py * s.pm - hp_m);
    const float v =
        __fadd_rn(__fadd_rn(hp_i, __fmul_rn(a00, dv)), __fmul_rn(a01, du));
    const float u =
        __fadd_rn(__fadd_rn(hp_i, __fmul_rn(a10, dv)), __fmul_rn(a11, du));
    const float w = bilinear_sample(pat, pi, u, v);
    sm.tpl[i] = w;
    g_warp[i] = w;
  }
  __syncthreads();

  // 3. the NCC phases
  ncc_normalize_template(
      s, sm, p_hat != nullptr ? p_hat + (size_t)m * s.n_tap : nullptr, tid,
      nt);
  __pipeline_wait_prior(0);               // the region has landed
  __syncthreads();
  ncc_score_phases<PM>(s, sm, scores + (size_t)m * s.w1 * s.w1, tid, nt);
}

// ---------------------------------------------------------------------------
// Launch floor: a kernel that does nothing, launched through the same C
// interface. Its time, read the way the kernels' times are read, is the
// least any launch can show on the card; chip_smoke.py prints it beside
// every kernel's time.
// ---------------------------------------------------------------------------

__global__ void empty_kernel() {}

// ---------------------------------------------------------------------------
// Stage marks: one-thread kernels between the stages of a frame, captured
// into the frame's graph as top-level nodes. A replay hides its stages from
// every host-side tool; these time them on the device, unprofiled.
//
// times (int64, in ns of %globaltimer): [0] the previous mark's time, [1 +
// s] the total of stage s (vision.STAGES order), [1 + N_STAGES] frames.
// A mark adds the time since the previous mark to its stage's total and
// stores its own time; `start`, which opens each replay, only stores it, so
// device time between replays (host path, copies, captures) is never
// counted. A mark that finds no previous time (the buffer just zeroed)
// stores its own only. `telemetry`, after a frame's telemetry row, also
// counts the frame. Each stage has a kernel of its own, so that its name
// in a profiler trace says which mark it is.
// ---------------------------------------------------------------------------

constexpr int N_STAGES = 8;

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

__device__ __forceinline__ void stage_mark(long long* times, int slot,
                                           bool frame) {
  const long long now = global_ns();
  if (slot >= 0 && times[0] != 0) times[1 + slot] += now - times[0];
  times[0] = now;
  if (frame) times[1 + N_STAGES] += 1;
}

#define STAGE_MARK_KERNEL(stage, slot, frame)                         \
  __global__ void stage_mark_##stage##_kernel(long long* times) {     \
    stage_mark(times, slot, frame);                                   \
  }

STAGE_MARK_KERNEL(start, -1, false)
STAGE_MARK_KERNEL(motion, 0, false)
STAGE_MARK_KERNEL(measure, 1, false)
STAGE_MARK_KERNEL(associate, 2, false)
STAGE_MARK_KERNEL(update, 3, false)
STAGE_MARK_KERNEL(maintain, 4, false)
STAGE_MARK_KERNEL(detect, 5, false)
STAGE_MARK_KERNEL(telemetry, 6, true)
STAGE_MARK_KERNEL(reset, 7, false)

}  // namespace

extern "C" {

// regions (m, rg, rg), patches (m, pm, pm) -> scores (m, w1, w1) and, unless
// p_hat is null, p_hat (m, pm, pm); float32, contiguous, rg = w1 + pm - 1.
// One block per landmark; threads and smem_bytes come from
// vision.ncc_launch_plan. compiled_shape != 0 takes the <17, 21>
// instantiation and refuses any other shape; 0 takes the run-time bounds.
int cvms_ncc_score_map_f32(const void* regions, const void* patches,
                           void* scores, void* p_hat, int m, int pm, int w1,
                           int threads, int smem_bytes, int compiled_shape,
                           void* launches, void* stream) {
  const unsigned grid = (unsigned)m;
  const float* r = (const float*)regions;
  const float* p = (const float*)patches;
  if (compiled_shape) {
    if (pm != 17 || w1 != 21) return (int)cudaErrorInvalidValue;
    ncc_score_map_kernel<17, 21>
        <<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
            r, p, (float*)scores, (float*)p_hat, pm, w1, (int*)launches);
  } else {
    ncc_score_map_kernel<0, 0>
        <<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
            r, p, (float*)scores, (float*)p_hat, pm, w1, (int*)launches);
  }
  return (int)cudaGetLastError();
}

// patches (m, pi, pi), su/sv/out (m, po, po); float32, contiguous.
int cvms_warp_bilinear_f32(const void* patches, const void* su,
                           const void* sv, void* out, int m, int pi, int po,
                           void* launches, void* stream) {
  const long long total = (long long)m * po * po;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  warp_bilinear_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)patches, (const float*)su, (const float*)sv, (float*)out,
      m, pi, po, (int*)launches);
  return (int)cudaGetLastError();
}

// image (h, w) float32, base (m, 2) int32 region origins (u, v), A (m, 2, 2)
// float32 warps, patches (m, pi, pi) float32 -> scores (m, w1, w1), warped
// (m, pm, pm) and, unless p_hat is null, p_hat (m, pm, pm); all contiguous,
// pm and w1 odd, h and w >= w1 + pm - 1. One block per landmark; threads
// and smem_bytes come from vision.warp_ncc_launch_plan. compiled_shape != 0
// takes the <17, 21, 21> instantiation and refuses any other shape; 0 takes
// the run-time bounds.
int cvms_warp_ncc_score_map_f32(const void* image, const void* base,
                                const void* A, const void* patches,
                                void* scores, void* warped, void* p_hat,
                                int m, int h, int w, int pm, int w1, int pi,
                                int threads, int smem_bytes,
                                int compiled_shape, void* launches,
                                void* stream) {
  const unsigned grid = (unsigned)m;
  const float* im = (const float*)image;
  const int* b = (const int*)base;
  const float* a = (const float*)A;
  const float* p = (const float*)patches;
  if (compiled_shape) {
    if (pm != 17 || w1 != 21 || pi != 21) return (int)cudaErrorInvalidValue;
    warp_ncc_score_map_kernel<17, 21, 21>
        <<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
            im, b, a, p, (float*)scores, (float*)warped, (float*)p_hat, h, w,
            pm, w1, pi, (int*)launches);
  } else {
    warp_ncc_score_map_kernel<0, 0, 0>
        <<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
            im, b, a, p, (float*)scores, (float*)warped, (float*)p_hat, h, w,
            pm, w1, pi, (int*)launches);
  }
  return (int)cudaGetLastError();
}

int cvms_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// One stage mark into `times` (see above): stage -1 is `start`, 0 ... 7 the
// stages in vision.STAGES order.
int cvms_stage_mark(int stage, void* times, void* stream) {
  long long* t = (long long*)times;
  cudaStream_t s = (cudaStream_t)stream;
  switch (stage) {
    case -1: stage_mark_start_kernel<<<1, 1, 0, s>>>(t); break;
    case 0: stage_mark_motion_kernel<<<1, 1, 0, s>>>(t); break;
    case 1: stage_mark_measure_kernel<<<1, 1, 0, s>>>(t); break;
    case 2: stage_mark_associate_kernel<<<1, 1, 0, s>>>(t); break;
    case 3: stage_mark_update_kernel<<<1, 1, 0, s>>>(t); break;
    case 4: stage_mark_maintain_kernel<<<1, 1, 0, s>>>(t); break;
    case 5: stage_mark_detect_kernel<<<1, 1, 0, s>>>(t); break;
    case 6: stage_mark_telemetry_kernel<<<1, 1, 0, s>>>(t); break;
    case 7: stage_mark_reset_kernel<<<1, 1, 0, s>>>(t); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
