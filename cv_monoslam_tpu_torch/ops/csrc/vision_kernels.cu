// Vision hot-loop kernels for Hopper (sm_90a): zero-mean NCC active search
// and bilinear patch warp. Plain C interface, loaded with ctypes by
// cv_monoslam_tpu_torch/ops/_build.py; each entry point launches on the
// stream it is given and returns cudaGetLastError() of its launch.
//
// Both kernels compute the same function as their plain PyTorch versions in
// cv_monoslam_tpu_torch/ops/vision.py (ncc_score_map_ref, warp_bilinear_ref),
// which chip_smoke.py holds them against on the card.

#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// NCC score map
//
// Replaces cv_monoslam_tpu/ops/pallas_vision.py::ncc_score_map (kernel body
// _ncc_kernel). For each landmark m, with the template already zero-meaned
// and unit-normed by the wrapper (p_hat; a flat template is all zeros):
//
//   num[oy,ox]  = sum_{py,px} p_hat[py,px] * reg[oy+py, ox+px]
//   wsum, wsq   = window sum and sum of squares of reg over the same taps
//   wvar        = max(wsq - wsum^2 / n, 0)
//   score       = num / sqrt(wvar), or 0 where sqrt(wvar) == 0
//
// Mapping: the TPU kernel puts landmarks on the 128-wide lane axis because
// the TPU's vector unit wants every tap as a full lane vector. On the GPU
// the natural mapping is one thread block per landmark, one thread per
// output offset (21 x 21 = 441 at the default sizes): the 37x37 region and
// the 17x17 template sit in shared memory (5.5 KB + 1.2 KB) and every
// thread walks its 289 taps accumulating num, wsum and wsq in registers.
// No intermediate touches device memory.
//
// Bound on an H100 (M = 576, the large-state shape): bytes moved are
// regions 3.15 MB + templates 0.67 MB + scores 1.02 MB ~ 4.8 MB, ~1.4 us at
// 3.35 TB/s; the work is ~2*289*441*M ~ 147 MFLOP of FP32 FMA plus the
// window sums, ~2-3 us at 67 TFLOP/s FP32. Both are a few microseconds, so
// the floor is compute or launch, not memory. At M = 32 (config 1) the
// launch itself dominates.
// ---------------------------------------------------------------------------

__global__ void ncc_score_map_kernel(const float* __restrict__ regions,
                                     const float* __restrict__ p_hat,
                                     float* __restrict__ out,
                                     int pm, int w1) {
  extern __shared__ float smem[];
  const int rg = w1 + pm - 1;
  const int n_reg = rg * rg;
  const int n_tap = pm * pm;
  float* reg = smem;                     // (rg, rg)
  float* tpl = smem + n_reg;             // (pm, pm)
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  const float* g_reg = regions + (size_t)m * n_reg;
  const float* g_tpl = p_hat + (size_t)m * n_tap;
  for (int i = tid; i < n_reg; i += nt) reg[i] = g_reg[i];
  for (int i = tid; i < n_tap; i += nt) tpl[i] = g_tpl[i];
  __syncthreads();

  const float inv_n = 1.0f / (float)n_tap;
  float* g_out = out + (size_t)m * w1 * w1;
  for (int o = tid; o < w1 * w1; o += nt) {
    const int oy = o / w1;
    const int ox = o - oy * w1;
    float num = 0.0f, wsum = 0.0f, wsq = 0.0f;
    for (int py = 0; py < pm; ++py) {
      const float* row = reg + (oy + py) * rg + ox;
      const float* trow = tpl + py * pm;
      float rs = 0.0f, rs2 = 0.0f;       // this row's column-window sums
      for (int px = 0; px < pm; ++px) {
        const float r = row[px];
        num += trow[px] * r;
        rs += r;
        rs2 += r * r;
      }
      wsum += rs;
      wsq += rs2;
    }
    // wsq and wsum^2/n nearly cancel on a low-texture window; an FMA here
    // would round that difference otherwise than the plain version does,
    // so each step is rounded on its own
    const float wvar =
        fmaxf(__fsub_rn(wsq, __fmul_rn(__fmul_rn(wsum, wsum), inv_n)), 0.0f);
    const float den = sqrtf(wvar);
    g_out[o] = den > 0.0f ? num / den : 0.0f;
  }
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
// thread computes one output sample by a direct 4-tap gather.
//
// Bound on an H100 (M = 576): ~3.0 MB moved (patches 1.02 MB, su and sv
// 0.67 MB each, output 0.67 MB), ~0.9 us at 3.35 TB/s; ~15 FLOP per sample
// is negligible. Memory- and launch-bound.
// ---------------------------------------------------------------------------

__global__ void warp_bilinear_kernel(const float* __restrict__ patches,
                                     const float* __restrict__ su,
                                     const float* __restrict__ sv,
                                     float* __restrict__ out,
                                     int m, int pi, int po) {
  const long long total = (long long)m * po * po;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int k = (int)(idx / ((long long)po * po));
  const float u = su[idx];
  const float v = sv[idx];
  const float u0 = floorf(u);
  const float v0 = floorf(v);
  const float du = __fsub_rn(u, u0);
  const float dv = __fsub_rn(v, v0);
  const float hi = (float)(pi - 1);
  const bool valid = (u0 >= 0.0f) && (u0 + 1.0f <= hi) && (v0 >= 0.0f) &&
                     (v0 + 1.0f <= hi);
  float s = 0.0f;
  if (valid) {
    const int iu = min(max((int)u0, 0), pi - 2);
    const int iv = min(max((int)v0, 0), pi - 2);
    const float* p = patches + (size_t)k * pi * pi + (size_t)iv * pi + iu;
    const float cu = __fsub_rn(1.0f, du);
    const float cv = __fsub_rn(1.0f, dv);
    // p00*(1-du)*(1-dv) + p01*du*(1-dv) + p10*(1-du)*dv + p11*du*dv,
    // left to right, each operation rounded on its own like the plain
    // version's separate tensor ops
    s = __fmul_rn(__fmul_rn(p[0], cu), cv);
    s = __fadd_rn(s, __fmul_rn(__fmul_rn(p[1], du), cv));
    s = __fadd_rn(s, __fmul_rn(__fmul_rn(p[pi], cu), dv));
    s = __fadd_rn(s, __fmul_rn(__fmul_rn(p[pi + 1], du), dv));
  }
  out[idx] = s;
}

}  // namespace

extern "C" {

// regions (m, rg, rg), p_hat (m, pm, pm), out (m, w1, w1); float32,
// contiguous, rg = w1 + pm - 1.
int cvms_ncc_score_map_f32(const void* regions, const void* p_hat,
                           void* out, int m, int pm, int w1, int threads,
                           void* stream) {
  const int rg = w1 + pm - 1;
  const size_t shmem = sizeof(float) * ((size_t)rg * rg + pm * pm);
  ncc_score_map_kernel<<<m, threads, shmem, (cudaStream_t)stream>>>(
      (const float*)regions, (const float*)p_hat, (float*)out, pm, w1);
  return (int)cudaGetLastError();
}

// patches (m, pi, pi), su/sv/out (m, po, po); float32, contiguous.
int cvms_warp_bilinear_f32(const void* patches, const void* su,
                           const void* sv, void* out, int m, int pi, int po,
                           void* stream) {
  const long long total = (long long)m * po * po;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  warp_bilinear_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)patches, (const float*)su, (const float*)sv, (float*)out,
      m, pi, po);
  return (int)cudaGetLastError();
}

}  // extern "C"
