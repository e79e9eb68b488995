"""The card's published peaks and the work of the kernels whose roofline
share the benchmark reports, from the kernel's shapes.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W): 67
TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM3. The bound
of a kernel is the larger of its operations over the first and its bytes
over the second (each input byte read once, each output written once).
"""

from __future__ import annotations

PEAK_FP32 = 67e12          # FLOP/s
PEAK_BYTES = 3.35e12       # bytes/s
FRAME_H, FRAME_W = 480, 640


def _bound(nbytes: int, flops: int) -> dict:
    tb = nbytes / PEAK_BYTES * 1e3
    tf = flops / PEAK_FP32 * 1e3
    return dict(bytes=nbytes, flops=flops, bound_ms=max(tb, tf),
                bound_by="bytes" if tb >= tf else "operations")


def ncc_bound(m: int, pm: int = 17, w1: int = 21) -> dict:
    """Zero-mean NCC of m templates (pm x pm) over w1 x w1 offsets of their
    regions: pm^2 multiply-adds an offset; window sums and sums of squares
    separably; the template's mean and norm; the per-offset
    normalization."""
    rg = w1 + pm - 1
    nbytes = 4 * m * (rg * rg + pm * pm + w1 * w1)
    flops = m * (2 * pm * pm * w1 * w1
                 + rg * rg
                 + 2 * (rg * w1 * (pm - 1) + w1 * w1 * (pm - 1))
                 + 4 * pm * pm + 6 * w1 * w1)
    return _bound(nbytes, flops)


def warp_ncc_bound(m: int, pm: int = 17, w1: int = 21, pi: int = 21) -> dict:
    """The fused matcher (``warp_ncc_score_map``): bytes of the init
    patches, warps, origins, warped templates and scores, and the frame's
    region bytes read once; the NCC's operations plus 15 per warped sample
    and 4 per coordinate."""
    rg = w1 + pm - 1
    n = m * pm * pm
    nbytes = (4 * (m * pi * pi + 4 * m + n + m * w1 * w1) + 4 * 2 * m
              + 4 * min(m * rg * rg, FRAME_H * FRAME_W))
    flops = ncc_bound(m, pm, w1)["flops"] + 15 * n + 4 * 2 * n
    return _bound(nbytes, flops)
