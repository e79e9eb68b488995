"""The two vision kernels of the frame loop, their plain versions and their
wrappers.

* :func:`ncc_score_map` — zero-mean NCC of each landmark's template against
  every offset of its search region (replaces
  ``cv_monoslam_tpu/ops/pallas_vision.py::ncc_score_map``);
* :func:`warp_bilinear` — bilinear resample of each landmark's init patch at
  fractional coordinates (replaces ``pallas_vision.py::warp_bilinear``).

Each wrapper launches its hand-written CUDA kernel
(``csrc/vision_kernels.cu``) for CUDA tensors and raises if it cannot; for
CPU tensors — and only for those — it computes the plain PyTorch version
(``*_ref``), which is also what the kernels are tested against on the card.
Each wrapper counts its kernel launches in a plain integer attribute
(``ncc_score_map.launches``), so a run can show that it went through the
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cvms_ncc_score_map_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "cvms_warp_bilinear_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
}


def _lib():
    return _build.load(_SIGNATURES)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: CUDA kernel takes float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _launch(name: str, fn: str, *args) -> None:
    err = getattr(_lib(), fn)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


# ---------------------------------------------------------------------------
# NCC score map
# ---------------------------------------------------------------------------


def normalized_templates(patches: torch.Tensor) -> torch.Tensor:
    """Zero-mean, unit-norm templates (M, pm, pm); a flat template -> 0."""
    m = patches.shape[0]
    pflat = patches.reshape(m, -1)
    pc = pflat - pflat.mean(dim=1, keepdim=True)
    pn = torch.sqrt(torch.sum(pc * pc, dim=1, keepdim=True))
    # pc / pn is 0/0 where pn == 0; torch.where drops that branch
    return torch.where(pn > 0, pc / pn, 0.0).reshape(patches.shape)


def ncc_score_map_ref(regions: torch.Tensor, patches: torch.Tensor, *,
                      pm: int, w1: int) -> torch.Tensor:
    """Plain version: (M, Rg, Rg) regions, (M, pm, pm) templates ->
    (M, w1, w1) zero-mean NCC scores."""
    return _ncc_core_ref(regions, normalized_templates(patches), pm=pm, w1=w1)


def _ncc_core_ref(reg: torch.Tensor, p_hat: torch.Tensor, *, pm: int,
                  w1: int) -> torch.Tensor:
    """Scores against normalized templates ``p_hat``, as shifted-slice sums
    in the order of the TPU kernel body ``_ncc_kernel`` (no convolution:
    cuDNN would run it in TF32 on the card)."""
    n_taps = pm * pm
    # running column sums over the px window
    cs = reg[:, :, 0:w1]
    cs2 = cs * cs
    for px in range(1, pm):
        r = reg[:, :, px:px + w1]
        cs = cs + r
        cs2 = cs2 + r * r
    shape = (reg.shape[0], w1, w1)
    num = torch.zeros(shape, dtype=reg.dtype, device=reg.device)
    wsum = torch.zeros_like(num)
    wsq = torch.zeros_like(num)
    for py in range(pm):
        for px in range(pm):
            num = num + p_hat[:, py, px, None, None] * reg[:, py:py + w1,
                                                           px:px + w1]
        wsum = wsum + cs[:, py:py + w1, :]
        wsq = wsq + cs2[:, py:py + w1, :]
    wvar = torch.clamp(wsq - wsum * wsum * (1.0 / n_taps), min=0.0)
    den = torch.sqrt(wvar)
    safe = torch.where(den == 0.0, torch.ones_like(den), den)
    return torch.where(den > 0.0, num / safe, torch.zeros_like(num))


def ncc_score_map(regions: torch.Tensor, patches: torch.Tensor, *, pm: int,
                  w1: int) -> torch.Tensor:
    """Zero-mean NCC score maps for all landmarks (see module docstring).

    regions (M, Rg, Rg) with Rg = w1 + pm - 1; patches (M, pm, pm).
    Returns (M, w1, w1) scores in [-1, 1]."""
    m, rg, _ = regions.shape
    if rg != w1 + pm - 1 or patches.shape != (m, pm, pm):
        raise ValueError(f"ncc_score_map: shapes {tuple(regions.shape)}, "
                         f"{tuple(patches.shape)} for pm={pm}, w1={w1}")
    # normalized once, as the JAX wrapper does, and handed to either path
    p_hat = normalized_templates(patches)
    if regions.device.type == "cpu":
        return _ncc_core_ref(regions, p_hat, pm=pm, w1=w1)
    if regions.device.type != "cuda":
        raise ValueError(f"ncc_score_map: no kernel for {regions.device}")
    _check_cuda("ncc_score_map", regions, p_hat)
    smem = 4 * (rg * rg + pm * pm)
    if smem > 48 * 1024:
        raise ValueError(f"ncc_score_map: region {rg}x{rg} needs {smem} B "
                         f"of shared memory (> 48 KB)")
    out = torch.empty((m, w1, w1), dtype=torch.float32,
                      device=regions.device)
    threads = min(1024, -(-(w1 * w1) // 32) * 32)
    with torch.cuda.device(regions.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("ncc_score_map", "cvms_ncc_score_map_f32",
                regions.data_ptr(), p_hat.data_ptr(), out.data_ptr(),
                m, pm, w1, threads, stream)
    ncc_score_map.launches += 1
    return out


ncc_score_map.launches = 0


# ---------------------------------------------------------------------------
# Bilinear warp
# ---------------------------------------------------------------------------


def warp_bilinear_ref(patches: torch.Tensor, su: torch.Tensor,
                      sv: torch.Tensor) -> torch.Tensor:
    """Plain version: (M, Pi, Pi) patches sampled at (M, Po, Po) fractional
    coordinates (su = column, sv = row); a sample is valid iff its 2x2
    neighbourhood lies inside the patch, invalid samples are 0."""
    m, pi, _ = patches.shape
    u0 = torch.floor(su)
    v0 = torch.floor(sv)
    du = su - u0
    dv = sv - v0
    valid = (u0 >= 0) & (u0 + 1 <= pi - 1) & (v0 >= 0) & (v0 + 1 <= pi - 1)
    u0c = torch.clamp(torch.nan_to_num(u0), 0, pi - 2).long()
    v0c = torch.clamp(torch.nan_to_num(v0), 0, pi - 2).long()
    flat = patches.reshape(m, pi * pi)

    def g(vv, uu):
        return torch.gather(flat, 1, (vv * pi + uu).reshape(m, -1)
                            ).reshape(su.shape)

    s = (g(v0c, u0c) * (1 - du) * (1 - dv)
         + g(v0c, u0c + 1) * du * (1 - dv)
         + g(v0c + 1, u0c) * (1 - du) * dv
         + g(v0c + 1, u0c + 1) * du * dv)
    return torch.where(valid, s, torch.zeros_like(s))


def warp_bilinear(patches: torch.Tensor, su: torch.Tensor,
                  sv: torch.Tensor) -> torch.Tensor:
    """Batched bilinear resample (see module docstring): patches
    (M, Pi, Pi), su/sv (M, Po, Po) -> (M, Po, Po)."""
    m, pi, _ = patches.shape
    if su.shape != sv.shape or su.shape[0] != m:
        raise ValueError(f"warp_bilinear: shapes {tuple(patches.shape)}, "
                         f"{tuple(su.shape)}, {tuple(sv.shape)}")
    if patches.device.type == "cpu":
        return warp_bilinear_ref(patches, su, sv)
    if patches.device.type != "cuda":
        raise ValueError(f"warp_bilinear: no kernel for {patches.device}")
    _check_cuda("warp_bilinear", patches, su, sv)
    po = su.shape[-1]
    out = torch.empty(su.shape, dtype=torch.float32, device=patches.device)
    with torch.cuda.device(patches.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("warp_bilinear", "cvms_warp_bilinear_f32",
                patches.data_ptr(), su.data_ptr(), sv.data_ptr(),
                out.data_ptr(), m, pi, po, stream)
    warp_bilinear.launches += 1
    return out


warp_bilinear.launches = 0
