"""The vision kernels of the frame loop, their plain versions and their
wrappers.

* :func:`warp_ncc_score_map` — the one the matcher runs: each landmark's
  init patch warped by its 2x2 affine map, its search region copied from
  the frame, and the zero-mean NCC of the warped template over every offset
  of the region, in one launch (replaces, composed,
  ``cv_monoslam_tpu/ops/pallas_vision.py::warp_bilinear``, the region slice
  of ``cv_monoslam_tpu/frontend/matching.py::ncc_scores`` and
  ``pallas_vision.py::ncc_score_map``); returns the scores and the warped
  templates;
* :func:`ncc_score_map` — zero-mean NCC of each landmark's template against
  every offset of its search region, template normalization included
  (replaces ``pallas_vision.py::ncc_score_map``);
  :func:`ncc_score_map_with_templates` also returns the normalized
  templates, so the normalization and the scores can be checked apart;
* :func:`warp_bilinear` — bilinear resample of each landmark's init patch at
  fractional coordinates (replaces ``pallas_vision.py::warp_bilinear``).

Each wrapper launches its hand-written CUDA kernel
(``csrc/vision_kernels.cu``) for CUDA tensors and raises if it cannot; for
CPU tensors — and only for those — it computes the plain PyTorch version
(``*_ref``), which is also what the kernels are tested against on the card.
Each wrapper counts its kernel launches in a plain integer attribute
(``ncc_score_map.launches``), so a run can show that it went through the
kernel; ``normalized_templates.calls`` counts the plain normalization the
same way, so a run can show that the CUDA path never takes it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cvms_ncc_score_map_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "cvms_warp_bilinear_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    "cvms_warp_ncc_score_map_f32": [_P] * 7 + [_I] * 9 + [_P],
    "cvms_empty_launch": [_P],
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


def _launch(name: str, fn: str, dev: torch.device, *args) -> None:
    """Call entry point ``fn(*args, stream)`` on ``dev``'s current stream.

    The stream handle comes from ``torch._C._cuda_getCurrentRawStream`` (what
    compiled PyTorch code uses; it builds no ``Stream`` object, which costs
    the host more than the launch itself), and the device context is entered
    only when ``dev`` is not the current device."""
    entry = getattr(_lib(), fn)
    cur = torch.cuda.current_device()
    idx = cur if dev.index is None else dev.index
    if idx == cur:
        err = entry(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = entry(*args, torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def empty_launch(dev: torch.device) -> None:
    """Launch the kernel that does nothing: the card's launch floor, timed
    by ``chip_smoke.py`` the way the kernels are."""
    _launch("empty_launch", "cvms_empty_launch", dev)


# ---------------------------------------------------------------------------
# NCC score map
# ---------------------------------------------------------------------------

NCC_STRIP = 7              # offsets per thread (TW in vision_kernels.cu)
NCC_COMPILED_SHAPE = (17, 21)   # (pm, w1) instantiated with unrolled loops
NCC_SMEM_LIMIT = 48 * 1024      # dynamic shared memory without an opt-in


def normalized_templates(patches: torch.Tensor) -> torch.Tensor:
    """Zero-mean, unit-norm templates (M, pm, pm); a flat template -> 0.

    Centred twice (the mean, then the mean of the result), as the kernel
    does: sum(p_hat) is then at the roundoff of one value instead of pm^2
    of them, and its product with a window sum of up to pm^2 * 255 stays
    far below the score tolerance whatever order the mean was summed in."""
    normalized_templates.calls += 1
    m = patches.shape[0]
    pflat = patches.reshape(m, -1)
    pc = pflat - pflat.mean(dim=1, keepdim=True)
    pc = pc - pc.mean(dim=1, keepdim=True)
    pn = torch.sqrt(torch.sum(pc * pc, dim=1, keepdim=True))
    # pc / pn is 0/0 where pn == 0; torch.where drops that branch
    return torch.where(pn > 0, pc / pn, 0.0).reshape(patches.shape)


normalized_templates.calls = 0


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


def ncc_launch_plan(m: int, pm: int, w1: int) -> dict:
    """How the NCC kernel is launched for M landmarks of shape (pm, w1).

    A block owns one landmark, so the region is staged once; a thread owns
    a 1 x NCC_STRIP strip of offsets. Returns ``compiled`` (the unrolled
    (17, 21) instantiation, else the run-time bounds of the same kernel),
    ``threads`` and ``smem_bytes``. Raises ValueError where the block's
    shared memory exceeds NCC_SMEM_LIMIT."""
    if m < 1:
        raise ValueError(f"ncc_score_map: m={m}")
    strips = -(-w1 // NCC_STRIP)
    rg = w1 + pm - 1
    csw = strips * NCC_STRIP
    tp = -(-pm // 4) * 4                 # template row, 16-byte loads
    pitch = (csw + tp - 1) | 1           # region row: odd, no bank conflicts
    # normalized template, column sums and window sums (two floats each),
    # region rows, raw template: the layout of ncc_score_map_kernel
    smem = 4 * (pm * tp + 2 * rg * csw + 2 * w1 * csw + rg * pitch + pm * pm)
    if smem > NCC_SMEM_LIMIT:
        raise ValueError(f"ncc_score_map: region {rg}x{rg} needs {smem} B "
                         f"of shared memory (> {NCC_SMEM_LIMIT} B)")
    # one thread per column-sum task (region rows x strips), of which
    # w1 x strips go on to the taps; the shared-memory limit keeps this
    # below 1024
    return dict(compiled=(pm, w1) == NCC_COMPILED_SHAPE,
                threads=-(-(rg * strips) // 32) * 32, smem_bytes=smem)


def _ncc_check_shapes(regions, patches, pm: int, w1: int) -> None:
    m, rg, _ = regions.shape
    if rg != w1 + pm - 1 or patches.shape != (m, pm, pm):
        raise ValueError(f"ncc_score_map: shapes {tuple(regions.shape)}, "
                         f"{tuple(patches.shape)} for pm={pm}, w1={w1}")
    if regions.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ncc_score_map: no kernel for {regions.device}")


def _ncc_cuda(regions, patches, scores, p_hat, pm: int, w1: int) -> None:
    """The one kernel launch of the NCC wrappers; ``p_hat`` None: the
    kernel keeps the normalized templates on chip only."""
    m = regions.shape[0]
    plan = ncc_launch_plan(m, pm, w1)
    outs = (scores,) if p_hat is None else (scores, p_hat)
    _check_cuda("ncc_score_map", regions, patches, *outs)
    _launch("ncc_score_map", "cvms_ncc_score_map_f32", regions.device,
            regions.data_ptr(), patches.data_ptr(), scores.data_ptr(),
            None if p_hat is None else p_hat.data_ptr(), m, pm, w1,
            plan["threads"], plan["smem_bytes"], int(plan["compiled"]))
    ncc_score_map.launches += 1


def ncc_score_map_with_templates(
        regions: torch.Tensor, patches: torch.Tensor, *, pm: int, w1: int,
        out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(scores, p_hat)``: the score maps of :func:`ncc_score_map` and the
    normalized templates (M, pm, pm) they were computed against.

    On CUDA tensors one kernel launch computes both, and no torch
    arithmetic runs before it; ``out`` gives preallocated float32 outputs.
    On CPU tensors this is exactly ``(ncc_score_map_ref(...),
    normalized_templates(...))``."""
    _ncc_check_shapes(regions, patches, pm, w1)
    m = regions.shape[0]
    if regions.device.type == "cpu":
        p_hat = normalized_templates(patches)
        return _ncc_core_ref(regions, p_hat, pm=pm, w1=w1), p_hat
    if out is None:
        out = (torch.empty((m, w1, w1), dtype=torch.float32,
                           device=regions.device),
               torch.empty((m, pm, pm), dtype=torch.float32,
                           device=regions.device))
    scores, p_hat = out
    if scores.shape != (m, w1, w1) or p_hat.shape != (m, pm, pm):
        raise ValueError(f"ncc_score_map: output shapes "
                         f"{tuple(scores.shape)}, {tuple(p_hat.shape)}")
    _ncc_cuda(regions, patches, scores, p_hat, pm, w1)
    return scores, p_hat


def ncc_score_map(regions: torch.Tensor, patches: torch.Tensor, *, pm: int,
                  w1: int) -> torch.Tensor:
    """Zero-mean NCC score maps for all landmarks (see module docstring).

    regions (M, Rg, Rg) with Rg = w1 + pm - 1; patches (M, pm, pm) raw
    templates. Returns (M, w1, w1) scores in [-1, 1]. On CUDA tensors: one
    output allocation and one kernel launch, which normalizes the
    templates on chip."""
    _ncc_check_shapes(regions, patches, pm, w1)
    if regions.device.type == "cpu":
        return ncc_score_map_ref(regions, patches, pm=pm, w1=w1)
    scores = torch.empty((regions.shape[0], w1, w1), dtype=torch.float32,
                         device=regions.device)
    _ncc_cuda(regions, patches, scores, None, pm, w1)
    return scores


ncc_score_map.launches = 0


# ---------------------------------------------------------------------------
# Bilinear warp
# ---------------------------------------------------------------------------


def warp_sample_coords(A: torch.Tensor, hp_init: int, hp_match: int):
    """Sample positions (su, sv), each (M, Pm, Pm) with Pm = 2 hp_match + 1,
    inside the (Pi, Pi) init patches, centred at (hp_init, hp_init), for the
    (M, 2, 2) warps ``A`` in the (dv, du) basis. Every torch operation
    rounds on its own; the fused kernel repeats them in this order without
    FMA contraction, so both give the same bits."""
    d = torch.arange(-hp_match, hp_match + 1, dtype=A.dtype, device=A.device)
    dv, du = torch.meshgrid(d, d, indexing="ij")     # (Pm,Pm)
    sv = hp_init + A[:, 0, 0, None, None] * dv + A[:, 0, 1, None, None] * du
    su = hp_init + A[:, 1, 0, None, None] * dv + A[:, 1, 1, None, None] * du
    return su, sv


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
    _launch("warp_bilinear", "cvms_warp_bilinear_f32", patches.device,
            patches.data_ptr(), su.data_ptr(), sv.data_ptr(),
            out.data_ptr(), m, pi, po)
    warp_bilinear.launches += 1
    return out


warp_bilinear.launches = 0


# ---------------------------------------------------------------------------
# Warp + region + NCC, fused
# ---------------------------------------------------------------------------

WARP_NCC_COMPILED_SHAPE = (17, 21, 21)   # (pm, w1, pi), unrolled loops


def gather_regions(image: torch.Tensor, base: torch.Tensor,
                   rg: int) -> torch.Tensor:
    """(H, W) image, (M, 2) region origins (u, v) -> (M, rg, rg) regions."""
    ar = torch.arange(rg, device=image.device)
    rows = (base[:, 1, None] + ar)[:, :, None].long()
    cols = (base[:, 0, None] + ar)[:, None, :].long()
    return image[rows, cols]


def _warp_regions_ref(image, base, A, init_patch, hp_init: int,
                      hp_match: int):
    """The plain chain up to the NCC: (warped templates, regions, pm, w1)."""
    pm, w1 = 2 * hp_match + 1, 2 * hp_init + 1
    su, sv = warp_sample_coords(A, hp_init, hp_match)
    warped = warp_bilinear_ref(init_patch, su, sv)
    regions = gather_regions(image, base, w1 + pm - 1).to(warped.dtype)
    return warped, regions, pm, w1


def warp_ncc_score_map_ref(image: torch.Tensor, base: torch.Tensor,
                           A: torch.Tensor, init_patch: torch.Tensor, *,
                           hp_init: int, hp_match: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the coordinates of :func:`warp_sample_coords`,
    :func:`warp_bilinear_ref`, :func:`gather_regions` and
    :func:`ncc_score_map_ref`, in that order — exactly what the matcher
    computed before the three were fused. Returns (scores (M, W1, W1),
    warped templates (M, Pm, Pm))."""
    warped, regions, pm, w1 = _warp_regions_ref(image, base, A, init_patch,
                                                hp_init, hp_match)
    return ncc_score_map_ref(regions, warped, pm=pm, w1=w1), warped


def warp_ncc_launch_plan(m: int, pm: int, w1: int, pi: int) -> dict:
    """How the fused kernel is launched for M landmarks: the NCC kernel's
    block (:func:`ncc_launch_plan`) with the (pi, pi) init patch staged
    after its layout. Returns ``compiled`` (the unrolled (17, 21, 21)
    instantiation, else the run-time bounds of the same kernel),
    ``threads`` and ``smem_bytes``; raises ValueError where the block's
    shared memory exceeds NCC_SMEM_LIMIT."""
    if pi < 2:
        raise ValueError(f"warp_ncc_score_map: init patch side {pi} < 2")
    plan = ncc_launch_plan(m, pm, w1)
    smem = plan["smem_bytes"] + 4 * pi * pi
    if smem > NCC_SMEM_LIMIT:
        raise ValueError(f"warp_ncc_score_map: needs {smem} B of shared "
                         f"memory (> {NCC_SMEM_LIMIT} B)")
    return dict(compiled=(pm, w1, pi) == WARP_NCC_COMPILED_SHAPE,
                threads=plan["threads"], smem_bytes=smem)


def _warp_ncc_check_shapes(image, base, A, init_patch, hp_init: int,
                           hp_match: int) -> Tuple[int, int]:
    """Shapes and device of the fused wrapper's inputs; returns (pm, w1)."""
    pm, w1 = 2 * hp_match + 1, 2 * hp_init + 1
    rg = w1 + pm - 1
    m = base.shape[0] if base.dim() == 2 else -1
    if (hp_init < 0 or hp_match < 0 or image.dim() != 2
            or base.shape != (m, 2) or A.shape != (m, 2, 2)
            or init_patch.dim() != 3 or init_patch.shape[0] != m
            or init_patch.shape[1] != init_patch.shape[2]
            or min(image.shape) < rg):
        raise ValueError(
            f"warp_ncc_score_map: shapes image {tuple(image.shape)}, base "
            f"{tuple(base.shape)}, A {tuple(A.shape)}, init_patch "
            f"{tuple(init_patch.shape)} for hp_init={hp_init}, "
            f"hp_match={hp_match}")
    if image.device.type not in ("cpu", "cuda"):
        raise ValueError(f"warp_ncc_score_map: no kernel for {image.device}")
    return pm, w1


def _warp_ncc_check_types(image, base, A, init_patch, *outs) -> None:
    """What the CUDA kernel takes: one device, float32 frame, warps,
    patches and outputs, int32 origins, all contiguous."""
    _check_cuda("warp_ncc_score_map", image, A, init_patch, *outs)
    if base.device != image.device:
        raise ValueError("warp_ncc_score_map: tensors on different devices")
    if base.dtype != torch.int32:
        raise TypeError(f"warp_ncc_score_map: CUDA kernel takes int32 "
                        f"region origins, got {base.dtype}")
    if not base.is_contiguous():
        raise ValueError("warp_ncc_score_map: tensors must be contiguous")


def _warp_ncc_cuda(image, base, A, init_patch, scores, warped, p_hat,
                   pm: int, w1: int) -> None:
    """The one kernel launch of the fused wrappers; ``p_hat`` None: the
    kernel keeps the normalized templates on chip only."""
    m, pi = base.shape[0], init_patch.shape[-1]
    plan = warp_ncc_launch_plan(m, pm, w1, pi)
    outs = (scores, warped) if p_hat is None else (scores, warped, p_hat)
    _warp_ncc_check_types(image, base, A, init_patch, *outs)
    _launch("warp_ncc_score_map", "cvms_warp_ncc_score_map_f32",
            image.device, image.data_ptr(), base.data_ptr(), A.data_ptr(),
            init_patch.data_ptr(), scores.data_ptr(), warped.data_ptr(),
            None if p_hat is None else p_hat.data_ptr(), m, image.shape[0],
            image.shape[1], pm, w1, pi, plan["threads"], plan["smem_bytes"],
            int(plan["compiled"]))
    warp_ncc_score_map.launches += 1


def _empty(dev: torch.device, *shapes) -> tuple:
    return tuple(torch.empty(s, dtype=torch.float32, device=dev)
                 for s in shapes)


def warp_ncc_score_map(
        image: torch.Tensor, base: torch.Tensor, A: torch.Tensor,
        init_patch: torch.Tensor, *, hp_init: int, hp_match: int,
        out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(scores, warped)``: each landmark's (Pi, Pi) init patch warped by
    its (2, 2) map ``A`` at the (Pm, Pm) sample grid of
    :func:`warp_sample_coords` (Pm = 2 hp_match + 1), and the zero-mean NCC
    scores (M, W1, W1), W1 = 2 hp_init + 1, of that warped template over
    the (Rg, Rg) region of the (H, W) frame ``image`` at origin ``base``
    (M, 2) (u, v), Rg = W1 + Pm - 1.

    On CUDA tensors one launch computes both (and no torch arithmetic runs
    before it): a float32 frame, warps and patches, int32 origins, all
    contiguous; ``out`` gives preallocated float32 outputs. On CPU tensors
    this is exactly :func:`warp_ncc_score_map_ref`.

    Every origin must lie in [0, W - Rg] x [0, H - Rg], as
    :func:`~cv_monoslam_tpu_torch.frontend.matching.region_origins` makes
    them; no check reads them back from the device. An origin outside
    gives undefined results: the kernel clamps it into the frame (it never
    reads out of bounds), the plain version wraps a negative index or
    raises past the edge."""
    pm, w1 = _warp_ncc_check_shapes(image, base, A, init_patch, hp_init,
                                    hp_match)
    if image.device.type == "cpu":
        return warp_ncc_score_map_ref(image, base, A, init_patch,
                                      hp_init=hp_init, hp_match=hp_match)
    m = base.shape[0]
    if out is None:
        out = _empty(image.device, (m, w1, w1), (m, pm, pm))
    scores, warped = out
    if scores.shape != (m, w1, w1) or warped.shape != (m, pm, pm):
        raise ValueError(f"warp_ncc_score_map: output shapes "
                         f"{tuple(scores.shape)}, {tuple(warped.shape)}")
    _warp_ncc_cuda(image, base, A, init_patch, scores, warped, None, pm, w1)
    return scores, warped


warp_ncc_score_map.launches = 0


def warp_ncc_score_map_with_templates(
        image: torch.Tensor, base: torch.Tensor, A: torch.Tensor,
        init_patch: torch.Tensor, *, hp_init: int, hp_match: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(scores, warped, p_hat)``: :func:`warp_ncc_score_map`'s outputs
    and the normalized templates the scores were computed against, from
    the same one launch on CUDA tensors (for the checks). On CPU tensors:
    the plain chain with the normalization taken apart."""
    pm, w1 = _warp_ncc_check_shapes(image, base, A, init_patch, hp_init,
                                    hp_match)
    if image.device.type == "cpu":
        warped, regions, pm, w1 = _warp_regions_ref(
            image, base, A, init_patch, hp_init, hp_match)
        p_hat = normalized_templates(warped)
        return _ncc_core_ref(regions, p_hat, pm=pm, w1=w1), warped, p_hat
    m = base.shape[0]
    outs = _empty(image.device, (m, w1, w1), (m, pm, pm), (m, pm, pm))
    _warp_ncc_cuda(image, base, A, init_patch, *outs, pm, w1)
    return outs
