"""The vision kernels of the frame loop, the two recurrence kernels, their
plain versions and their wrappers.

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
  fractional coordinates (replaces ``pallas_vision.py::warp_bilinear``);
* :func:`measure_project` and :func:`measure_merge` — the full-sigma
  measurement prediction of ``filter/measurement.py``: every slot through
  every sigma point, then (after the plain version's two reductions, the
  weighted mean and the Gram) visibility, the 2x2 innovation factor and the
  merges with the old rows; their plain version is
  ``filter/measurement.py::full_rows_ref``, which the caller takes for CPU
  tensors and ``vision_backend="xla"``;
* :func:`store_slots` — the stored table's slot policy of
  ``filter/lifecycle.store_features`` and :func:`gftt_greedy_nms` — GFTT's
  greedy min-distance separation of ``frontend/detect.gftt_candidates``:
  host loops of the port that the JAX package runs as ``lax.scan``
  recurrences (``csrc/scan_kernels.cu``).

Each wrapper launches its hand-written CUDA kernel (``csrc/*.cu``) for
CUDA tensors and raises if it cannot; for CPU tensors — and only for
those — it computes the plain PyTorch version (``*_ref``), which is also
what the kernels are tested against on the card. Every kernel counts its
own launches on the device (:func:`device_counts`): a launch captured in a
CUDA graph runs on every replay without a call of its wrapper, and inside a
conditional body only when its branch is taken, which the host cannot see.
Launches of the warm-up frame before a capture are not counted. Stage marks
(:func:`stage_mark`, one-thread kernels between a frame's stages) time the
stages of a replayed frame on the device; :func:`stage_times` reads them.
``normalized_templates.calls`` counts the plain normalization, so a run can
show that the CUDA path never takes it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, control

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cvms_ncc_score_map_f32": [_P] * 4 + [_I] * 6 + [_P, _P],
    "cvms_warp_bilinear_f32": [_P] * 4 + [_I] * 3 + [_P, _P],
    "cvms_warp_ncc_score_map_f32": [_P] * 7 + [_I] * 9 + [_P, _P],
    "cvms_empty_launch": [_P],
    "cvms_stage_mark": [_I, _P],
    **{f"cvms_measure_project_{t}": [_P, _P] + [_I] * 4 + [
        ctypes.POINTER(ctypes.c_double), _I, _P, _P] for t in ("f32", "f64")},
    **{f"cvms_measure_merge_{t}": [_P] * 8 + [_I, ctypes.c_double, _P, _P]
       for t in ("f32", "f64")},
}
_SCAN_SIGNATURES = {
    "cvms_store_slots": [_P, _P, _I] + [_P] * 4 + [_I] + [_P] * 7,
    "cvms_gftt_greedy_nms": [_P, _P, _I, ctypes.c_float] + [_P] * 6,
}


def _lib(name: str = "vision_kernels"):
    if name == "scan_kernels":
        return _build.load(_SCAN_SIGNATURES, name)
    return _build.load(_SIGNATURES, name)


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


def _launch(name: str, fn: str, dev: torch.device, *args,
            lib: str = "vision_kernels") -> None:
    """Call entry point ``fn(*args, stream)`` of library ``lib`` on
    ``dev``'s current stream (:func:`_build.launch`)."""
    _build.launch(_lib(lib), fn, name, dev, *args)


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
            plan["threads"], plan["smem_bytes"], int(plan["compiled"]),
            _device_counter(regions.device, "ncc_score_map").data_ptr())


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
            out.data_ptr(), m, pi, po,
            _device_counter(patches.device, "warp_bilinear").data_ptr())
    return out


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
            int(plan["compiled"]),
            _device_counter(image.device, "warp_ncc_score_map").data_ptr())


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


# ---------------------------------------------------------------------------
# Full-sigma measurement prediction
# ---------------------------------------------------------------------------

_MEASURE_TYPES = {torch.float32: "f32", torch.float64: "f64"}


def measure_consts(cam) -> tuple:
    """The camera's Python floats that ``filter/measurement.py::
    full_rows_ref``'s projection scales and compares by, in the order of
    ``MeasureConst`` in ``csrc/vision_kernels.cu``; the kernel casts each
    to the sigma set's type, as torch casts a Python scalar."""
    return (cam.cx, cam.cy, cam.f1, cam.f2, cam.dx, cam.dy, cam.k1, cam.k2,
            3.0 * cam.k1, 5.0 * cam.k2, cam.margin, cam.width - cam.margin,
            cam.height - cam.margin, cam.width, cam.height)


def _measure_check(name: str, tensors: dict, dtype) -> torch.device:
    """One device, ``dtype`` float32 or float64 (bool for the masks named
    ``active``), contiguous, on CUDA: anything else raises."""
    if dtype not in _MEASURE_TYPES:
        raise TypeError(f"{name}: wants float32 or float64, got {dtype}")
    for key, t in tensors.items():
        want = torch.bool if key == "active" else dtype
        if t.dtype != want:
            raise TypeError(f"{name}: {key} is {t.dtype}, not {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
    dev = next(iter(tensors.values())).device
    if any(t.device != dev for t in tensors.values()):
        raise ValueError(f"{name}: tensors on different devices")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev} (the plain version "
                         "is filter.measurement.full_rows_ref)")
    return dev


def measure_project(sigma: torch.Tensor, *, lo: int, m: int,
                    state_dim: int, cam) -> torch.Tensor:
    """The pixels (M, 2, ns) of the M slots ``[lo, lo + m)`` through every
    point of the (D + 5, ns) sigma set ``sigma`` (D = ``state_dim``), with
    the (0, 0) sentinel: ``filter/measurement.project_all``'s values to the
    bit, and its layout (a permuted view of an (M, ns, 2) tensor). One
    launch of ``csrc/vision_kernels.cu::measure_project_kernel``, counted
    on the device; CUDA tensors only, float32 or float64, contiguous."""
    ns = sigma.shape[-1] if sigma.dim() == 2 else -1
    if (sigma.dim() != 2 or sigma.shape[0] != state_dim + 5 or m < 1
            or lo < 0 or 6 * (lo + m) > state_dim - 4):
        raise ValueError(f"measure_project: sigma {tuple(sigma.shape)} for "
                         f"lo={lo}, m={m}, state_dim={state_dim}")
    dev = _measure_check("measure_project", dict(sigma=sigma), sigma.dtype)
    pix = torch.empty((m, ns, 2), dtype=sigma.dtype, device=dev)
    consts = measure_consts(cam)
    _launch("measure_project",
            f"cvms_measure_project_{_MEASURE_TYPES[sigma.dtype]}", dev,
            sigma.data_ptr(), pix.data_ptr(), m, lo, state_dim, ns,
            (ctypes.c_double * len(consts))(*consts), cam.distort_iters,
            _device_counter(dev, "measure_project").data_ptr())
    return pix.permute(0, 2, 1)


def measure_merge(mean: torch.Tensor, gram: torch.Tensor,
                  active: torch.Tensor, pred: torch.Tensor, si: torch.Tensor,
                  *, sigma_measure: float) -> Tuple[torch.Tensor, ...]:
    """``(visible, pred, si)`` of M slots from the weighted mean (M, 2) and
    the Gram (M, 2, 2) of their pixels: visible = active & mean != (0, 0),
    si = ``chol2x2_upper(gram + sigma_measure^2 I)``, and pred and si of the
    old rows (M, 2), (M, 2, 2) kept where a slot is not visible;
    ``filter/measurement.full_rows_ref``'s tail to the bit. One launch of
    ``csrc/vision_kernels.cu::measure_merge_kernel``, counted on the device;
    CUDA tensors only, float32 or float64, contiguous (the two reductions'
    outputs are made contiguous first)."""
    m = active.shape[0] if active.dim() == 1 else -1
    if (m < 1 or mean.shape != (m, 2) or gram.shape != (m, 2, 2)
            or pred.shape != (m, 2) or si.shape != (m, 2, 2)):
        raise ValueError(f"measure_merge: shapes mean {tuple(mean.shape)}, "
                         f"gram {tuple(gram.shape)}, active "
                         f"{tuple(active.shape)}, pred {tuple(pred.shape)}, "
                         f"si {tuple(si.shape)}")
    mean, gram = mean.contiguous(), gram.contiguous()
    dev = _measure_check("measure_merge", dict(
        mean=mean, gram=gram, active=active, pred=pred, si=si), mean.dtype)
    visible = torch.empty(m, dtype=torch.bool, device=dev)
    pred_out = torch.empty_like(pred)
    si_out = torch.empty_like(si)
    _launch("measure_merge",
            f"cvms_measure_merge_{_MEASURE_TYPES[mean.dtype]}", dev,
            mean.data_ptr(), gram.data_ptr(), active.data_ptr(),
            pred.data_ptr(), si.data_ptr(), visible.data_ptr(),
            pred_out.data_ptr(), si_out.data_ptr(), m,
            float(sigma_measure) ** 2,
            _device_counter(dev, "measure_merge").data_ptr())
    return visible, pred_out, si_out


# ---------------------------------------------------------------------------
# Launch counters on the device
# ---------------------------------------------------------------------------

#: every kernel of this module and of ``linalg.py`` (``rank_rotate``,
#: ``gmw_chol``), in the order of its slot in the counters
KERNELS = ("warp_ncc_score_map", "ncc_score_map", "warp_bilinear",
           "store_slots", "gftt_greedy_nms", "rank_rotate", "gmw_chol",
           "measure_project", "measure_merge")


def _counts(dev) -> torch.Tensor:
    """The (len(KERNELS),) int32 launch counters on ``dev``, zeroed."""
    dev = control.card(dev)
    return control.cached(("launch_counts", dev), lambda: torch.zeros(
        len(KERNELS), dtype=torch.int32, device=dev))


def _device_counter(dev, name: str) -> torch.Tensor:
    """The slot kernel ``name`` adds one to per launch; in warm-up (whose
    results are thrown away) a scratch slot that nothing reads. Both are
    built at the first call, so the warm-up frame before a capture builds
    them."""
    counts = _counts(dev)
    if control.warming():
        return control.cached(("warmup_counter", control.card(dev)),
                              lambda: torch.zeros(1, dtype=torch.int32,
                                                  device=dev))
    i = KERNELS.index(name)
    return counts[i:i + 1]


def device_counts(dev) -> dict:
    """Launches of every kernel on ``dev`` since the last
    :func:`reset_device_counts` (one device read)."""
    return dict(zip(KERNELS, _counts(dev).tolist()))


def reset_device_counts(dev) -> None:
    _counts(dev).zero_()


# ---------------------------------------------------------------------------
# Stage marks on the device
# ---------------------------------------------------------------------------

#: the stages a frame's marks close, in the order of their slots: a normal
#: frame marks ``motion`` ... ``detect`` (``filter/srukf.step_with``), a
#: redirect frame ``reset`` and ``detect``; ``telemetry`` follows each
#: frame's telemetry row (``api.SlamSession._frames``). ``start`` opens each
#: replay and closes no stage.
STAGES = ("motion", "measure", "associate", "update", "maintain", "detect",
          "telemetry", "reset")
_MARKS = {"start": -1, **{s: i for i, s in enumerate(STAGES)}}


def _stage_buf(dev) -> torch.Tensor:
    """The int64 (len(STAGES) + 2,) mark buffer on ``dev``: the previous
    mark's time, each stage's total (ns), frames."""
    dev = control.card(dev)
    return control.cached(("stage_times", dev), lambda: torch.zeros(
        len(STAGES) + 2, dtype=torch.int64, device=dev))


def stage_mark(dev, stage: str) -> None:
    """Mark the end of ``stage`` (or a replay's ``start``) on ``dev``: a
    one-thread kernel, ``stage_mark_<stage>_kernel`` in
    ``csrc/vision_kernels.cu``, that adds the device time (``%globaltimer``)
    since the previous mark to the stage's total. Captured, it is a
    top-level node of the graph (never inside a conditional body); in
    warm-up it writes to a scratch buffer; on the CPU it does nothing."""
    if dev.type != "cuda":
        return
    cap = control.capturing()
    if cap is not None and cap.depth:
        raise RuntimeError(f"stage mark {stage!r} inside a conditional body")
    if control.warming():
        buf = control.cached(("stage_scratch", control.card(dev)),
                             lambda: torch.zeros(len(STAGES) + 2,
                                                 dtype=torch.int64,
                                                 device=dev))
    else:
        buf = _stage_buf(dev)
    _launch(f"stage_mark_{stage}", "cvms_stage_mark", dev, _MARKS[stage],
            buf.data_ptr())


def stage_times(dev) -> Optional[dict]:
    """Each stage's device time in ns and the frames marked on ``dev``
    since the last :func:`reset_stage_times` (one device read); None off
    the card, where nothing is marked."""
    if torch.device(dev).type != "cuda":
        return None
    v = _stage_buf(dev).tolist()
    return dict(zip(STAGES, v[1:-1]), frames=v[-1])


def reset_stage_times(dev) -> None:
    if torch.device(dev).type == "cuda":
        _stage_buf(dev).zero_()


def store_slots_ref(mask: torch.Tensor, lid: torch.Tensor,
                    valid: torch.Tensor, tlid: torch.Tensor,
                    stamp: torch.Tensor, seq: torch.Tensor):
    """Plain version of :func:`store_slots`: the JAX package's scan, one
    record at a time, each step a masked update (no host read)."""
    s = valid.shape[0]
    ar = torch.arange(s, device=valid.device)
    big = torch.iinfo(torch.int32).max
    valid, tlid, stamp = valid.clone(), tlid.clone(), stamp.clone()
    seq = seq.clone()
    src = torch.full((s,), -1, dtype=torch.int32, device=valid.device)
    slots = []
    for j in range(mask.shape[0]):
        dup = valid & (tlid == lid[j])
        free = torch.argmin(valid.to(torch.int32))
        oldest = torch.argmin(torch.where(valid, stamp,
                                          torch.full_like(stamp, big)))
        slot = torch.where(torch.any(~valid), free, oldest)
        slot = torch.where(torch.any(dup), torch.argmax(dup.to(torch.int32)),
                           slot)
        hit = mask[j] & (ar == slot)
        valid = valid | hit
        stamp = torch.where(hit, seq, stamp)
        tlid = torch.where(hit, lid[j], tlid)
        src = torch.where(hit, torch.full_like(src, j), src)
        slots.append(torch.where(mask[j], slot, -1).to(torch.int32))
        seq = seq + mask[j].to(seq.dtype)
    slot = (torch.stack(slots) if slots
            else torch.zeros(0, dtype=torch.int32, device=valid.device))
    return slot, src, valid, stamp, seq


def store_slots(mask: torch.Tensor, lid: torch.Tensor, valid: torch.Tensor,
                tlid: torch.Tensor, stamp: torch.Tensor, seq: torch.Tensor):
    """The stored table's slot policy for the records ``mask`` selects, in
    record order (``cv_monoslam_tpu/filter/lifecycle.py::store_features``):
    a valid slot holding the record's landmark id, else the first free
    slot, else the valid slot with the oldest stamp; each insert takes
    stamp ``seq`` and advances it.

    mask (M,) bool, lid (M,) int32 record ids; table valid (S,) bool, tlid
    and stamp (S,) int32, seq () int32. Returns (slot (M,) int32, -1 where
    not stored; src (S,) int32, the record that wrote each slot last, -1
    where none; the new valid, stamp and seq). On CUDA tensors one launch
    of ``csrc/scan_kernels.cu::store_slots_kernel``, counted on the device;
    on CPU tensors :func:`store_slots_ref`. The kernel walks only the
    stored records, one warp minimum of a priority key each."""
    m, s = mask.shape[0], valid.shape[0]
    if (lid.shape != (m,) or tlid.shape != (s,) or stamp.shape != (s,)
            or seq.dim() != 0):
        raise ValueError(f"store_slots: shapes mask {tuple(mask.shape)}, "
                         f"lid {tuple(lid.shape)}, table {tuple(valid.shape)}"
                         f", {tuple(tlid.shape)}, {tuple(stamp.shape)}, seq "
                         f"{tuple(seq.shape)}")
    if mask.device.type == "cpu":
        return store_slots_ref(mask, lid, valid, tlid, stamp, seq)
    if mask.device.type != "cuda":
        raise ValueError(f"store_slots: no kernel for {mask.device}")
    dev = mask.device
    for t, dt in ((mask, torch.bool), (lid, torch.int32),
                  (valid, torch.bool), (tlid, torch.int32),
                  (stamp, torch.int32), (seq, torch.int32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise TypeError(f"store_slots: wants contiguous {dt} on {dev}, "
                            f"got {t.dtype} on {t.device}")
    slot = torch.empty(m, dtype=torch.int32, device=dev)
    src = torch.empty(s, dtype=torch.int32, device=dev)
    valid_out = torch.empty(s, dtype=torch.bool, device=dev)
    stamp_out = torch.empty(s, dtype=torch.int32, device=dev)
    seq_out = torch.empty((), dtype=torch.int32, device=dev)
    _launch("store_slots", "cvms_store_slots", dev, mask.data_ptr(),
            lid.data_ptr(), m, valid.data_ptr(), tlid.data_ptr(),
            stamp.data_ptr(), seq.data_ptr(), s, slot.data_ptr(),
            src.data_ptr(), valid_out.data_ptr(), stamp_out.data_ptr(),
            seq_out.data_ptr(), _device_counter(dev, "store_slots").data_ptr(),
            lib="scan_kernels")
    return slot, src, valid_out, stamp_out, seq_out


#: corners the greedy kernel takes (the JAX function takes any K); above
#: GREEDY_SMEM_MAX_K its clash bitmask stays in a scratch tensor in L2
GREEDY_MAX_K = 4096
#: the largest K whose clash bitmask (nw * (32 nw + 4) words, nw = ceil(K /
#: 32)) a block holds in shared memory: 226,464 bytes at nw = 42
#: (``scan_kernels.cu``, ``kMaskSmemWords``)
GREEDY_SMEM_MAX_K = 1344
#: up to this K one block does all of the greedy pass, the bitmask in its
#: shared memory; above it a grid builds the bitmask (a warp per 32 x 32
#: task) and its last block resolves it: ``chip_smoke.py --baseline``
#: times both routes at K = 96 ... 384, where they cross
GREEDY_ONE_BLOCK_MAX_K = 192


def _greedy_arrivals(dev) -> torch.Tensor:
    """The (1,) int32 counter the blocks of a greedy grid launch arrive at;
    the last one resets it to 0. One counter serves every such launch on
    the device, so they must be stream-ordered: the port makes them on
    the current stream of the thread that drives the device, and a
    captured graph's replays on the stream that replays it. Two grid
    launches running at once on two streams would corrupt the count."""
    dev = control.card(dev)
    return control.cached(("greedy_arrivals", dev), lambda: torch.zeros(
        1, dtype=torch.int32, device=dev))


def gftt_greedy_nms_ref(pix: torch.Tensor, cand: torch.Tensor,
                        min_dist2: float):
    """Plain version of :func:`gftt_greedy_nms`: the sequential recurrence
    over the (K, K) clash matrix, one corner at a time (no host read)."""
    d2 = torch.sum((pix[:, None, :] - pix[None, :, :]) ** 2, dim=-1)
    close = d2 < min_dist2
    kept = torch.zeros_like(cand)
    for i in range(cand.shape[0]):
        kept[i] = cand[i] & ~torch.any(kept[:i] & close[i, :i])
    raw_rank = torch.cumsum(kept.to(torch.int32), 0, dtype=torch.int32) - 1
    return kept, raw_rank


def gftt_greedy_nms(pix: torch.Tensor, cand: torch.Tensor,
                    min_dist2: float):
    """GFTT's greedy min-distance separation in response order
    (``cv_monoslam_tpu/frontend/detect.py::gftt_candidates``):
    ``kept[i] = cand[i] & ~any(kept[j] & (|pix_i - pix_j|^2 < min_dist2),
    j < i)``, and ``raw_rank`` = each survivor's 0-based position in the
    greedy sequence.

    pix (K, 2) float32, cand (K,) bool. Returns (kept (K,) bool, raw_rank
    (K,) int32). On CUDA tensors one launch of
    ``csrc/scan_kernels.cu::gftt_greedy_nms_kernel``, counted on the
    device (a clash bitmask of the pairs, then a chain of ceil(K / 32)
    word-steps in one warp); on CPU tensors :func:`gftt_greedy_nms_ref`."""
    k = cand.shape[0]
    if pix.shape != (k, 2) or cand.dim() != 1:
        raise ValueError(f"gftt_greedy_nms: shapes {tuple(pix.shape)}, "
                         f"{tuple(cand.shape)}")
    if pix.device.type == "cpu":
        return gftt_greedy_nms_ref(pix, cand, min_dist2)
    if pix.device.type != "cuda":
        raise ValueError(f"gftt_greedy_nms: no kernel for {pix.device}")
    if k > GREEDY_MAX_K:
        raise ValueError(f"gftt_greedy_nms: K = {k} > {GREEDY_MAX_K}")
    dev = pix.device
    for t, dt in ((pix, torch.float32), (cand, torch.bool)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise TypeError(f"gftt_greedy_nms: wants contiguous {dt} on "
                            f"{dev}, got {t.dtype} on {t.device}")
    kept = torch.empty(k, dtype=torch.bool, device=dev)
    raw_rank = torch.empty(k, dtype=torch.int32, device=dev)
    scratch = None
    if k > GREEDY_ONE_BLOCK_MAX_K:
        nw = (k + 31) // 32
        scratch = torch.empty(nw * (32 * nw + 4), dtype=torch.int32,
                              device=dev)
    _launch("gftt_greedy_nms", "cvms_gftt_greedy_nms", dev, pix.data_ptr(),
            cand.data_ptr(), k, float(min_dist2), kept.data_ptr(),
            raw_rank.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            _greedy_arrivals(dev).data_ptr(),
            _device_counter(dev, "gftt_greedy_nms").data_ptr(),
            lib="scan_kernels")
    return kept, raw_rank
