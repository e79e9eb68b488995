"""The vision kernels' plain versions, frozen from the port's
``ops/vision.py``; the public names call them on every device."""

from __future__ import annotations

from typing import Tuple

import torch


def normalized_templates(patches: torch.Tensor) -> torch.Tensor:
    """Zero-mean, unit-norm templates (M, pm, pm); a flat template -> 0.

    Centred twice (the mean, then the mean of the result), as the kernel
    does: sum(p_hat) is then at the roundoff of one value instead of pm^2
    of them, and its product with a window sum of up to pm^2 * 255 stays
    far below the score tolerance whatever order the mean was summed in."""
    m = patches.shape[0]
    pflat = patches.reshape(m, -1)
    pc = pflat - pflat.mean(dim=1, keepdim=True)
    pc = pc - pc.mean(dim=1, keepdim=True)
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


warp_ncc_score_map = warp_ncc_score_map_ref
ncc_score_map = ncc_score_map_ref
warp_bilinear = warp_bilinear_ref
store_slots = store_slots_ref
gftt_greedy_nms = gftt_greedy_nms_ref
