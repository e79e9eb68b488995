"""Shi-Tomasi corner detection + candidate filtering (torch).

Replaces the reference's GoodFeaturesToTrackDetector + serial filter loops
(SLAM.cpp:574-768) with a structure tensor from shifted sums, 3x3 NMS, a
fixed-size top-K selection, and an exact greedy min-distance pass.

Reference flow reproduced exactly (SLAM.cpp:574-808):
  1. GFTT: min-eigenvalue response, quality threshold = quality_level * max
     response over the FULL image, greedy min-dist separation over
     response-sorted peaks, capped at ``n_raws`` corners (SLAM.cpp:599-600),
     with the insureEnoughFeatures escalation (SLAM.cpp:777-808) evaluated as
     one ladder (raw membership is a prefix of the greedy order).
  2. Downstream filters on the raw set: >= dist_to_border px inside the
     image (SLAM.cpp:650-651), >= min_dist px from every landmark's
     predicted AND matched pixel (SLAM.cpp:663-705; skipped when nothing is
     matched, as the reference does).

The Sobel and box filters are written as shifted sums, not convolutions:
cuDNN runs float32 convolutions in TF32 by default on the card, and GFTT's
selection is a knife edge that three decimal digits would move.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SlamConfig


def _filter_same_edge(x: torch.Tensor, k) -> torch.Tensor:
    """Cross-correlation of (H, W) ``x`` with the small 2-D kernel ``k``
    (nested lists of Python floats), edge-replicate padded to the same
    size. Zero taps are skipped."""
    p = len(k) // 2
    H, W = x.shape
    xp = F.pad(x[None, None], (p, p, p, p), mode="replicate")[0, 0]
    out = None
    for a, row in enumerate(k):
        for b, w in enumerate(row):
            if w == 0.0:
                continue
            term = w * xp[a:a + H, b:b + W]
            out = term if out is None else out + term
    return out


def corner_response(image: torch.Tensor, block_size: int = 3) -> torch.Tensor:
    """Min-eigenvalue (Shi-Tomasi) response map, (H, W) float32.

    Edge-replicate padding (the reference's OpenCV borderType default) so
    image borders don't produce artificial gradient peaks.
    """
    img = image.to(torch.float32)
    sob = [[-1.0 / 8, 0.0, 1.0 / 8], [-2.0 / 8, 0.0, 2.0 / 8],
           [-1.0 / 8, 0.0, 1.0 / 8]]
    sob_t = [list(r) for r in zip(*sob)]
    gx = _filter_same_edge(img, sob)
    gy = _filter_same_edge(img, sob_t)
    wb = float(torch.tensor(1.0 / block_size ** 2, dtype=torch.float32))
    box = [[wb] * block_size for _ in range(block_size)]
    ixx = _filter_same_edge(gx * gx, box)
    iyy = _filter_same_edge(gy * gy, box)
    ixy = _filter_same_edge(gx * gy, box)
    tr = ixx + iyy
    disc = torch.sqrt(torch.clamp(((ixx - iyy) * 0.5) ** 2 + ixy * ixy,
                                  min=0.0))
    return tr * 0.5 - disc


def _max3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 'SAME' max filter with -inf outside the image."""
    H, W = x.shape
    xp = F.pad(x, (1, 1, 1, 1), value=float("-inf"))
    out = xp[0:H, 0:W]
    for a in range(3):
        for b in range(3):
            if a or b:
                out = torch.maximum(out, xp[a:a + H, b:b + W])
    return out


def gftt_candidates(image: torch.Tensor, cfg: SlamConfig):
    """GoodFeaturesToTrack core: response-sorted, min-dist-separated peaks.

    Returns (pix (K, 2) float32, kept (K,) bool, raw_rank (K,) int32, resp
    (K,)) where ``kept`` marks greedy min-dist survivors in response order
    and ``raw_rank`` is each survivor's 0-based position in the greedy
    sequence. K = cfg.max_detections.
    """
    K = cfg.max_detections
    H, W = image.shape
    resp = corner_response(image, cfg.block_size)

    # 3x3 non-max suppression + quality threshold over the FULL map
    mx = _max3x3(resp)
    is_peak = (resp >= mx) & (resp > cfg.quality_level * resp.max())
    score = torch.where(is_peak, resp, torch.full_like(resp, float("-inf")))

    # top-K with the lower index first among equal scores (lax.top_k's
    # order): a stable descending sort over the flattened map
    top, idx = torch.sort(score.reshape(-1), descending=True, stable=True)
    top, idx = top[:K], idx[:K]
    py = idx // W
    px = idx % W
    pix = torch.stack([px, py], dim=1).to(torch.float32)
    cand = top > float("-inf")

    # greedy min-dist in response order (GFTT's internal separation): an
    # exact sequential recurrence over the (K, K) clash matrix. It runs on
    # the host (one device read): as K launches of a few device ops each it
    # cost more than the rest of the detection at K = 768
    d2 = torch.sum((pix[:, None, :] - pix[None, :, :]) ** 2, dim=-1)
    close = (d2 < cfg.min_dist2).cpu().numpy()
    cand_h = cand.cpu().numpy()
    kept_h = np.zeros(K, dtype=bool)
    for i in range(K):
        kept_h[i] = cand_h[i] and not np.any(kept_h[:i] & close[i, :i])
    kept = torch.as_tensor(kept_h, device=image.device)
    raw_rank = torch.cumsum(kept.to(torch.int32), 0, dtype=torch.int32) - 1
    return pix, kept, raw_rank, top


def candidate_filters(pix: torch.Tensor, cfg: SlamConfig,
                      avoid: Optional[torch.Tensor],
                      avoid_valid: Optional[torch.Tensor],
                      n_matched: Union[torch.Tensor, int] = 0
                      ) -> torch.Tensor:
    """Border + landmark-proximity filters on raw corners (SLAM.cpp:650-705).

    Returns an acceptance mask (K,). The proximity test is skipped when
    ``n_matched`` is zero (SLAM.cpp:663-671).
    """
    W, H = cfg.camera.width, cfg.camera.height
    b = cfg.dist_to_border
    ok = ((pix[:, 0] >= b) & (pix[:, 0] <= W - b)
          & (pix[:, 1] >= b) & (pix[:, 1] <= H - b))
    if avoid is not None:
        nz = avoid_valid & torch.any(avoid != 0.0, dim=-1)
        d2 = torch.sum((pix[:, None, :].to(avoid.dtype)
                        - avoid[None, :, :]) ** 2, dim=-1)
        near = torch.any((d2 < cfg.min_dist2) & nz[None, :], dim=1)
        any_matched = torch.as_tensor(n_matched, device=pix.device) > 0
        ok = ok & (~near | ~any_matched)
        if cfg.detect_zero_blocks:
            # reference isThereNoZero (SLAM.cpp:684-696)
            has_zero = torch.any(avoid_valid
                                 & ~torch.any(avoid != 0.0, dim=-1))
            ok = ok & (~has_zero | ~any_matched)
    return ok


def escalate_raws(kept: torch.Tensor, raw_rank: torch.Tensor,
                  filters_ok: torch.Tensor, n_map: torch.Tensor,
                  n_loop: Union[torch.Tensor, int], base_raws: int,
                  cfg: SlamConfig) -> torch.Tensor:
    """insureEnoughFeatures (SLAM.cpp:777-808) in one pass: raw sets for
    increasing caps are prefixes of the same greedy sequence, so each ladder
    step's survivor count is a masked count. Returns the chosen raw cap
    (0-d tensor)."""
    dev = kept.device
    max_raws = max(30, base_raws)
    steps = max(1, -(-(max_raws - base_raws) // max(cfg.min_num, 1)) + 1)
    ladder = torch.clamp(
        base_raws + cfg.min_num * torch.arange(steps, device=dev),
        max=max_raws)
    ok = kept & filters_ok
    counts = torch.sum(ok[None, :] & (raw_rank[None, :] < ladder[:, None]),
                       dim=1)
    enough = (n_map + n_loop + counts) >= cfg.min_num
    first = torch.argmax(enough.to(torch.int32))
    idx = torch.where(torch.any(enough), first,
                      torch.full_like(first, steps - 1))
    return ladder[idx]


def detect_corners(image: torch.Tensor, cfg: SlamConfig,
                   avoid: Optional[torch.Tensor] = None,
                   avoid_valid: Optional[torch.Tensor] = None,
                   n_matched: Union[torch.Tensor, int] = 0,
                   n_map: Union[torch.Tensor, int] = 0,
                   n_loop: Union[torch.Tensor, int] = 0,
                   base_raws: Optional[int] = None):
    """Full reference detection pipeline.

    Returns (pix (K, 2), valid (K,), resp (K,)) where ``valid`` marks
    corners inside the (possibly escalated) raw cap that pass every filter,
    in response order.
    """
    if base_raws is None:
        base_raws = cfg.n_process_raws
    pix, kept, raw_rank, resp = gftt_candidates(image, cfg)
    fok = candidate_filters(pix, cfg, avoid, avoid_valid, n_matched)
    raws = escalate_raws(kept, raw_rank, fok,
                         torch.as_tensor(n_map, device=image.device),
                         n_loop, base_raws, cfg)
    valid = kept & fok & (raw_rank < raws)
    return pix, valid, resp


def select_new_corners(pix: torch.Tensor, kept: torch.Tensor,
                       resp: torch.Tensor, k_add: int,
                       n_free: torch.Tensor):
    """Pick the k_add best kept corners (capped by free slots).

    Returns (corners (k_add, 2), valid (k_add,)).
    """
    key = torch.where(kept, -resp, torch.full_like(resp, float("inf")))
    order = torch.argsort(key, stable=True)
    sel = order[:k_add]
    valid = kept[sel] & (torch.arange(k_add, device=pix.device) < n_free)
    return pix[sel], valid
