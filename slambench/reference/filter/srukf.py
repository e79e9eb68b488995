"""Per-frame SRUKF pipeline orchestration (CSLAM::SLAM, SLAM.cpp:87-112).

``slam_step(state, frame) -> (state, outputs)`` runs the reference's fixed
stage order:

    predictMotion -> predictMeasurement -> dataAssociation -> KalmanUpdate
    -> updateFeaturesInformation -> [addFeatures if matches < min_num]

Redirection frames (|dtheta| > 45 deg odometry steps, SLAM.cpp:1354-1428)
take a separate branch: snapshot -> robot-only reset -> re-detect with loop
re-insertion. The reference consumes two odometry rows inside one call;
here the redirect branch handles frame t and the next step processes frame
t+1 normally — the same net computation.
"""

from __future__ import annotations

import torch

from ..config import SlamConfig
from .. import forcing
from ..ops import control
from ..frontend.detect import (candidate_filters, escalate_raws,
                               gftt_candidates, select_new_corners)
from ..frontend.matching import data_association
from ..utils.watchdog import health_check
from .lifecycle import (integrate_features, project_stored, readd_stored,
                        redirect_reset, update_features)
from .measurement import measurement_predict
from .motion import motion_predict
from .state import FilterState, replace
from .update import kalman_update


def add_features(state: FilterState, image: torch.Tensor, cfg: SlamConfig,
                 is_redirect: bool = False,
                 should_add=True,
                 is_initial: bool = False) -> FilterState:
    """Detection + filtering + integration (addFeatures, SLAM.cpp:552-562)
    including the insureEnoughFeatures raw-count escalation
    (SLAM.cpp:777-808). ``should_add`` (bool or 0-d bool tensor) masks the
    whole operation."""
    lm = state.lm
    # proximity set: every active landmark's predicted + matched pixel;
    # never-predicted/never-matched slots hold zeros (the reference's
    # stale-field semantics, SLAM.cpp:663-705)
    avoid = torch.cat([lm.pred, lm.match_px], dim=0)
    avoid_valid = torch.cat([lm.active, lm.active])
    n_matched = torch.sum(lm.matched & lm.active)
    n_map = torch.sum(lm.active)
    base = (cfg.n_initial_raws if (is_initial or is_redirect)
            else cfg.n_process_raws)

    pix, kept, raw_rank, resp = gftt_candidates(image, cfg)
    fok = candidate_filters(pix, cfg, avoid, avoid_valid, n_matched)

    if is_redirect:
        # loop-point detection: corners near a stored feature's projected
        # pixel re-add that feature instead of creating a new one
        # (SLAM.cpp:618-638, 699-729). Loop re-adds count toward the
        # escalation target like the reference's loop_ids.
        sp = project_stored(state, cfg)                      # (Ks, 2)
        sp_ok = state.stored.valid & torch.any(sp != 0.0, dim=-1)
        d2 = torch.sum((pix[:, None, :] - sp[None, :, :]) ** 2, dim=-1)
        near = (d2 < cfg.min_dist2) & sp_ok[None, :] \
            & (kept & fok)[:, None]                          # (K, Ks)
        new_ok = kept & fok & ~torch.any(near, dim=1)

        max_raws = max(30, base)
        steps = max(1, -(-(max_raws - base) // max(cfg.min_num, 1)) + 1)
        ladder = torch.clamp(
            base + cfg.min_num * torch.arange(steps, device=pix.device),
            max=max_raws)
        in_r = raw_rank[None, :] < ladder[:, None]           # (steps, K)
        counts = torch.sum(new_ok[None, :] & in_r, dim=1)
        loops = torch.sum(
            torch.any(near[None, :, :] & in_r[:, :, None], dim=1), dim=1)
        enough = (n_map + counts + loops) >= cfg.min_num
        # first rung that reaches min_num, else the last
        idx = torch.where(torch.any(enough),
                          torch.argmax(enough.to(torch.int32)),
                          torch.full((), steps - 1, device=pix.device))
        raws = ladder[idx.reshape(1)][0]

        readd_mask = torch.any(near & (raw_rank < raws)[:, None], dim=0)
        kept_final = new_ok & (raw_rank < raws)
        state = readd_stored(state, readd_mask, cfg)
    else:
        variants = forcing.proximity_variants(pix, fok, avoid, avoid_valid,
                                              n_matched, cfg)
        n_free = torch.sum(~state.lm.active)
        options = []
        for v in variants:
            raws = escalate_raws(kept, raw_rank, v, n_map, 0, base, cfg)
            kept_v = kept & v & (raw_rank < raws)
            corners, valid = select_new_corners(pix, kept_v, resp,
                                                cfg.max_new_per_frame, n_free)
            options.append((corners, _masked(valid, should_add)))
        corners, valid = forcing.pick_corners(options)
        return integrate_features(state, image, corners, valid, cfg)

    n_free = torch.sum(~state.lm.active)
    corners, valid = select_new_corners(pix, kept_final, resp,
                                        cfg.max_new_per_frame, n_free)
    return integrate_features(state, image, corners,
                              _masked(valid, should_add), cfg)


def _masked(valid: torch.Tensor, should_add) -> torch.Tensor:
    if isinstance(should_add, torch.Tensor):
        return valid & should_add
    if not should_add:
        return torch.zeros_like(valid)
    return valid


def initialize(state: FilterState, image: torch.Tensor,
               cfg: SlamConfig) -> FilterState:
    """Initial map construction (initializeParameters -> addFeatures,
    SLAM.cpp:348-350)."""
    return add_features(state, image, cfg, is_redirect=False,
                        should_add=True, is_initial=True)


def slam_step(state: FilterState, image: torch.Tensor,
              odo_prev: torch.Tensor, odo_cur: torch.Tensor,
              redirect: bool, cfg: SlamConfig, *,
              allow_detect: bool = True):
    """One frame. Returns (new_state, outputs dict).

    ``allow_detect=False`` runs the step without the detection/integration
    pipeline. With ``cfg.gate_detection`` the detect-when-starved trigger
    (matches < min_num, SLAM.cpp:552-562) is a :func:`control.cond`, as
    the JAX package's ``lax.cond``: a conditional node in a captured chunk,
    one host read eager; without it detection always runs and only the
    integration is masked.
    """
    return step_with(_predict_and_associate, state, image, odo_prev,
                     odo_cur, redirect, cfg, allow_detect=allow_detect)


def _predict_and_associate(state, cache, image, cfg):
    state, cache = measurement_predict(state, cache, cfg)
    return data_association(state, image, cfg), cache


def step_with(predict_and_associate, state: FilterState,
              image: torch.Tensor, odo_prev: torch.Tensor,
              odo_cur: torch.Tensor, redirect: bool, cfg: SlamConfig, *,
              allow_detect: bool = True):
    """:func:`slam_step` with its measurement prediction and data
    association given as ``predict_and_associate(state, cache, image,
    cfg) -> (state, cache)``: the per-landmark stages, which a
    landmark-sharded step splits across ranks (``parallel/spmd.py``)."""
    if redirect:
        state = redirect_reset(state, odo_cur[2], cfg)
        state = add_features(state, image, cfg, is_redirect=True,
                             should_add=True)
    else:
        state, cache = motion_predict(state, odo_prev, odo_cur, cfg)
        state, cache = predict_and_associate(state, cache, image, cfg)
        state = kalman_update(state, cache, cfg)
        state = update_features(state, cfg)
    if allow_detect and not redirect:
        n_matched = torch.sum(state.lm.matched & state.lm.active)
        if cfg.gate_detection:
            state = control.cond(
                n_matched < cfg.min_num,
                lambda s, im: add_features(s, im, cfg, should_add=True),
                lambda s, im: s, (state, image))
        else:
            state = add_features(state, image, cfg,
                                 should_add=n_matched < cfg.min_num)

    state = replace(state, frame=state.frame + 1)
    lm = state.lm
    outputs = dict(
        pose=state.x[-4:],
        pose_sqrt_cov=torch.sqrt(torch.clamp(
            torch.einsum("ij,ij->j", state.S[:, -4:], state.S[:, -4:]),
            min=0.0)),
        n_map=torch.sum(lm.active),
        n_visible=torch.sum(lm.visible & lm.active),
        n_matched=torch.sum(lm.matched & lm.active),
        redirected=torch.full((), bool(redirect), dtype=torch.bool,
                              device=state.x.device),
        lm_lid=lm.lid,
        lm_active=lm.active,
        lm_matched=lm.matched & lm.active,
        lm_match_px=lm.match_px,
        lm_xyz=lm.xyz,
        health=health_check(state, cfg),
        repairs=torch.stack([state.n_repairs, state.n_escalations,
                             state.n_skipped]),
    )
    return state, outputs
