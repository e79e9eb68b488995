"""Landmark lifecycle: masked add / delete / store / loop re-add / redirect.

The reference resizes state and covariance on every event (SLAM.cpp:818-1334
add + permutation; 2397-2706 delete + Cholesky fold). Here every event is a
masked write into fixed slots plus one structured refactorization:

  * DELETE k slots: T = S with the deleted slots' *columns* zeroed keeps
    T^T T = the marginal P; stacking unit rows for the deleted slots
    restores the inactive-slot invariant (one Gram + Cholesky under
    qr_mode="gram").
  * ADD k features: augmented UT over [x; (u, v, rho) * K_ADD] exactly as
    the reference's mapping function (SLAM.cpp:1177-1250), with outputs
    scattered straight into their slots.
  * REDIRECT: snapshot -> robot-only reset -> re-detect with loop re-add
    (SLAM.cpp:1343-1428, 948-1015); the reference advances two odometry
    rows inside one call, here the redirect branch handles frame t and the
    next step processes frame t+1 normally.
"""

from __future__ import annotations

import torch

from ..config import SlamConfig
from .. import forcing
from ..geometry import camera as cam_mod
from ..geometry import transforms as tf
from ..ops import control, qr_r, vision
from ..ops.linalg import gram_rows
from .motion import (equilibrated_chol, structured_sqrt_gram,
                     structured_sqrt_gram_rows)
from .sigma import deviations, generate_sigma, ut_weights
from .state import (FilterState, StoredTable, count_repairs,
                    inactive_feature_defaults, replace)


# ---------------------------------------------------------------------------
# deletion (SLAM.cpp:2397-2706)
# ---------------------------------------------------------------------------


def delete_rules(state: FilterState, cfg: SlamConfig):
    """Per-slot delete + store masks (SLAM.cpp:2443-2459, 2494-2532)."""
    lm = state.lm
    M = cfg.max_landmarks
    feats = state.x[: 6 * M].reshape(M, 6)
    rho = feats[:, 5]
    hlr_z = rho * (feats[:, 2] - state.x[-2]) + torch.cos(feats[:, 4]) \
        * torch.cos(feats[:, 3])
    b = cfg.dist_to_border
    Wd, Hd = cfg.camera.width, cfg.camera.height
    px, py = lm.pred[:, 0], lm.pred[:, 1]
    mx, my = lm.match_px[:, 0], lm.match_px[:, 1]

    starved = ((lm.n_predict > cfg.delete_predict_ratio * lm.n_match)
               & (lm.n_predict >= cfg.delete_predict_min))
    bad_depth = (rho < cfg.delete_rho_min) | (hlr_z < 0.0)
    pred_border = (px < b) | (py < b) | (Wd - px < b) | (Hd - py < b)
    match_border = lm.matched & ((mx < b) | (my < b) | (Wd - mx < b)
                                 | (Hd - my < b))
    delete = lm.active & (starved | bad_depth | pred_border | match_border)
    # store matched landmarks deleted purely for border reasons
    store = delete & lm.matched & (pred_border | match_border) \
        & ~(starved | bad_depth)
    return forcing.deletions(delete, store, px, py, mx, my, lm.matched, rho,
                             hlr_z, starved, cfg)


def _feature_defaults(M: int, dtype, device) -> torch.Tensor:
    return torch.cat([inactive_feature_defaults(dtype, device).repeat(M),
                      torch.zeros(4, dtype=dtype, device=device)])


def fold_delete(x: torch.Tensor, S: torch.Tensor, delete: torch.Tensor,
                cfg: SlamConfig):
    """Marginalize deleted slots; restore the unit-diagonal invariant.
    Returns (x, S, repair_level)."""
    M = cfg.max_landmarks
    dtype, dev = x.dtype, x.device
    row_mask = torch.cat([torch.repeat_interleave(delete, 6),
                          torch.zeros(4, dtype=torch.bool, device=dev)])
    if cfg.qr_mode == "gram":
        # structured Gram: T = S diag(1-m), so [T; E]^T [T; E] is S^T S with
        # the masked rows+columns zeroed plus the unit diagonal
        G = gram_rows(S)
        keep = ~row_mask
        G = torch.where(keep[:, None] & keep[None, :], G,
                        torch.zeros_like(G))
        G = G + torch.diag(row_mask.to(dtype))
        S_new, rep = equilibrated_chol(G)
    else:
        T = torch.where(row_mask[None, :], torch.zeros_like(S), S)
        E = torch.diag(row_mask.to(dtype))
        S_new = qr_r(torch.cat([T, E], dim=0), cfg.qr_mode)
        # a device zero: the level leaves update_features' cond as a tensor
        rep = torch.zeros((), dtype=torch.int32, device=dev)
    x_new = torch.where(row_mask, _feature_defaults(M, dtype, dev), x)
    return x_new, S_new, rep


def snapshot_records(state: FilterState, cfg: SlamConfig):
    """Per-slot StoredTable-shaped records of the current landmarks
    (reference FeatureInfo snapshot, SLAM.cpp:1359-1378, 2514-2530).

    Like the reference, the saved 6x6 sqrt block is the diagonal block of S
    (SLAM.cpp:2530 / 1373), i.e. the conditional — not marginal — sqrt.
    """
    M = cfg.max_landmarks
    lm = state.lm
    feats = state.x[: 6 * M].reshape(M, 6)
    rows = (6 * torch.arange(M, device=feats.device)[:, None]
            + torch.arange(6, device=feats.device)[None, :])      # (M, 6)
    sr = state.S[rows[:, :, None], rows[:, None, :]]              # (M, 6, 6)
    return dict(
        lid=lm.lid, is_loop=lm.is_loop, n_predict=lm.n_predict,
        n_match=lm.n_match, state=feats, sr=sr,
        init_pixel=lm.init_pixel, init_trans=lm.init_trans,
        init_theta=lm.init_theta, init_patch=lm.init_patch, xyz=lm.xyz,
    )


_RECORD_FIELDS = ("lid", "is_loop", "n_predict", "n_match", "state", "sr",
                  "init_pixel", "init_trans", "init_theta", "init_patch",
                  "xyz")


def store_features(stored: StoredTable, recs: dict,
                   mask: torch.Tensor) -> StoredTable:
    """Scatter mask-selected records into stored slots.

    Slot policy per record, records in order: (1) a valid slot already
    holding the same landmark id is overwritten; (2) else the first free slot; (3)
    else the OLDEST slot by insertion stamp is evicted. The policy is the
    ``store_slots`` kernel (``ops/vision.py``; the JAX package's
    ``lax.scan`` of ``lax.cond``), which also names the record that wrote
    each table slot last; each field is then one gather from the records.
    Nothing is read back to the host."""
    _, src, valid, stamp, seq = vision.store_slots(
        mask, recs["lid"], stored.valid, stored.lid, stored.stamp,
        stored.seq)
    take = src >= 0
    idx = torch.clamp(src, min=0).long()

    def field(k):
        old = getattr(stored, k)
        sel = take.reshape((-1,) + (1,) * (old.dim() - 1))
        return torch.where(sel, recs[k][idx].to(old.dtype), old)

    return replace(stored, valid=valid, stamp=stamp, seq=seq,
                   **{k: field(k) for k in _RECORD_FIELDS})


def update_features(state: FilterState, cfg: SlamConfig) -> FilterState:
    """Deletion pass + Cartesian refresh (SLAM.cpp:2397-2706).

    Most frames delete and store nothing: the store scan and the
    refactorization each run under :func:`control.cond`, as the JAX
    package's two ``lax.cond`` do."""
    M = cfg.max_landmarks
    delete, store = delete_rules(state, cfg)
    stored = control.cond(
        torch.any(store),
        lambda st, s: store_features(st, snapshot_records(s, cfg), store),
        lambda st, s: st,
        (state.stored, state))
    x_new, S_new, rep = control.cond(
        torch.any(delete),
        lambda x, S: fold_delete(x, S, delete, cfg),
        lambda x, S: (x, S, torch.zeros((), dtype=torch.int32,
                                        device=x.device)),
        (state.x, state.S))
    lm = state.lm
    keep = lm.active & ~delete
    feats = x_new[: 6 * M].reshape(M, 6)
    xyz = tf.inverse_depth_to_cartesian(feats)
    zero_i = torch.zeros_like(lm.n_predict)
    # ``visible`` is NOT cleared here: the next measurement predict
    # recomputes it before any consumer reads it, and keeping it makes the
    # per-frame n_visible telemetry meaningful
    lm_new = replace(
        lm,
        active=keep,
        lid=torch.where(keep, lm.lid, torch.zeros_like(lm.lid)),
        is_loop=lm.is_loop & keep,
        n_predict=torch.where(keep, lm.n_predict, zero_i),
        n_match=torch.where(keep, lm.n_match, zero_i),
        visible=lm.visible & keep,
        matched=lm.matched & keep,
        xyz=torch.where(keep[:, None], xyz, lm.xyz),
    )
    return count_repairs(
        replace(state, x=x_new, S=S_new, lm=lm_new, stored=stored), rep)


# ---------------------------------------------------------------------------
# addition (SLAM.cpp:818-1334)
# ---------------------------------------------------------------------------


def _fold_sqrt(S: torch.Tensor, Ep: torch.Tensor, Em: torch.Tensor,
               ridx: torch.Tensor, valid: torch.Tensor, w, D: int):
    """Integrated sqrt WITHOUT a D x D refactorization.

    The augmented UT's output Gram (structured_gram_rows) differs from the
    posterior S^T S only in the 6*KA target rows/cols, and the posterior S
    has UNIT decoupled rows at those (inactive) slots. Splitting the
    target-row deviations into odd/even sigma-branch parts
    Es = (Ep - Em)/2, Ea = (Ep + Em)/2, the EXACT integrated covariance
    factorizes in closed form:

        S_new[:, F]    = S[:, F]                 (untouched columns)
        S_new[:, T]    = V  = 2 wi gamma Es[:D]  (state-row first-order part)
        S_new[T, T]   += R_d,  R_d^T R_d = Delta (conditional-given-state)

        Delta = 2 wi (Es[D:]^T Es[D:] + Ea^T Ea)
              + (2 wi - 4 wi^2 g^2) Es[:D]^T Es[:D]   [== 0 for UT weights]

    S_new^T S_new equals the refactorizing path's Gram exactly, so this is
    the same UT posterior through an orthogonally-different sqrt; S_new is
    NOT triangular (robot-row couplings land below the diagonal in the new
    columns), which the gram/implicit pipeline never needs: the next
    frame's joint-Schur update re-triangularizes. Delta is PSD-singular in
    exact arithmetic (new position rows are exact copies of the robot
    position), so the equilibrated repair's first jitter rung fires
    routinely and counts as a minor repair.

    Invalid candidates: their Es columns are exactly gamma * e_t (the
    original unit sigma rows), so V already reproduces e_t outside the
    T-block; the T-block part is restored by adding diag(~valid) to Delta.
    """
    wi = 2.0 * w.wi_sr ** 2
    g = w.gamma
    Es = 0.5 * (Ep - Em)                                   # (na, 6KA)
    Ea = 0.5 * (Ep + Em)
    V = (wi * g) * Es[:D]                                  # (D, 6KA)
    coef = wi - wi * wi * g * g                            # 0 for UT weights
    # Ea's and Es[:D]'s rows include S's rows (gram_rows: summed across
    # ranks in the shard_sqrt step); Es[D:] holds only the noise rows
    delta = (wi * (Es[D:].T @ Es[D:] + gram_rows(Ea))
             + coef * gram_rows(Es[:D]))
    # ridx order is [all pos rows, all ang rows] (3 per target per half)
    vmask3 = torch.repeat_interleave(valid, 3)
    vmask = torch.cat([vmask3, vmask3])
    delta = delta + torch.diag((~vmask).to(S.dtype))
    R_d, rep = equilibrated_chol(delta)
    V.index_fill_(0, ridx, 0.0)      # T-block rows live in R_d only
    S_new = S.clone()
    S_new[:, ridx] = V
    S_new[ridx[:, None], ridx[None, :]] += R_d
    return S_new, rep


def _add_noise(cfg: SlamConfig, dtype, dev) -> torch.Tensor:
    """(u, v, rho) sqrt noise of a new feature (built once per device)."""
    return control.constant((cfg.sigma_measure, cfg.sigma_measure,
                             cfg.sigma_rho), dtype, dev)


def _integrate_implicit(state: FilterState, safe_c: torch.Tensor,
                        valid: torch.Tensor, targets: torch.Tensor,
                        cfg: SlamConfig):
    """Row-space feature integration (sigma_mode="implicit").

    The augmented UT's outputs differ from the prior state only in the
    6*KA target-slot rows, and the mapping function (SLAM.cpp:1177-1250)
    reads only the robot rows + each candidate's own 3 noise rows. Every
    needed row of the sigma set is read straight off a COLUMN of S (the
    sigma rule chi_i = mu +- gamma*S_row_i) or a noise diagonal, so the
    (na, 2na+1) tensor is never built. Outputs are identical to the full
    path up to summation roundoff.

    Returns (x_new, S_new, rep).
    """
    dtype, dev = state.x.dtype, state.x.device
    D = cfg.state_dim
    KA = cfg.max_new_per_frame
    na = D + 3 * KA
    ns = 2 * na + 1
    w = ut_weights(na, cfg)
    g = w.gamma
    cam = cfg.camera

    def state_rows(idx):
        """(|idx|, ns) sigma-row values for state rows ``idx``."""
        cols = torch.cat(
            [state.S[:, idx].T,
             torch.zeros((idx.shape[0], 3 * KA), dtype=dtype, device=dev)],
            dim=1)
        mu_r = state.x[idx][:, None]
        return torch.cat([mu_r, mu_r + g * cols, mu_r - g * cols], dim=1)

    rob = state_rows(torch.arange(D - 4, D, device=dev))   # (4, ns)
    pos = rob[:3]                                          # (3, ns)
    theta_r = rob[3]                                       # (ns,)

    # candidate noise rows: mean +- gamma*noise at their own column only
    noise = torch.where(
        valid[:, None],
        _add_noise(cfg, dtype, dev)[None, :],
        torch.ones((KA, 3), dtype=dtype, device=dev))      # (KA, 3)
    mu2 = torch.cat([safe_c, torch.full((KA, 1), cfg.rho0, dtype=dtype,
                                        device=dev)], dim=1)   # (KA, 3)
    ar3 = torch.arange(3, device=dev)
    ka = torch.arange(KA, device=dev)
    col_p = 1 + D + 3 * ka[:, None] + ar3[None, :]
    base_cols = torch.zeros((KA, 3, ns), dtype=dtype, device=dev)
    base_cols[ka[:, None], ar3[None, :], col_p] = g * noise
    base_cols[ka[:, None], ar3[None, :], col_p + na] = -g * noise
    uvr = mu2[:, :, None] + base_cols                      # (KA, 3, ns)

    # mapping function (identical math to the full path)
    uv = uvr[:, :2].permute(0, 2, 1)                       # (KA, ns, 2)
    rho_in = uvr[:, 2]                                     # (KA, ns)
    rwc = tf.yaw_matrix(theta_r)                           # (ns, 3, 3)
    ray = cam_mod.image2camera(cam, cam_mod.undistort(cam, uv))
    hlw = torch.einsum("sij,ksj->ksi", rwc, ray)           # (KA, ns, 3)
    ang = tf.world_to_angles(hlw)                          # (KA, ns, 2)
    if cfg.rho_init_mode == "ceiling":
        rho_out = rho_in * torch.cos(ang[..., 1]) * torch.cos(ang[..., 0])
    else:
        rho_out = rho_in

    pos_rows = (6 * targets[:, None] + ar3[None, :]).reshape(-1)
    ang_rows = (6 * targets[:, None] + 3 + ar3[None, :]).reshape(-1)
    pos_vals = pos[None].expand(KA, 3, ns).reshape(-1, ns)
    ang_vals = torch.stack(
        [ang[..., 0], ang[..., 1], rho_out], dim=1).reshape(-1, ns)

    # invalid candidates keep their slots' ORIGINAL sigma rows (exact
    # no-op, matching the full path's masked scatter)
    ridx = torch.cat([pos_rows, ang_rows])
    orig = state_rows(ridx)                                # (6KA, ns)
    vmask6 = torch.repeat_interleave(valid, 3)
    vals = torch.where(torch.cat([vmask6, vmask6])[:, None],
                       torch.cat([pos_vals, ang_vals], dim=0), orig)

    x_new = state.x.clone()
    x_new[ridx] = vals @ w.mean_weights(dtype, dev)

    base = vals[:, :1]
    Ep = (vals[:, 1:na + 1] - base).T                      # (na, 6KA)
    Em = (vals[:, na + 1:] - base).T
    if cfg.integrate_fold and cfg.update_mode == "gram":
        S_new, rep = _fold_sqrt(state.S, Ep, Em, ridx, valid, w, D)
    else:
        S_new, rep = structured_sqrt_gram_rows(state.S, Ep, Em, ridx, w,
                                               with_flag=True)
    return x_new, S_new, rep


def integrate_features(state: FilterState, image: torch.Tensor,
                       corners: torch.Tensor, valid: torch.Tensor,
                       cfg: SlamConfig) -> FilterState:
    """Initialize up to K_ADD new inverse-depth landmarks via augmented UT.

    corners: (K_ADD, 2) pixel positions; valid: (K_ADD,) mask. Invalid
    entries are exact no-ops (their slots keep the inactive invariant).
    """
    dtype, dev = state.x.dtype, state.x.device
    D = cfg.state_dim
    KA = cfg.max_new_per_frame
    na = D + 3 * KA
    w = ut_weights(na, cfg)
    cam = cfg.camera

    # target slots: first KA inactive (stable argsort: inactive first)
    targets = torch.argsort(state.lm.active.to(torch.int32),
                            stable=True)[:KA]                     # (KA,)
    valid = valid & ~state.lm.active[targets]

    # augmented mean + sqrt (SLAM.cpp:847-869)
    centre = control.constant((cam.width / 2.0, cam.height / 2.0), dtype,
                              dev)
    safe_c = torch.where(valid[:, None], corners.to(dtype), centre)
    if cfg.sigma_mode == "implicit":
        x_new, S_new, rep = _integrate_implicit(state, safe_c, valid,
                                                targets, cfg)
        return _integrate_records(state, image, corners, valid, targets,
                                  x_new, S_new, rep, cfg)
    mu2 = torch.cat([safe_c, torch.full((KA, 1), cfg.rho0, dtype=dtype,
                                        device=dev)], dim=1).reshape(-1)
    noise = torch.where(
        valid[:, None],
        _add_noise(cfg, dtype, dev)[None, :],
        torch.ones((KA, 3), dtype=dtype, device=dev)).reshape(-1)
    mu = torch.cat([state.x, mu2])
    sr = torch.zeros((na, na), dtype=dtype, device=dev)
    sr[:D, :D] = state.S
    k = torch.arange(D, na, device=dev)
    sr[k, k] = noise
    sig = generate_sigma(mu, sr, w.gamma)                     # (na, 2na+1)
    ns = sig.shape[1]

    # mapping function (SLAM.cpp:1177-1250): pixel -> world angles
    pos = sig[D - 4: D - 1]                                   # (3, ns)
    theta_r = sig[D - 1]                                      # (ns,)
    rwc = tf.yaw_matrix(theta_r)                              # (ns, 3, 3)
    uvr = sig[D:].reshape(KA, 3, ns)                          # (KA, 3, ns)
    uv = uvr[:, :2].permute(0, 2, 1)                          # (KA, ns, 2)
    rho_in = uvr[:, 2]                                        # (KA, ns)
    ray = cam_mod.image2camera(cam, cam_mod.undistort(cam, uv))
    hlw = torch.einsum("sij,ksj->ksi", rwc, ray)              # (KA, ns, 3)
    ang = tf.world_to_angles(hlw)                             # (KA, ns, 2)
    if cfg.rho_init_mode == "ceiling":
        # rho = m_z / depth: exact for a flat ceiling
        rho_out = rho_in * torch.cos(ang[..., 1]) * torch.cos(ang[..., 0])
    else:
        rho_out = rho_in

    # scatter outputs into target slot rows
    sig_out = sig[:D].clone()
    ar3 = torch.arange(3, device=dev)
    pos_rows = (6 * targets[:, None] + ar3[None, :]).reshape(-1)
    ang_rows = (6 * targets[:, None] + 3 + ar3[None, :]).reshape(-1)
    pos_vals = pos[None].expand(KA, 3, ns).reshape(-1, ns)
    ang_vals = torch.stack(
        [ang[..., 0], ang[..., 1], rho_out], dim=1).reshape(-1, ns)
    vmask6 = torch.repeat_interleave(valid, 3)
    sig_out[pos_rows] = torch.where(vmask6[:, None], pos_vals,
                                    sig_out[pos_rows])
    sig_out[ang_rows] = torch.where(vmask6[:, None], ang_vals,
                                    sig_out[ang_rows])

    x_new = sig_out @ w.mean_weights(dtype, dev)
    if cfg.qr_mode == "gram":
        # structured Gram: only the 6*KA target-slot rows differ from the
        # +-gamma*S sigma structure
        ridx = torch.cat([pos_rows, ang_rows])
        S_new, rep = structured_sqrt_gram(state.S, sig_out, ridx, w, na,
                                          with_flag=True)
    else:
        S_new = qr_r(deviations(sig_out, w.wi_sr), cfg.qr_mode)
        rep = 0

    return _integrate_records(state, image, corners, valid, targets,
                              x_new, S_new, rep, cfg)


def _integrate_records(state: FilterState, image: torch.Tensor,
                       corners: torch.Tensor, valid: torch.Tensor,
                       targets: torch.Tensor, x_new: torch.Tensor,
                       S_new: torch.Tensor, rep, cfg: SlamConfig):
    """Shared tail of feature integration: landmark records + counters
    (SLAM.cpp:891-946)."""
    dtype = state.x.dtype
    M = cfg.max_landmarks
    KA = cfg.max_new_per_frame
    lm = state.lm
    n_valid = torch.sum(valid.to(torch.int32))
    lids = (state.next_id
            + torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1)
    feats_new = x_new[: 6 * M].reshape(M, 6)[targets]
    xyz = tf.inverse_depth_to_cartesian(feats_new)            # (KA, 3)
    patches = extract_patches(image, corners, cfg.hp_init)    # (KA, P, P)
    robot_pos = x_new[-4:-1]
    theta_now = x_new[-1]

    def scatter(field, vals):
        out = field.clone()
        sel = valid.reshape((-1,) + (1,) * (vals.dim() - 1))
        out[targets] = torch.where(sel, vals.to(field.dtype), field[targets])
        return out

    def zeros_like_rows(field):
        return torch.zeros((KA,) + tuple(field.shape[1:]), dtype=field.dtype,
                           device=field.device)

    active = lm.active.clone()
    active[targets] = valid | lm.active[targets]
    lm_new = replace(
        lm,
        active=active,
        lid=scatter(lm.lid, lids),
        is_loop=scatter(lm.is_loop, zeros_like_rows(lm.is_loop)),
        n_predict=scatter(lm.n_predict, zeros_like_rows(lm.n_predict)),
        n_match=scatter(lm.n_match, zeros_like_rows(lm.n_match)),
        visible=scatter(lm.visible, zeros_like_rows(lm.visible)),
        matched=scatter(lm.matched, zeros_like_rows(lm.matched)),
        pred=scatter(lm.pred, zeros_like_rows(lm.pred)),
        match_px=scatter(lm.match_px, zeros_like_rows(lm.match_px)),
        init_pixel=scatter(lm.init_pixel, corners.to(dtype)),
        init_trans=scatter(lm.init_trans, robot_pos.expand(KA, 3)),
        init_theta=scatter(lm.init_theta, theta_now.expand(KA)),
        init_patch=scatter(lm.init_patch, patches),
        match_patch=scatter(lm.match_patch, zeros_like_rows(lm.match_patch)),
        xyz=scatter(lm.xyz, xyz),
    )
    return count_repairs(
        replace(state, x=x_new, S=S_new, lm=lm_new,
                next_id=(state.next_id + n_valid).to(state.next_id.dtype)),
        rep)


def extract_patches(image: torch.Tensor, corners: torch.Tensor,
                    hp: int) -> torch.Tensor:
    """(K, 2) corner pixels -> (K, 2hp+1, 2hp+1) patches (float32).
    Rounds half to even, like jnp.round."""
    P = 2 * hp + 1
    H, W = image.shape
    cu = torch.clamp(torch.round(corners[:, 0]).to(torch.int64) - hp,
                     0, W - P)
    cv = torch.clamp(torch.round(corners[:, 1]).to(torch.int64) - hp,
                     0, H - P)
    ar = torch.arange(P, device=image.device)
    rows = (cv[:, None] + ar)[:, :, None]
    cols = (cu[:, None] + ar)[:, None, :]
    return image[rows, cols].to(torch.float32)


# ---------------------------------------------------------------------------
# loop re-insertion + redirection (SLAM.cpp:948-1015, 1343-1428)
# ---------------------------------------------------------------------------


def readd_stored(state: FilterState, readd_mask: torch.Tensor,
                 cfg: SlamConfig) -> FilterState:
    """Splice stored features back into free slots with their saved 6-dim
    state and 6x6 sqrt block, decoupled from the rest (SLAM.cpp:948-1015).

    The JAX package's scan over the stored table, on fixed shapes and with
    no host read: the r-th set record (table order) goes to the r-th free
    slot (slot order), the first slot still free when the record before it
    has taken its own; the pairs beyond min(records, free slots) are masked
    out, so records left over when the map is full stay in the table."""
    M = cfg.max_landmarks
    K = readd_mask.shape[0]
    if K == 0:
        return state
    dev = state.x.device
    sd, lm = state.stored, state.lm
    free = ~lm.active
    rec_rank = torch.cumsum(readd_mask.to(torch.int64), 0) - 1   # (K,)
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1        # (M,)
    n_pairs = torch.minimum(rec_rank[-1] + 1, free_rank[-1] + 1)
    # the record of each rank (a dump entry K takes the unset records)
    at = torch.where(readd_mask, rec_rank, torch.full_like(rec_rank, K))
    of_rank = torch.zeros(K + 1, dtype=torch.int64, device=dev).scatter_(
        0, at, torch.arange(K, device=dev))[:K]
    take = free & (free_rank < n_pairs)                          # (M,)
    js = of_rank[torch.clamp(free_rank, 0, K - 1)]               # (M,)

    rows = torch.cat([torch.repeat_interleave(take, 6),
                      torch.zeros(4, dtype=torch.bool, device=dev)])
    x_new = state.x.clone()
    x_new[:6 * M] = torch.where(rows[:6 * M],
                                sd.state[js].reshape(-1).to(x_new.dtype),
                                x_new[:6 * M])
    # zero the slots' rows and columns, then write the saved blocks
    S_new = torch.where(rows[:, None] | rows[None, :],
                        torch.zeros_like(state.S), state.S)
    blocks = S_new[:6 * M, :6 * M].view(M, 6, M, 6)
    ar = torch.arange(M, device=dev)
    blocks[ar, :, ar, :] = torch.where(
        take[:, None, None], sd.sr[js].to(S_new.dtype), blocks[ar, :, ar, :])

    def put(field, vals):
        shape = (M,) + (1,) * (field.dim() - 1)
        return torch.where(take.reshape(shape), vals.to(field.dtype), field)

    lm_new = replace(
        lm,
        active=lm.active | take,
        lid=put(lm.lid, sd.lid[js]),
        is_loop=lm.is_loop | take,
        n_predict=put(lm.n_predict, torch.zeros_like(lm.n_predict)),
        n_match=put(lm.n_match, torch.zeros_like(lm.n_match)),
        visible=lm.visible & ~take,
        matched=lm.matched & ~take,
        init_pixel=put(lm.init_pixel, sd.init_pixel[js]),
        init_trans=put(lm.init_trans, sd.init_trans[js]),
        init_theta=put(lm.init_theta, sd.init_theta[js]),
        init_patch=put(lm.init_patch, sd.init_patch[js]),
        xyz=put(lm.xyz, sd.xyz[js]),
    )
    valid = sd.valid & ~(readd_mask & (rec_rank < n_pairs))
    return replace(state, x=x_new, S=S_new, lm=lm_new,
                   stored=replace(sd, valid=valid))


def project_stored(state: FilterState, cfg: SlamConfig) -> torch.Tensor:
    """Current-view pixels of stored features (SLAM.cpp:618-638), (K, 2)."""
    pos = state.x[-4:-1]
    rcw = tf.yaw_matrix(state.x[-1]).T
    hlw = tf.state_to_world(state.stored.state, pos)
    hlr = torch.einsum("ij,kj->ki", rcw, hlw)
    return cam_mod.project(cfg.camera, hlr)


def redirect_reset(state: FilterState, theta_odo: torch.Tensor,
                   cfg: SlamConfig) -> FilterState:
    """Snapshot everything, reset to robot-only state (SLAM.cpp:1354-1405).

    Feature re-detection / loop re-add happens right after via the normal
    add path with is_redirect=True.
    """
    dtype, dev = state.x.dtype, state.x.device
    M = cfg.max_landmarks
    recs = snapshot_records(state, cfg)
    stored = store_features(state.stored, recs, state.lm.active)

    x_new = _feature_defaults(M, dtype, dev)
    x_new[-4] = state.x[-4]
    x_new[-3] = state.x[-3]
    x_new[-1] = theta_odo.to(dtype)
    s_diag = torch.ones(cfg.state_dim, dtype=dtype, device=dev)
    s_diag[-4:] = control.constant(
        (cfg.sigma_x, cfg.sigma_y, cfg.sigma_z, cfg.sigma_theta), dtype, dev)
    lm = state.lm
    zero_i = torch.zeros_like(lm.n_predict)
    lm_new = replace(
        lm,
        active=torch.zeros_like(lm.active),
        lid=torch.zeros_like(lm.lid),
        is_loop=torch.zeros_like(lm.is_loop),
        n_predict=zero_i, n_match=zero_i,
        visible=torch.zeros_like(lm.visible),
        matched=torch.zeros_like(lm.matched),
    )
    return replace(state, x=x_new, S=torch.diag(s_diag), lm=lm_new,
                   stored=stored)
