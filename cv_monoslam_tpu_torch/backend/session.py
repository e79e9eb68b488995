"""Keyframe manager: filter -> sliding-window BA -> pose graph.

Host-side bookkeeping (association by landmark ID, window assembly, loop
detection; numpy float64) around the solvers in :mod:`ba` and
:mod:`pose_graph`, which run on the session's device: only
:meth:`BackendSession.window_problem` and :meth:`BackendSession.graph` hand
arrays to the device, and each solve's results come back in one fetch. The
reference has no analogue — its redirection snapshot (SLAM.cpp:1354-1428)
is the semantic seed of the keyframe here (a frame where the map is
snapshotted), but the optimization is new capability (bench config 4).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional

import numpy as np
import torch

from ..config import SlamConfig
from ..filter.state import FilterState, resolve_device
from .ba import BAProblem, ba_solve, reprojection_rmse
from .pose_graph import PoseGraph, pose_graph_solve


@dataclasses.dataclass
class Keyframe:
    frame: int
    pose: np.ndarray          # (3,) x, y, theta — refined in place by BA
    odo: np.ndarray           # (3,) odometry x, y, theta at this frame
    lids: np.ndarray          # (K,) matched landmark ids
    pixels: np.ndarray        # (K, 2) matched pixel observations
    xyz: np.ndarray           # (K, 3) landmark world estimates
    #: BA prior anchor. Starts as the filter estimate and is REBASED when a
    #: pose-graph loop correction commits (it must stay consistent with the
    #: rebased landmark evidence, or window BA would revert the correction)
    pose0: Optional[np.ndarray] = None
    #: (3,) filter pose sigma (x, y, theta) at creation — the BA anchor
    #: weight; None falls back to a loose default
    pose_sigma: Optional[np.ndarray] = None
    #: full active map at keyframe time (place-recognition constellation;
    #: a superset of the matched set — loop detection needs every landmark
    #: the filter knows here, not just this frame's matches)
    map_lids: Optional[np.ndarray] = None
    map_xyz: Optional[np.ndarray] = None
    #: IMMUTABLE original filter pose — the anchor for composing live
    #: filter poses onto refined keyframes (api.trajectory_refined) and
    #: the relative-motion MEASUREMENT between consecutive keyframes.
    #: Never rebased: measurements don't change when estimates do.
    pose_filter: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.pose0 is None:
            self.pose0 = np.asarray(self.pose, dtype=np.float64).copy()
        if self.pose_filter is None:
            self.pose_filter = np.asarray(self.pose,
                                          dtype=np.float64).copy()
        if self.map_lids is None:
            # copies, not aliases: _rebase applies the rigid correction to
            # xyz and map_xyz independently — a shared array would be
            # corrected twice
            self.map_lids = np.asarray(self.lids).copy()
            self.map_xyz = np.asarray(self.xyz, dtype=np.float64).copy()


def make_keyframe(frame: int, pose4: np.ndarray, odo: np.ndarray,
                  lid: np.ndarray, matched: np.ndarray,
                  match_px: np.ndarray, xyz: np.ndarray,
                  pose_sqrt_cov: Optional[np.ndarray] = None,
                  active: Optional[np.ndarray] = None) -> Keyframe:
    """Build a keyframe from raw per-frame arrays (the ``lm_*`` telemetry
    fields of ``slam_step`` outputs, or a live FilterState)."""
    sel = np.flatnonzero(np.asarray(matched))
    pose = np.asarray(pose4)
    sigma = None
    if pose_sqrt_cov is not None:
        sc = np.asarray(pose_sqrt_cov, dtype=np.float64)
        sigma = sc[[0, 1, 3]]                 # (x, y, theta) of (x,y,z,th)
    map_sel = (np.flatnonzero(np.asarray(active))
               if active is not None else sel)
    return Keyframe(
        frame=frame,
        pose=np.array([pose[0], pose[1], pose[3]]),
        odo=np.asarray(odo, dtype=np.float64),
        lids=np.asarray(lid)[sel],
        pixels=np.asarray(match_px)[sel],
        xyz=np.asarray(xyz)[sel],
        pose_sigma=sigma,
        map_lids=np.asarray(lid)[map_sel],
        map_xyz=np.asarray(xyz)[map_sel],
    )


def keyframe_from_state(frame: int, state: FilterState,
                        odo: np.ndarray) -> Keyframe:
    lm = state.lm
    # one fetch for everything the keyframe reads off the device
    M = lm.lid.shape[0]
    f64 = torch.float64
    S4 = state.S[:, -4:]
    flat = torch.cat([
        torch.sqrt(torch.clamp((S4 * S4).sum(dim=0), min=0.0)).to(f64),
        state.x[-4:].to(f64), lm.lid.to(f64),
        (lm.matched & lm.active).to(f64), lm.active.to(f64),
        lm.match_px.reshape(-1).to(f64), lm.xyz.reshape(-1).to(f64),
    ]).cpu().numpy()
    sc, pose4 = flat[0:4], flat[4:8]
    lid, matched, active, px, xyz = np.split(
        flat[8:], [M, 2 * M, 3 * M, 5 * M])
    return make_keyframe(frame, pose4, odo, lid.astype(np.int32),
                         matched != 0.0, px.reshape(M, 2),
                         xyz.reshape(M, 3), pose_sqrt_cov=sc,
                         active=active != 0.0)


def _mutual_nn_pairs(a_xy: np.ndarray, b_xy: np.ndarray, radius: float):
    """Indices (ia, ib) of mutual nearest neighbours within ``radius``.

    Small-drift pairing only: works when the accumulated drift stays below
    half the landmark spacing. At a genuine revisit the drift is by
    definition large — :func:`_constellation_align` handles that regime."""
    if len(a_xy) == 0 or len(b_xy) == 0:
        return None
    d2 = ((a_xy[:, None, :] - b_xy[None, :, :]) ** 2).sum(-1)
    nb = d2.argmin(axis=1)                    # a -> nearest b
    na = d2.argmin(axis=0)                    # b -> nearest a
    ia = np.flatnonzero((na[nb] == np.arange(len(a_xy)))
                        & (d2[np.arange(len(a_xy)), nb] < radius ** 2))
    return ia, nb[ia]


def _rigid_apply(dth: float, t: np.ndarray, xy: np.ndarray) -> np.ndarray:
    c, s = np.cos(dth), np.sin(dth)
    return np.stack([c * xy[:, 0] - s * xy[:, 1] + t[0],
                     s * xy[:, 0] + c * xy[:, 1] + t[1]], axis=1)


def _one_to_one_inliers(pred: np.ndarray, b_xy: np.ndarray, tol: float):
    """Greedy one-to-one assignment of predicted points to b within tol.

    Returns (rows, cols): indices into pred / b_xy. Ties on a shared target
    go to the closer point (lexsort by target then distance) so many-to-one
    aliasing cannot inflate the inlier count."""
    d2 = ((pred[:, None, :] - b_xy[None, :, :]) ** 2).sum(-1)
    nnb = d2.argmin(axis=1)
    dmin = d2[np.arange(len(pred)), nnb]
    rows = np.flatnonzero(dmin < tol * tol)
    if rows.size == 0:
        return rows, rows
    order = rows[np.lexsort((dmin[rows], nnb[rows]))]
    cols = nnb[order]
    first = np.concatenate([[True], cols[1:] != cols[:-1]])
    return order[first], cols[first]


def _constellation_align(a_xy: np.ndarray, b_xy: np.ndarray, tol: float,
                         min_inliers: int, max_hyp: int = 256):
    """Drift-invariant place recognition: rigidly align two landmark
    constellations by RANSAC over pairwise-DISTANCE-compatible
    correspondence hypotheses.

    Mutual-NN pairing fails exactly when a loop closure matters — the
    accumulated drift (which the loop is supposed to remove) exceeds any
    fixed pairing radius. Inter-landmark distances are invariant to rigid
    drift, so hypotheses come from point PAIRS whose separations agree
    within ``2*tol``; each hypothesis is scored by one-to-one inlier count
    under ``tol`` and the winner is refit by Procrustes on its inliers.
    Deterministic (hypotheses ranked by distance agreement, capped at
    ``max_hyp``). Returns (dth, t, (rows, cols), rms) with
    ``b ~ R(dth) a + t``, or None.
    """
    na, nb = len(a_xy), len(b_xy)
    if na < min_inliers or nb < min_inliers:
        return None
    ia, ja = np.triu_indices(na, 1)
    ib, jb = np.triu_indices(nb, 1)
    da = np.hypot(*(a_xy[ja] - a_xy[ia]).T)
    db = np.hypot(*(b_xy[jb] - b_xy[ib]).T)
    # hypotheses need rotational leverage: baselines well above the noise
    keep = np.flatnonzero(da > max(4.0 * tol, 0.08))
    if keep.size == 0:
        return None
    # distance-compatible pairs via searchsorted over sorted db — O(P log P)
    # instead of the dense |pairs_a| x |pairs_b| difference matrix (which at
    # constellation size ~100 is a multi-GB allocation)
    ob = np.argsort(db, kind="stable")
    db_s = db[ob]
    lo = np.searchsorted(db_s, da[keep] - 2.0 * tol)
    hi = np.searchsorted(db_s, da[keep] + 2.0 * tol)
    cnt = hi - lo
    if int(cnt.sum()) == 0:
        return None
    pa = np.repeat(np.arange(keep.size), cnt)
    pb = ob[np.concatenate([np.arange(l, h)
                            for l, h in zip(lo, hi) if h > l])]
    order = np.argsort(np.abs(da[keep][pa] - db[pb]),
                       kind="stable")[: max_hyp // 2]
    pa = keep[pa[order]]
    pb = pb[order]
    # score ALL hypotheses (both swap orientations) in one vectorized
    # pass — a per-hypothesis python loop is the dominant host cost of a
    # long run (~50 candidate pairs x 256 fits per keyframe, growing with
    # keyframe count). Score = number of DISTINCT b-targets hit within tol (the
    # same anti-aliasing cap the exact one-to-one assignment enforces).
    a0 = np.concatenate([ia[pa], ia[pa]])
    a1 = np.concatenate([ja[pa], ja[pa]])
    b0 = np.concatenate([ib[pb], jb[pb]])
    b1 = np.concatenate([jb[pb], ib[pb]])
    va = a_xy[a1] - a_xy[a0]                            # (K, 2)
    vb = b_xy[b1] - b_xy[b0]
    dth_k = (np.arctan2(vb[:, 1], vb[:, 0])
             - np.arctan2(va[:, 1], va[:, 0]))
    ck, sk = np.cos(dth_k), np.sin(dth_k)
    t_k = b_xy[b0] - np.stack(
        [ck * a_xy[a0, 0] - sk * a_xy[a0, 1],
         sk * a_xy[a0, 0] + ck * a_xy[a0, 1]], axis=1)  # (K, 2)
    pred = np.stack(
        [ck[:, None] * a_xy[None, :, 0] - sk[:, None] * a_xy[None, :, 1],
         sk[:, None] * a_xy[None, :, 0] + ck[:, None] * a_xy[None, :, 1]],
        axis=2) + t_k[:, None, :]                       # (K, na, 2)
    d2 = ((pred[:, :, None, :] - b_xy[None, None, :, :]) ** 2).sum(-1)
    nnb = d2.argmin(axis=2)                             # (K, na)
    hit = np.take_along_axis(d2, nnb[:, :, None],
                             axis=2)[:, :, 0] < tol * tol
    K = len(dth_k)
    keyv = nnb + nb * np.arange(K)[:, None]
    scores = np.bincount(np.unique(keyv[hit]) // nb, minlength=K)
    # the distinct-NN score is an approximation of the exact one-to-one
    # inlier count, so the top-scoring hypothesis can fail the exact
    # floor while a lower-ranked one passes — verify the top few by score
    # before giving up
    for kbest in np.argsort(scores, kind="stable")[::-1][:5]:
        if scores[kbest] < min_inliers:
            break
        rows, cols = _one_to_one_inliers(pred[kbest], b_xy, tol)
        if len(rows) < min_inliers:
            continue
        # refit on the winning inlier set, re-gate, refit once more
        ok = True
        for _ in range(2):
            fit = _procrustes2d(a_xy[rows], b_xy[cols])
            if fit is None:
                ok = False
                break
            dth, t = fit
            rows, cols = _one_to_one_inliers(
                _rigid_apply(dth, t, a_xy), b_xy, tol)
            if len(rows) < min_inliers:
                ok = False
                break
        if not ok:
            continue
        res = _rigid_apply(dth, t, a_xy[rows]) - b_xy[cols]
        rms = float(np.sqrt((res ** 2).sum(1).mean()))
        return dth, t, (rows, cols), rms
    return None


def _robust_procrustes2d(a_xy: np.ndarray, b_xy: np.ndarray, tol: float,
                         min_pairs: int, max_samples: int = 64):
    """RANSAC rigid fit over mutual-NN pairs: mutual-NN pairing at a
    revisit always contains mispairs (aliasing to a neighbouring
    landmark), and a contaminated least-squares fit spreads the error over
    every residual — so hypothesize from 2-point minimal samples, score by
    inlier count under ``tol``, then refit on the winning inlier set.
    Deterministic (enumerates pairs, capped). Returns
    (dth, t, inlier_mask, rms) or None."""
    n = len(a_xy)
    if n < max(min_pairs, 2):
        return None
    best = None
    # stride the (i, j) enumeration so the capped sample budget spans the
    # whole point set instead of exhausting itself on the first few points
    pairs = list(itertools.combinations(range(n), 2))
    stride = max(1, -(-len(pairs) // max_samples))
    for i, j in itertools.islice(pairs[::stride], max_samples):
        va = a_xy[j] - a_xy[i]
        vb = b_xy[j] - b_xy[i]
        if (va @ va) < 1e-8:
            continue
        dth = float(np.arctan2(vb[1], vb[0]) - np.arctan2(va[1], va[0]))
        c, s = np.cos(dth), np.sin(dth)
        t = b_xy[i] - np.array([c * a_xy[i, 0] - s * a_xy[i, 1],
                                s * a_xy[i, 0] + c * a_xy[i, 1]])
        pred = _rigid_apply(dth, t, a_xy)
        res2 = ((pred - b_xy) ** 2).sum(1)
        inl = res2 < tol ** 2
        score = int(inl.sum())
        if best is None or score > best[0]:
            best = (score, inl)
    if best is None or best[0] < max(min_pairs, 2):
        return None
    keep = best[1]
    fit = _procrustes2d(a_xy[keep], b_xy[keep])
    if fit is None:
        return None
    dth, t = fit
    c, s = np.cos(dth), np.sin(dth)
    pred = np.stack([c * a_xy[:, 0] - s * a_xy[:, 1] + t[0],
                     s * a_xy[:, 0] + c * a_xy[:, 1] + t[1]], axis=1)
    res = np.sqrt(((pred - b_xy) ** 2).sum(1))
    keep = res < tol
    if keep.sum() < max(min_pairs, 2):
        return None
    rms = float(np.sqrt((res[keep] ** 2).mean()))
    return dth, t, keep, rms


def _procrustes2d(old_xy: np.ndarray, new_xy: np.ndarray):
    """Planar rigid transform (dth, t) with new ~ R(dth) old + t.

    Least-squares over matched landmark pairs; returns None when the pairs
    are unusable, and a translation-only fit when they have no rotational
    leverage (all points nearly coincident)."""
    if len(old_xy) < 2:
        return None
    a = old_xy - old_xy.mean(axis=0)
    b = new_xy - new_xy.mean(axis=0)
    spread = float(np.sqrt((a * a).sum(axis=1).mean()))
    if spread < 1e-3:
        dth = 0.0
    else:
        dth = float(np.arctan2((a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]).sum(),
                               (a * b).sum()))
    c, s = np.cos(dth), np.sin(dth)
    r_old = old_xy.mean(axis=0)
    t = new_xy.mean(axis=0) - np.array([c * r_old[0] - s * r_old[1],
                                        s * r_old[0] + c * r_old[1]])
    return dth, t


def _relpose_np(p0, p1):
    c, s = np.cos(p0[2]), np.sin(p0[2])
    d = p1[:2] - p0[:2]
    dth = np.arctan2(np.sin(p1[2] - p0[2]), np.cos(p1[2] - p0[2]))
    return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], dth])


class BackendSession:
    """Collects keyframes; solves window BA and the global pose graph."""

    def __init__(self, cfg: SlamConfig, max_nodes: int = 64,
                 max_lms: int = 64, loop_min_shared: int = 3,
                 loop_min_sep: Optional[int] = None,
                 loop_pair_radius: float = 0.12,
                 loop_fit_tol: float = 0.05,
                 loop_geo_min_inliers: int = 6,
                 loop_max_drift: float = 2.0,
                 loop_confirm: int = 2,
                 loop_pending_ttl: int = 3, device=None):
        self.cfg = cfg
        #: the device the solvers run on: ``cuda`` unless the caller names
        #: another (the tests pass ``"cpu"``); without one and without CUDA
        #: this raises
        self.device = resolve_device(device)
        self.max_nodes = max_nodes
        self.max_lms = max_lms
        self.loop_min_shared = loop_min_shared
        #: keyframe separation below which co-observation is not a loop
        self.loop_min_sep = (2 * cfg.ba_window if loop_min_sep is None
                             else loop_min_sep)
        self.loop_pair_radius = loop_pair_radius
        self.loop_fit_tol = loop_fit_tol
        #: constellation-path inlier floor: stricter than the id path
        #: because id-free alignment of random constellations reaches 5
        #: coincidental inliers often enough to inject false loop edges
        #: (on the lap scenario a floor of 5 admitted false edges and
        #: degraded the refined ATE; 6 kept the genuine edge only)
        self.loop_geo_min_inliers = loop_geo_min_inliers
        #: sanity cap on the fitted drift magnitude (m)
        self.loop_max_drift = loop_max_drift
        #: half-width (in keyframes) of the neighborhood union used as the
        #: old-place constellation in loop detection
        self.loop_union_kfs = 2
        #: cap on constellation size fed to pairing: the hypothesis space is
        #: O(n^2) pairs per side, so an uncapped union of full active maps
        #: (up to max_landmarks per keyframe x 5 keyframes) would blow up
        #: both time and memory at the M=512 config
        self.loop_max_const = 64
        #: temporal-consistency requirement: a loop candidate commits only
        #: after ``loop_confirm`` gate-passing sightings of the SAME place
        #: with a CONSISTENT drift transform at consecutive keyframes.
        #: A genuine revisit re-fires at the next keyframes with coherent
        #: drift, while chance constellation alignments of the same old
        #: place give wildly different transforms each sighting; a single
        #: 6-inlier chance edge can pass every static gate and degrade the
        #: refined trajectory. 1 = commit immediately.
        self.loop_confirm = loop_confirm
        #: keyframes a pending (unconfirmed) sighting stays alive
        self.loop_pending_ttl = loop_pending_ttl
        #: view-footprint diagonal (m): the ceiling patch a camera at
        #: height cfg.deep sees spans deep*H/f1 x deep*W/f2 world metres
        #: (the renderer's inverse projection, io/synthetic.py render();
        #: swapped-axis pairing per SLAM.cpp:3360-3363), so two camera
        #: positions can co-observe landmarks only within its diagonal —
        #: derived from the config rather than the old hardcoded 3.2
        #: (other ceiling heights/FOVs silently skipped genuine loop
        #: candidates)
        cam = cfg.camera
        self.view_footprint = float(cfg.deep * np.hypot(
            cam.width / cam.f2, cam.height / cam.f1))
        self._pending: List[dict] = []
        #: {old keyframe index -> newest committing j}: places with a
        #: COMMITTED loop edge. A later sighting of a validated place
        #: skips the confirmation delay ONLY while the revisit is still
        #: in progress (within loop_pending_ttl keyframes of the last
        #: commit) — pending state is cleared by the rebase, so a revisit
        #: spanning several keyframes would otherwise lose its
        #: post-relaxation edges. The window is time-limited because an
        #: open-ended fast path would re-admit exactly the single-sighting
        #: chance alignments the confirmation exists to reject.
        self._validated: dict = {}
        self.keyframes: List[Keyframe] = []
        self.loop_edges: List[tuple] = []     # (i, j, rel, (sig_xy, sig_th))
        #: per-candidate loop diagnosis: every (i, j) where a rigid fit was
        #: found, accepted or not, with the gate values (bench/diag evidence
        #: — a recorded run must be able to explain its own edges)
        self.edge_log: List[dict] = []

    # -- collection --------------------------------------------------------

    def maybe_add(self, frame: int, state: FilterState,
                  odo: np.ndarray) -> Optional[Keyframe]:
        if frame % self.cfg.keyframe_every != 0:
            return None
        return self._add(keyframe_from_state(frame, state, odo))

    def maybe_add_telemetry(self, frame: int, pose4, odo, lid, matched,
                            match_px, xyz, pose_sqrt_cov=None,
                            active=None) -> Optional[Keyframe]:
        """Keyframe from chunked-scan telemetry (no FilterState needed)."""
        if frame % self.cfg.keyframe_every != 0:
            return None
        return self._add(make_keyframe(frame, pose4, odo, lid, matched,
                                       match_px, xyz,
                                       pose_sqrt_cov=pose_sqrt_cov,
                                       active=active))

    def _add(self, kf: Keyframe) -> Optional[Keyframe]:
        if len(kf.lids) == 0:
            return None
        self._detect_loops(kf)
        self.keyframes.append(kf)
        if len(self.keyframes) > self.max_nodes:
            self.keyframes.pop(0)
            self.loop_edges = [(i - 1, j - 1, r, w)
                               for i, j, r, w in self.loop_edges
                               if i > 0 and j > 0]
            # filter on PRE-decrement indices (0 is evicted, 1 survives
            # as 0) — matching the loop_edges reindexing above
            self._pending = [p for p in self._pending
                             if p["i"] > 0 and p["j"] > 0]
            for p in self._pending:           # keep indices aligned
                p["i"] -= 1
                p["j"] -= 1
            self._validated = {i - 1: j - 1
                               for i, j in self._validated.items()
                               if i > 0 and j > 0}
        return kf

    def _confirm(self, cand: dict) -> Optional[List[dict]]:
        """Temporal-consistency check: the pending sightings (earlier
        keyframes) of the same place whose drift transform agrees with
        ``cand``'s, or None when the candidate is not yet corroborated.

        Agreement is evaluated as displacement at ``cand``'s inlier
        centroid (origin-independent, same metric as the gates) plus the
        rotation angle. Sightings at the SAME keyframe don't count — the
        overlapping neighborhood constellations of adjacent old keyframes
        share landmarks, so same-j agreement is not independent evidence."""
        j = cand["j"]
        if self.loop_confirm <= 1 or any(
                abs(cand["i"] - vi) <= 2 * self.loop_union_kfs
                and j - vj <= self.loop_pending_ttl
                for vi, vj in self._validated.items()):
            return []
        cen = cand["cen"]
        hits = []
        for p in self._pending:
            if p["j"] >= j:
                continue
            if abs(p["i"] - cand["i"]) > 2 * self.loop_union_kfs:
                continue                      # different place
            c, s = np.cos(p["dth"]), np.sin(p["dth"])
            disp_p = np.array(
                [c * cen[0] - s * cen[1] + p["t"][0] - cen[0],
                 s * cen[0] + c * cen[1] + p["t"][1] - cen[1]])
            ddth = abs(np.arctan2(np.sin(cand["dth"] - p["dth"]),
                                  np.cos(cand["dth"] - p["dth"])))
            if (ddth < 0.2
                    and float(np.hypot(*(cand["disp"] - disp_p))) < 0.35):
                hits.append(p)
        if len(hits) + 1 >= self.loop_confirm:
            for p in hits:
                self._pending.remove(p)
            return hits
        return None

    def _place_constellation(self, i: int, j: int):
        """Union of active-map landmarks of keyframes ``i ± loop_union_kfs``
        (bounded away from the new keyframe ``j`` by ``loop_min_sep``),
        deduplicated by landmark id with the estimate closest in time to
        keyframe ``i`` winning."""
        parts_l: list = []
        parts_p: list = []
        for di in sorted(range(-self.loop_union_kfs,
                               self.loop_union_kfs + 1), key=abs):
            kidx = i + di
            if kidx < 0 or kidx >= len(self.keyframes):
                continue
            if j - kidx <= self.loop_min_sep:
                continue
            nb = self.keyframes[kidx]
            parts_l.append(np.asarray(nb.map_lids, dtype=np.int64))
            parts_p.append(np.asarray(nb.map_xyz)[:, :2])
        if not parts_l:
            return np.zeros(0, np.int64), np.zeros((0, 2))
        lids = np.concatenate(parts_l)
        pts = np.concatenate(parts_p)
        # dedup by id, FIRST occurrence winning (center keyframe's
        # estimate — parts are appended center-first); vectorized: the
        # per-landmark python loop here ran ~50x per new keyframe and
        # grew with keyframe count (longrun slowdown, r4)
        _, first = np.unique(lids, return_index=True)
        sel = np.sort(first)[: self.loop_max_const]
        return lids[sel], pts[sel]

    def _detect_loops(self, kf: Keyframe) -> None:
        """Loop detection against non-adjacent keyframes — the graph
        generalization of the reference's re-identification re-add
        (SLAM.cpp:699-729, 948-1015).

        The loop edge's relative-pose MEASUREMENT comes from the shared
        landmark geometry, not from the current pose estimates (those
        contain exactly the drift the loop is supposed to remove). Three
        pairing paths, cheapest first, over the FULL active map at each
        keyframe (``map_xyz``, not just that frame's matches):

        1. exact landmark-id re-identification (redirect re-adds restore
           stored ids — the reference's mechanism);
        2. mutual-NN proximity (drift below the pairing radius);
        3. drift-invariant constellation alignment — RANSAC over
           pairwise-distance-compatible correspondences — which is the
           path that fires at a genuine revisit, where the drift is large.

        The fitted rigid transform D (new ~ D(old)) IS the accumulated
        drift; the corrected new pose is D^-1 applied to the current one.
        """
        j = len(self.keyframes)
        # expire stale pendings unconditionally (pruning only
        # inside _confirm let them linger — holding arrays and skewing
        # _pending — while a place kept committing via the validated
        # fast path)
        self._pending = [p for p in self._pending
                         if j - p["j"] <= self.loop_pending_ttl]
        b_pts_full = np.asarray(kf.map_xyz)[:, :2]
        b_lids_full = np.asarray(kf.map_lids)
        b_pts, b_lids = b_pts_full, b_lids_full
        if len(b_pts) > self.loop_max_const:
            # cap the new-keyframe side too (even stride keeps spatial
            # coverage): at M=512 an uncapped 400+-point b side makes the
            # vectorized hypothesis arrays ~100 MB per candidate pair.
            # Only the GEOMETRIC paths are capped — the exact-id path
            # below intersects the full id set (O(n log n); a 64-point
            # subsample of 400+ ids starved shared-id re-identification
            # below loop_min_shared)
            sub = np.linspace(0, len(b_pts) - 1,
                              self.loop_max_const).astype(int)
            b_pts = b_pts[sub]
            b_lids = b_lids[sub]
        last_hit = None                       # suppress near-duplicate edges
        for i, old in enumerate(self.keyframes[:-1]):
            # real revisits only: keyframes well outside the live window
            # (inside it, co-observation is the norm, not a loop)
            if j - i <= self.loop_min_sep:
                continue
            if last_hit is not None and i - last_hit <= self.loop_union_kfs:
                continue                      # same place already matched
            # view-overlap prefilter: two places can share landmarks only
            # if their (estimated) camera positions are within the view
            # footprint plus the maximum admissible drift — skips the
            # constellation build + RANSAC for hopeless pairs
            if (float(np.hypot(*(np.asarray(old.pose[:2])
                                 - np.asarray(kf.pose[:2]))))
                    > self.view_footprint + self.loop_max_drift):
                continue
            # place constellation around old keyframe i: the UNION of the
            # active maps of keyframes i±loop_union_kfs (dedup by id,
            # central keyframe's estimate wins). A single keyframe's map
            # shares too few physical landmarks with the revisit view
            # (slot churn re-picks corners differently on each pass); the
            # neighborhood union covers the old place densely enough for
            # the inlier floor to separate real alignments from chance.
            a_lids, a_pts = self._place_constellation(i, j)
            drift, path, n_inl, a_used = None, None, 0, None
            # size-scaled inlier floors for the GEOMETRIC paths: a fixed
            # floor stops separating genuine from chance as constellations
            # grow (measured on the frozen lap fixture: genuine revisit
            # alignments reach 8-10 inliers of ~25-point sides while
            # chance alignments of the same sides reach 6-7 — the fixed
            # 6-floor admitted those, and near-identity NN aliasing even
            # SELF-CONFIRMS, identity agreeing with identity). The exact-
            # id path keeps the small fixed floor: ids cannot alias.
            side = min(len(a_pts), len(b_pts))
            geo_floor = max(self.loop_geo_min_inliers,
                            int(round(0.3 * side)))
            nn_floor = max(self.loop_min_shared, int(round(0.4 * side)))
            # (1) exact re-identification by landmark id — over the FULL
            # new-keyframe id set (uncapped; see b-side cap note above)
            shared, ia, ib = np.intersect1d(a_lids, b_lids_full,
                                            return_indices=True)
            if len(shared) >= self.loop_min_shared:
                drift = _robust_procrustes2d(
                    a_pts[ia], b_pts_full[ib], self.loop_fit_tol,
                    self.loop_min_shared)
                if drift is not None:
                    path, n_inl = "id", int(drift[2].sum())
                    a_used = a_pts[ia][drift[2]]
            if drift is None:
                # (2) small-drift proximity pairing: when the true drift
                # is below the pairing radius, MOST of the smaller side
                # mutually pairs — a handful of pairs at large true drift
                # is aliasing, not evidence
                pairs = _mutual_nn_pairs(a_pts, b_pts,
                                         self.loop_pair_radius)
                if pairs is not None and len(pairs[0]) >= nn_floor:
                    drift = _robust_procrustes2d(
                        a_pts[pairs[0]], b_pts[pairs[1]],
                        self.loop_fit_tol, nn_floor)
                    if drift is not None:
                        path, n_inl = "nn", int(drift[2].sum())
                        a_used = a_pts[pairs[0]][drift[2]]
            if drift is None:
                # (3) large-drift constellation alignment
                fit = _constellation_align(a_pts, b_pts, self.loop_fit_tol,
                                           geo_floor)
                if fit is not None:
                    drift = fit
                    path, n_inl = "geo", len(fit[2][0])
                    a_used = a_pts[fit[2][0]]
            if drift is None:
                # (4) pending-hypothesis verification: detection needs
                # geo_floor inliers under an argmax over ~256 transform
                # hypotheses, but an EXISTING pending sighting of this
                # place supplies ONE specific transform to test — and
                # verifying a fixed transform at tol has a far lower
                # chance rate than searching, so a smaller floor carries
                # the same strength. This is what lets a revisit whose
                # keyframe map sits at a slot-churn minimum (10-14
                # landmarks on the frozen lap fixture — too thin for the
                # search floor) still corroborate the first sighting
                # instead of starving temporal confirmation.
                floor_c = max(4, int(round(0.25 * side)))
                for p in self._pending:
                    if (p["j"] >= j
                            or abs(p["i"] - i) > 2 * self.loop_union_kfs):
                        continue
                    # the pending transform is keyframes stale and drift
                    # keeps accumulating, so pair FIRST at the same
                    # displacement tolerance the confirmation agreement
                    # allows (0.35 m), then demand the refit converge at
                    # the tight fit tol — loose association, strict
                    # verification
                    pred = _rigid_apply(p["dth"], p["t"], a_pts)
                    rows, cols = _one_to_one_inliers(pred, b_pts, 0.35)
                    if len(rows) < floor_c:
                        continue
                    ok = True
                    dth_c = t_c = None
                    for it in range(3):
                        fit = _procrustes2d(a_pts[rows], b_pts[cols])
                        if fit is None:
                            ok = False
                            break
                        dth_c, t_c = fit
                        rows, cols = _one_to_one_inliers(
                            _rigid_apply(dth_c, t_c, a_pts), b_pts,
                            self.loop_fit_tol if it else 0.15)
                        if len(rows) < floor_c:
                            ok = False
                            break
                    if not ok:
                        continue
                    res = (_rigid_apply(dth_c, t_c, a_pts[rows])
                           - b_pts[cols])
                    drift = (dth_c, np.asarray(t_c), (rows, cols),
                             float(np.sqrt((res ** 2).sum(1).mean())))
                    path, n_inl = "confirm", len(rows)
                    a_used = a_pts[rows]
                    break
            if drift is None:
                continue
            dth, t, _, rms = drift            # new_xy ~ R(dth) old_xy + t
            c, s = np.cos(dth), np.sin(dth)
            # the drift magnitude that the gates compare against pose
            # uncertainty is the DISPLACEMENT AT THE PLACE — evaluated at
            # the inlier centroid: the raw Procrustes t is origin-dependent
            # (t = drift_at_place - (R - I) @ place), so gating on |t| both
            # rejects genuine far-from-origin loops and passes spurious
            # near-origin ones
            cen = a_used.mean(axis=0)
            disp = np.array([c * cen[0] - s * cen[1] + t[0] - cen[0],
                             s * cen[0] + c * cen[1] + t[1] - cen[1]])
            disp_n = float(np.hypot(*disp))
            sig_o = (old.pose_sigma if old.pose_sigma is not None
                     else np.full(3, 0.05))
            sig_n = (kf.pose_sigma if kf.pose_sigma is not None
                     else np.full(3, 0.05))
            # covariance-consistency gate: the fitted drift is the
            # accumulated estimation error between the two keyframes, so
            # it must lie within what the filter's own pose sigmas allow —
            # a chance constellation alignment (dense blob fields produce
            # coincidental inlier sets) implies a "drift" far beyond
            # 3-sigma and is rejected here. The bounds carry the FIT's own
            # uncertainty as slack: the alignment angle is known only to
            # ~rms/spread rad (a genuine CPU-run edge with true heading
            # drift right at the 3-sigma line was rejected by a bound that
            # ignored this)
            spread = float(np.sqrt(((a_used - cen) ** 2).sum(1).mean()))
            ang_err = rms / max(spread, 0.1)
            xy_bound = (max(0.15, 3.0 * float(np.hypot(*sig_o[:2])
                                              + np.hypot(*sig_n[:2])))
                        + 3.0 * rms)
            th_bound = (max(0.15, 3.0 * float(sig_o[2] + sig_n[2]))
                        + 3.0 * ang_err)
            rec = dict(i=i, j=j, path=path, n_inliers=n_inl,
                       rms=round(rms, 4), dth=round(dth, 4),
                       disp=round(disp_n, 4),
                       xy_bound=round(xy_bound, 4),
                       th_bound=round(th_bound, 4),
                       const_sizes=(len(a_pts), len(b_pts)))
            if abs(dth) > 1.0 or disp_n > self.loop_max_drift:
                rec["accepted"], rec["reason"] = False, "implausible"
                self.edge_log.append(rec)
                continue
            if disp_n > xy_bound or abs(dth) > th_bound:
                rec["accepted"], rec["reason"] = False, "cov_gate"
                self.edge_log.append(rec)
                continue
            # undo the drift on the new pose: p_true = D^-1(p_est)
            px = kf.pose[0] - t[0]
            py = kf.pose[1] - t[1]
            corrected = np.array([c * px + s * py, -s * px + c * py,
                                  kf.pose[2] - dth])
            rel = _relpose_np(old.pose0, corrected)
            sig_xy = max(rms, 0.01)
            cand = dict(i=i, j=j, dth=dth, t=np.asarray(t), disp=disp,
                        cen=cen, rel=rel, sig=(sig_xy, max(rms, 0.005)),
                        rec=rec)
            rec["rel"] = [round(float(v), 4) for v in rel]
            confirm = self._confirm(cand)
            if confirm is None:
                rec["accepted"], rec["reason"] = False, "unconfirmed"
                self._pending.append(cand)
                self.edge_log.append(rec)
                last_hit = i
                continue
            # commit the confirming earlier sightings too — each one is a
            # second genuine constraint for the graph (it passed the same
            # gates; its log entry is updated in place)
            for cc in confirm + [cand]:
                cc["rec"]["accepted"] = True
                cc["rec"].pop("reason", None)
                if cc is not cand:
                    cc["rec"]["confirmed_by"] = (i, j)
                self.loop_edges.append(
                    (cc["i"], cc["j"], cc["rel"], cc["sig"]))
                self._validated[cc["i"]] = max(
                    self._validated.get(cc["i"], 0), j)
            self.edge_log.append(rec)
            last_hit = i

    def summary(self, refinements: Optional[List[dict]] = None) -> dict:
        """Aggregate backend telemetry: loop-edge diagnoses and (when the
        session's ``refinements`` list is passed) window-BA statistics.
        The bench records this verbatim so a regressed refined ATE can be
        explained from the artifact alone."""
        out = dict(
            keyframes=len(self.keyframes),
            loop_edges=len(self.loop_edges),
            edge_candidates=len(self.edge_log),
            edges=[e for e in self.edge_log if e.get("accepted")],
            rejected={r: sum(1 for e in self.edge_log
                             if e.get("reason") == r)
                      for r in ("implausible", "cov_gate", "unconfirmed")},
        )
        if refinements is not None:
            solves = [r for r in refinements if "max_z" in r]
            applied = [r for r in solves if r.get("applied")]
            graphs = [r for r in refinements if "n_loop_edges" in r]
            out.update(
                ba_solves=len(solves), ba_applied=len(applied),
                ba_max_z=max((r["max_z"] for r in solves), default=0.0),
                ba_max_corr=max((r.get("max_corr", 0.0) for r in applied),
                                default=0.0),
                ba_rmse_last=(solves[-1]["rmse_after"] if solves else None),
                graph_solves=len(graphs))
        return out

    # -- solvers ------------------------------------------------------------

    def window_problem(self) -> Optional[BAProblem]:
        """Assemble the last ba_window keyframes into one static problem."""
        W = self.cfg.ba_window
        kfs = self.keyframes[-W:]
        if len(kfs) < 2:
            return None
        L = self.max_lms
        dtype = np.float64 if self.cfg.dtype == "float64" else np.float32

        # union of landmark ids (most-observed first)
        all_ids, counts = np.unique(
            np.concatenate([k.lids for k in kfs]), return_counts=True)
        order = np.argsort(-counts)
        ids = all_ids[order][:L]
        id_to_col = {int(l): c for c, l in enumerate(ids)}

        poses = np.zeros((W, 3), dtype)
        obs = np.zeros((W, L, 2), dtype)
        mask = np.zeros((W, L), bool)
        lms = np.zeros((L, 3), dtype)
        kf_mask = np.zeros(W, bool)
        odo_rel = np.zeros((W - 1, 3), dtype)
        prior_poses = np.zeros((W, 3), dtype)
        prior_iw = np.zeros((W, 3), dtype)
        infl = self.cfg.ba_pose_prior_inflation
        for w, kf in enumerate(kfs):
            poses[w] = kf.pose
            kf_mask[w] = True
            prior_poses[w] = kf.pose0
            sig = (kf.pose_sigma if kf.pose_sigma is not None
                   else np.full(3, 0.05))
            prior_iw[w] = 1.0 / np.maximum(infl * sig, 1e-4) ** 2
            for lid, px, xyz in zip(kf.lids, kf.pixels, kf.xyz):
                c = id_to_col.get(int(lid))
                if c is None:
                    continue
                obs[w, c] = px
                mask[w, c] = True
                lms[c] = xyz                 # latest estimate wins
            if w > 0:
                odo_rel[w - 1] = _relpose_np(kfs[w - 1].odo, kfs[w].odo)
        lm_mask = mask.any(axis=0) & (np.asarray(
            [np.count_nonzero(mask[:, c]) for c in range(L)]) >= 2)
        dev = self._to_device
        return BAProblem(
            poses=dev(poses), landmarks=dev(lms),
            obs=dev(obs), obs_mask=dev(mask),
            odo_rel=dev(odo_rel), kf_mask=dev(kf_mask),
            lm_mask=dev(lm_mask),
            prior_poses=dev(prior_poses),
            prior_iw=dev(prior_iw))

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def refine_window(self):
        """Run BA on the current window. Returns dict or None.

        Corrections are committed only when BA genuinely disagrees with
        the filter — max pose correction above ``ba_apply_gate`` filter
        sigmas. Below the gate the window solution is statistically
        indistinguishable from the filter's (which fused strictly more
        frames), so committing it would only re-add pixel noise."""
        prob = self.window_problem()
        if prob is None:
            return None
        before = reprojection_rmse(prob.poses, prob.landmarks, prob,
                                   self.cfg)
        poses, lms, costs = ba_solve(prob, self.cfg)
        after = reprojection_rmse(poses, lms, prob, self.cfg)
        # one fetch for the whole solve
        W, L = poses.shape[0], lms.shape[0]
        flat = torch.cat([poses.reshape(-1), lms.reshape(-1), costs,
                          before[None], after[None]]).cpu().numpy()
        poses = flat[:3 * W].reshape(W, 3)
        lms = flat[3 * W:3 * (W + L)].reshape(L, 3)
        costs = flat[3 * (W + L):-2]
        before, after = float(flat[-2]), float(flat[-1])
        kfs = self.keyframes[-self.cfg.ba_window:]
        corr = poses[: len(kfs)] - np.stack([k.pose for k in kfs])
        corr[:, 2] = np.arctan2(np.sin(corr[:, 2]), np.cos(corr[:, 2]))
        sig = np.stack([k.pose_sigma if k.pose_sigma is not None
                        else np.full(3, 0.05) for k in kfs])
        z = float(np.max(np.abs(corr) / np.maximum(sig, 1e-4)))
        # sanity bound: a solver failure (ill-conditioned window, divergent
        # GN) produces corrections far beyond any physical drift — never
        # commit those
        sane = (np.all(np.isfinite(poses))
                and float(np.abs(corr[:, :2]).max()) < 2.0)
        applied = bool(sane and z > self.cfg.ba_apply_gate)
        if applied:
            for w, kf in enumerate(kfs):
                kf.pose = poses[w]
        return dict(poses=poses, landmarks=lms,
                    rmse_before=before, rmse_after=after,
                    costs=costs, applied=applied, max_z=z,
                    max_corr=float(np.abs(corr[:, :2]).max()),
                    frames=[k.frame for k in kfs])

    def graph(self) -> Optional[PoseGraph]:
        n = len(self.keyframes)
        if n < 2:
            return None
        N = self.max_nodes
        dtype = np.float64 if self.cfg.dtype == "float64" else np.float32
        nodes = np.zeros((N, 3), dtype)
        node_mask = np.zeros(N, bool)
        for i, kf in enumerate(self.keyframes):
            nodes[i] = kf.pose
            node_mask[i] = True
        E = N + len(self.loop_edges)
        eij = np.zeros((E, 2), np.int32)
        erel = np.zeros((E, 3), dtype)
        ew = np.zeros((E, 3), dtype)
        emask = np.zeros(E, bool)
        k = 0
        for i in range(n - 1):
            a, b = self.keyframes[i], self.keyframes[i + 1]
            eij[k] = (i, i + 1)
            # consecutive edges: the FILTER's relative motion (immutable
            # pose_filter), not raw odometry — the filter is the best
            # local dead-reckoner, and its sigma growth between the
            # keyframes bounds the edge's uncertainty (drift accumulates
            # slowly; the floor keeps a converged filter's edges from
            # becoming hard constraints)
            erel[k] = _relpose_np(a.pose_filter, b.pose_filter)
            if a.pose_sigma is not None and b.pose_sigma is not None:
                ds = np.abs(b.pose_sigma - a.pose_sigma)
            else:
                ds = np.zeros(3)
            sig = np.maximum(ds, (0.005, 0.005, 0.0025))
            ew[k] = 1.0 / sig ** 2
            emask[k] = True
            k += 1
        for (i, j, rel, w) in self.loop_edges:
            if k >= E or j >= n:
                break
            sig_xy, sig_th = w if isinstance(w, tuple) else (0.02, 0.01)
            eij[k] = (i, j)
            erel[k] = rel
            ew[k] = (1.0 / sig_xy ** 2, 1.0 / sig_xy ** 2,
                     1.0 / sig_th ** 2)
            emask[k] = True
            k += 1
        dev = self._to_device
        return PoseGraph(
            nodes=dev(nodes), edges_ij=dev(eij),
            edges_rel=dev(erel), edges_w=dev(ew),
            edge_mask=dev(emask), node_mask=dev(node_mask))

    def optimize_graph(self, iters: int = 10):
        g = self.graph()
        if g is None:
            return None
        nodes, costs = pose_graph_solve(g, iters=iters)
        flat = torch.cat([nodes.reshape(-1), costs]).cpu().numpy()
        nodes = flat[:nodes.numel()].reshape(-1, 3)
        costs = flat[nodes.size:]
        n = len(self.keyframes)
        moved = np.abs(nodes[:n, :2]
                       - np.stack([k.pose[:2] for k in self.keyframes]))
        # solver-failure guard (cf refine_window): keep the filter poses
        # rather than commit a divergent relaxation
        if np.all(np.isfinite(nodes[:n])) and float(moved.max()) < 5.0:
            for i, kf in enumerate(self.keyframes):
                self._rebase(kf, nodes[i])
            # pending sightings were measured against PRE-rebase landmark
            # estimates; the relaxation changed the drift they would see
            self._pending.clear()
        return dict(nodes=nodes[:n], costs=costs,
                    n_loop_edges=len(self.loop_edges))

    @staticmethod
    def _rebase(kf: Keyframe, new_pose: np.ndarray) -> None:
        """Commit a graph correction to a keyframe AND rebase its evidence.

        Every piece of window-BA evidence attached to the keyframe (the
        prior anchor ``pose0``, the landmark xyz estimates) lives in the
        pre-correction drifted frame; committing only ``pose`` would make
        the next ``refine_window`` pull the keyframe straight back to the
        drifted solution (its prior + landmarks still encode it). The
        rigid correction D = T_new ∘ T_old⁻¹ is therefore applied to the
        anchor and to both landmark sets as well."""
        old = np.asarray(kf.pose, dtype=np.float64)
        dth = float(np.arctan2(np.sin(new_pose[2] - old[2]),
                               np.cos(new_pose[2] - old[2])))
        c, s = np.cos(dth), np.sin(dth)

        def apply_xy(xy):
            rel = xy - old[:2]
            return new_pose[:2] + np.stack(
                [c * rel[..., 0] - s * rel[..., 1],
                 s * rel[..., 0] + c * rel[..., 1]], axis=-1)

        p0 = np.asarray(kf.pose0, dtype=np.float64)
        kf.pose0 = np.concatenate([apply_xy(p0[:2][None])[0],
                                   [p0[2] + dth]])
        for arr in (kf.xyz, kf.map_xyz):
            if arr is not None and len(arr):
                arr[:, :2] = apply_xy(arr[:, :2])
        kf.pose = np.asarray(new_pose, dtype=np.float64).copy()
