"""Whether what the timed path produced is right: the frames kept in the
window against the plain reference (``slambench/reference``), stepped in
the configuration's precision from the program's own state.

The filter amplifies roundoff, and the map's discrete decisions (a match,
a new corner, a deletion) part at knife edges, so no two runs follow one
another over a window, not even two of the same program on two routes.
Each kept sample (one dispatch: a chunk of the replay route, one step of
the live route) is therefore judged on its own: the reference takes the
program's state before the sample's first frame and that frame's image
and odometry rows from the benchmark, and steps the frame with plain torch
operations in the configuration's dtype on the same device, TF32 off,
taking the program's decisions only at knife edges. A chunk's later frames
are the program's carry inside one captured graph, whose state between
them the program does not show: the reference steps on from its own state
through the ``check.chained`` frames after the first, taking every match
decision, measured pixel and deletion of the program's there
(``forcing.Following.take_all``), so that it follows the program's map and
judges the filter's arithmetic and the state carried from frame to frame.
(The filter amplifies a difference in the last bit from frame to frame,
so a longer chain reads sound runs as far off as broken ones; see
PERF.md.) Each judged frame's outputs, and where the reference stepped
every frame of the sample the whole state after it, are compared with the
reference's:

* ``pose_gap``: on the first frame, the largest gap of a pose component
  (x, y, z in m, theta in rad), over that component's size where it is
  above 1 (theta grows by 2 pi a lap, and its rounding with it);
* ``cov_gap``: on the first frame, the largest gap of the pose's
  square-root covariance (``pose_sqrt_cov``), over the largest of the
  reference's;
* ``map_gap``: on the first frame, the largest gap of a landmark's
  position (``lm_xyz``, the map's part of x), over its size where above
  1, over the slots that hold the same landmark in both;
* ``chain_gap``, ``chain_map_gap``: the largest pose or pose-covariance
  gap, and the largest map gap, on the chained frames;
* ``x_gap``, ``S_gap`` (where every frame of the sample was stepped: the
  live route's one step): the largest gap of the whole state mean x over
  each entry's size where above 1, and of the whole square-root covariance
  S over the largest entry of the reference's;
* ``decisions_off``: on the first frame, matches, offsets, new corners and
  deletions in which the program parts from the reference where the
  reference's reading is no knife edge (``reference/forcing.py``), an
  exact comparison;
* ``frame_count``: frames the program's state counts after the sample
  against the frames it ran (the state is carried from frame to frame),
  an exact comparison.

Each number's limit is in ``limits/<cell>.json``, with the readings it was
set from.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: LandmarkTable / StoredTable fields the program keeps in float32 in
#: every dtype
_F32_FIELDS = ("init_patch", "match_patch")


def _as_reference(state, dtype):
    """The reference's FilterState from the program's (host) state: the
    same numbers, float fields in ``dtype``."""
    from slambench.reference.filter import state as rstate

    def conv(obj):
        out = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if (v.is_floating_point() and f.name not in _F32_FIELDS):
                v = v.to(dtype)
            out[f.name] = v.clone()
        return out

    lm = rstate.LandmarkTable(**conv(state.lm))
    stored = rstate.StoredTable(**conv(state.stored))
    top = {f.name: getattr(state, f.name).to(dtype) if getattr(
        state, f.name).is_floating_point() else getattr(state, f.name).clone()
        for f in dataclasses.fields(state) if f.name not in ("lm", "stored")}
    return rstate.FilterState(lm=lm, stored=stored, **top)


def _to(state, device):
    from slambench.reference.ops import control

    return control.tree_map(lambda t: t.to(device), state)


def new_corners(next_id: int, tele: dict, later) -> torch.Tensor | None:
    """The pixels of the corners the program integrated in a frame (its
    outputs ``tele``; the frame's new landmarks take ids from ``next_id``
    on), in the order of their ids, from a later state of the program (its
    landmark table, else its stored table); None when one of them is in
    neither."""
    lids = np.asarray(tele["lm_lid"]).astype(np.int64)
    act = np.asarray(tele["lm_active"]).astype(bool)
    new = np.sort(lids[act & (lids >= next_id)])
    pix = []
    for lid in new:
        where = (later.lm.lid == int(lid)) & later.lm.active
        if bool(where.any()):
            pix.append(later.lm.init_pixel[where][0])
            continue
        where = (later.stored.lid == int(lid)) & later.stored.valid
        if bool(where.any()):
            pix.append(later.stored.init_pixel[where][0])
            continue
        return None
    if not pix:
        return torch.zeros((0, 2), dtype=later.lm.init_pixel.dtype)
    return torch.stack(pix)


def _state_gaps(prog, ref) -> tuple:
    """``(x_gap, S_gap)`` of the program's state against the reference's:
    the largest gap of x over each entry's size where above 1, and of S
    over S's largest entry."""
    xr, Sr = ref.x.cpu().double(), ref.S.cpu().double()
    x_gap = torch.max(torch.abs(prog.x.double() - xr)
                      / torch.clamp(torch.abs(xr), min=1.0))
    S_gap = torch.max(torch.abs(prog.S.double() - Sr)) / torch.max(
        torch.abs(Sr))
    return float(x_gap), float(S_gap)


def _zeros() -> dict:
    return dict(match_flips=0, offset_ties=0, corner_sets=0, deletions=0)


def _frame_gaps(tele: dict, out: dict, lm) -> tuple:
    """``(pose, cov, map)`` gaps of one frame: the program's outputs
    ``tele`` against the reference's ``out`` and landmark table ``lm``
    after the frame. The map's is the largest gap of a landmark's position
    over its size where above 1 (m), over the slots that hold the same
    landmark in both."""
    pose_ref = out["pose"].cpu().double().numpy()
    pose_p = np.asarray(tele["pose"], np.float64)
    pose = float(np.max(np.abs(pose_p - pose_ref)
                        / np.maximum(np.abs(pose_ref), 1.0)))
    if not np.all(np.isfinite(pose_p)):
        pose = float("inf")
    cov_ref = out["pose_sqrt_cov"].cpu().double().numpy()
    cov_p = np.asarray(tele["pose_sqrt_cov"], np.float64)
    cov = float(np.max(np.abs(cov_p - cov_ref))
                / max(float(np.max(np.abs(cov_ref))), 1e-300))
    same = (np.asarray(tele["lm_active"]).astype(bool)
            & lm.active.cpu().numpy()
            & (np.asarray(tele["lm_lid"]).astype(np.int64)
               == lm.lid.cpu().numpy().astype(np.int64)))
    xyz_r = lm.xyz.cpu().double().numpy()[same]
    xyz_p = np.asarray(tele["lm_xyz"], np.float64).reshape(-1, 3)[same]
    gap = np.abs(xyz_p - xyz_r) / np.maximum(np.abs(xyz_r), 1.0)
    mapg = float(np.max(gap)) if gap.size else 0.0
    if not np.all(np.isfinite(xyz_p)):
        mapg = float("inf")
    return pose, cov, mapg


def judge_sample(sample, cfg_fields: dict, raw: np.ndarray, device,
                 chained: int) -> dict:
    """The reference's steps of one kept sample's first frame and of the
    ``chained`` frames after it (at most the sample's), and the numbers of
    that sample."""
    from slambench.reference.config import SlamConfig
    from slambench.reference.filter.srukf import slam_step
    from slambench.reference import forcing

    cfg = SlamConfig(**cfg_fields)
    dt = {"float32": torch.float32, "float64": torch.float64}[cfg.dtype]
    st = _to(_as_reference(sample.before, dt), device)
    M = cfg.max_landmarks
    inf = float("inf")
    n = min(len(sample.teles), 1 + chained)
    res = dict(taken=_zeros(), adopted=_zeros(), later_refused=_zeros(),
               frame_count=abs(int(sample.later.frame)
                               - int(sample.before.frame)
                               - len(sample.teles)), frames=[])
    lid_b, act_b = sample.before.lm.lid, sample.before.lm.active
    unknown = 0
    for j in range(n):
        tele = sample.teles[j]
        if tele is None:                   # the program recorded no frame
            res["frames"].append((inf, inf, inf))
            break
        lid_a = torch.as_tensor(np.asarray(tele["lm_lid"]).astype(np.int32))
        act_a = torch.as_tensor(np.asarray(tele["lm_active"]).astype(bool))
        fol = forcing.Following(
            lid_before=lid_b, active_before=act_b, lid_after=lid_a,
            active_after=act_a,
            matched_after=torch.as_tensor(
                np.asarray(tele["lm_matched"]).astype(bool)),
            match_px_after=torch.as_tensor(np.asarray(
                tele["lm_match_px"]).reshape(M, 2).astype(np.float64)).to(dt),
            new_corners=new_corners(int(st.next_id), tele, sample.later),
            take_all=j > 0)
        unknown += fol.new_corners is None
        k = sample.frame + j
        odo = torch.as_tensor(raw[k - 1:k + 1, 1:4], dtype=dt, device=device)
        img = torch.as_tensor(sample.images[j], device=device).to(dt)
        with torch.no_grad(), forcing.following(fol):
            st, out = slam_step(st, img, odo[0], odo[1], False, cfg,
                                allow_detect=sample.allow_detect)
        res["frames"].append(_frame_gaps(tele, out, st.lm))
        for key in fol.taken:
            res["taken"][key] += fol.taken[key]
            res["adopted"][key] += fol.adopted[key]
            if j > 0:
                res["later_refused"][key] += fol.refused[key]
        if j == 0:
            res["decisions_off"] = int(sum(fol.refused.values()))
        lid_b, act_b = lid_a, act_a
    first = res["frames"][0]
    res["pose_gap"], res["cov_gap"], res["map_gap"] = first
    res.setdefault("decisions_off", 0)
    if n > 1:
        res["chain_gap"] = max(max(g[:2]) for g in res["frames"][1:])
        res["chain_map_gap"] = max(g[2] for g in res["frames"][1:])
    if len(res["frames"]) == len(sample.teles):
        # the reference stepped every frame: the whole state after the last
        res["x_gap"], res["S_gap"] = _state_gaps(sample.later, st)
        if not all(np.isfinite(max(g)) for g in res["frames"]):
            res["x_gap"] = res["S_gap"] = inf
    lm = st.lm
    res["detail"] = dict(
        frame=sample.frame, judged=len(res["frames"]),
        of=len(sample.teles), detect=sample.allow_detect,
        repairs_program=int(np.asarray(sample.teles[n - 1]["repairs"])[0])
        - int(sample.before.n_repairs) if sample.teles[n - 1] is not None
        else None,
        repairs_reference=int(st.n_repairs) - int(sample.before.n_repairs),
        n_map=int(lm.active.sum()),
        n_matched=int((lm.matched & lm.active).sum()),
        new_corners_unknown=unknown)
    return res


def judge_start(start, image: np.ndarray, theta0: float, cfg_fields: dict,
                device) -> float:
    """The start by itself: the program's state after the session's
    ``initialize`` against the reference's ``initialize`` of the same
    first frame: the largest gap of x (over its size where above 1) and of
    S (over S's largest entry); infinite where the two maps differ."""
    from slambench.reference.config import SlamConfig
    from slambench.reference.filter.srukf import initialize
    from slambench.reference.filter.state import init_state

    cfg = SlamConfig(**cfg_fields)
    dt = {"float32": torch.float32, "float64": torch.float64}[cfg.dtype]
    with torch.no_grad():
        ref = initialize(init_state(cfg, theta0=theta0,
                                    max_stored=start.stored.valid.shape[0],
                                    device=device),
                         torch.as_tensor(image, device=device).to(dt), cfg)
    if not (torch.equal(ref.lm.active.cpu(), start.lm.active)
            and torch.equal(ref.lm.lid.cpu(), start.lm.lid)):
        return float("inf")
    return max(_state_gaps(start, ref))


NUMBERS = ("start_gap", "pose_gap", "cov_gap", "map_gap", "chain_gap",
           "chain_map_gap", "x_gap", "S_gap", "decisions_off", "frame_count")


def judge(samples, cfg_fields: dict, raw: np.ndarray, device,
          log=print, start=None, chained: int = 0) -> dict:
    """The numbers of a run: the start's gap (``start``: the program's
    state after ``initialize``, the first frame and heading), the largest
    of each number over the kept samples (each judged on its first frame
    and the ``chained`` frames after it), and what the reference took
    over in all."""
    per = [judge_sample(s, cfg_fields, raw, device, chained)
           for s in samples]
    for p in per:
        frames = " ".join(f"{a:.1e}/{b:.1e}/{c:.1e}" for a, b, c in
                          p["frames"])
        log(f"[sample] pose_gap {p['pose_gap']:.3e} cov_gap "
            f"{p['cov_gap']:.3e} map_gap {p['map_gap']:.3e} chain_gap "
            f"{p.get('chain_gap', float('nan')):.3e} chain_map_gap "
            f"{p.get('chain_map_gap', float('nan')):.3e} x_gap "
            f"{p.get('x_gap', float('nan')):.3e} S_gap "
            f"{p.get('S_gap', float('nan')):.3e} decisions_off "
            f"{p['decisions_off']} taken {p['taken']} adopted "
            f"{p['adopted']} later refused {p['later_refused']} "
            f"{p['detail']}")
        log(f"[frames] pose/cov/map gaps a frame: {frames}")
    out = {"samples": len(per),
           "frames": sum(len(p["frames"]) for p in per)}
    if start is not None:
        out["start_gap"] = judge_start(*start, cfg_fields, device)
    for name in NUMBERS:
        vals = [p[name] for p in per if name in p]
        if vals:
            out[name] = max(vals)
    for what in ("taken", "adopted"):
        out[what] = {k: sum(p[what][k] for p in per)
                     for k in (per[0][what] if per else {})}
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, [(name, value, limit)])``: every number at or under its
    limit, and at least one frame judged."""
    rows = [(name, numbers[name], limits[name]) for name in NUMBERS
            if name in numbers]
    ok = numbers.get("samples", 0) > 0 and all(
        np.isfinite(v) and v <= lim for _, v, lim in rows)
    rows.insert(0, ("samples", numbers.get("samples", 0), 1))
    return bool(ok), rows
