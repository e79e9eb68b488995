#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py            # the smoke (one card)
    python3 chip_smoke.py --profile  # the smoke, then a profiled chunk

Phases, each of which raises on a failed check (the script then exits
non-zero and prints no result):

1. the card: name and power limit (``nvidia-smi``), torch/CUDA versions;
2. build: ``nvcc`` compiles ``cv_monoslam_tpu_torch/ops/csrc/vision_kernels.cu``
   for sm_90a into ``.cache/torch_ext/`` (seconds printed);
3. kernel vs plain version on the card, for both kernels at M = 32, 37
   and 576 on seeded random inputs (integer-valued regions like uint8
   frames, a flat window, a flat template, a planted exact match), max
   |diff| <= 1e-4. The NCC kernel normalizes the template itself and also
   returns it, so it is held to three limits: (a) its templates against
   the plain normalization, <= 1e-6; (b) its scores against the plain
   score arithmetic on its own templates, <= 2e-5; (c) its scores against
   the plain version end to end, <= 1e-4; also for one non-default shape
   (pm = 9, w1 = 13), which takes the kernel's run-time bounds. Then the launch floor (a kernel
   that does nothing, bare and after the warp's ``torch.empty``) and each
   kernel's time (CUDA events, median over 60 launches on perturbed
   inputs): wrapper, kernel only into preallocated outputs, host enqueue
   time, plain version, bound;
4. the slice: ``SlamSession`` on the frozen ``bench1_arc`` fixture at the
   config-1 settings, float32, ``run(chunk=32)`` over all 104 frames,
   timed after a warm-up chunk; checks the launch counters (each kernel
   once per tracked frame, and the plain template normalization never
   called), the repair counters, ATE and matches, and holds both kernels
   against their plain versions on frames captured from the run;
5. one ``{"kernels": [...]}`` line, and as the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import Tuple

import numpy as np
import torch

TOL = 1e-4          # max |kernel - plain| for both kernels (values <= 255)
TOL_PHAT = 1e-6     # NCC (a): kernel's templates vs plain normalization
TOL_CORE = 2e-5     # NCC (b): kernel's scores vs plain scores on its p_hat
N_TIMED = 60        # timed launches per measurement (median reported)
PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
PEAK_FP32 = 67e12      # H100 SXM FP32 outside the tensor cores, FLOP/s
SM_CLOCK_HZ = 1.98e9   # H100 SXM boost clock: converts a sleep to cycles
PM, W1, PI = 17, 21, 21   # match patch, NCC offsets, init patch (defaults)
RG = W1 + PM - 1


def log(*a):
    print(*a, flush=True)


def card_info() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    return dict(smi=line, kind=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count())


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def ncc_inputs(m: int, rng: np.random.Generator, dev, pm: int = PM,
               w1: int = W1):
    rg = w1 + pm - 1
    regions = rng.integers(0, 256, (m, rg, rg)).astype(np.float32)
    patches = rng.integers(0, 256, (m, pm, pm)).astype(np.float32)
    # planted exact copy of template 0 at offset (3, 4): NCC == 1 there
    regions[0, 3:3 + pm, 4:4 + pm] = patches[0]
    if m > 2:
        regions[1] = 7.0                      # flat windows -> scores 0
        patches[2] = 42.0                     # flat template -> scores 0
    return (torch.as_tensor(regions, device=dev),
            torch.as_tensor(patches, device=dev))


def warp_inputs(m: int, rng: np.random.Generator, dev):
    patches = rng.integers(0, 256, (m, PI, PI)).astype(np.float32)
    d = np.arange(-(PM // 2), PM // 2 + 1, dtype=np.float32)
    dv, du = np.meshgrid(d, d, indexing="ij")
    # near-identity affine warps as the matcher makes them, some scaled
    # out past the patch border (invalid samples -> 0)
    a = np.eye(2, dtype=np.float32)[None] + rng.normal(
        0, 0.15, (m, 2, 2)).astype(np.float32)
    a[::5] *= 1.4
    sv = PI // 2 + a[:, 0, 0, None, None] * dv + a[:, 0, 1, None, None] * du
    su = PI // 2 + a[:, 1, 0, None, None] * dv + a[:, 1, 1, None, None] * du
    # identity grid whose last row/column sits on the patch edge: those
    # samples have no +1 neighbour and must come out 0
    su[0], sv[0] = du + (PI - 1 - PM // 2), dv + (PI - 1 - PM // 2)
    return tuple(torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                 device=dev) for x in (patches, su, sv))


# ---------------------------------------------------------------------------
# bounds (least time the card could take for the same work)
# ---------------------------------------------------------------------------


def ncc_bound(m: int) -> dict:
    nbytes = 4 * m * (RG * RG + PM * PM + W1 * W1)
    # num: pm^2 multiply-adds per offset; window sum and sum of squares,
    # separably: column sums over the region rows, then row sums; template
    # mean/norm; the per-offset normalization
    flops = m * (2 * PM * PM * W1 * W1
                 + RG * RG
                 + 2 * (RG * W1 * (PM - 1) + W1 * W1 * (PM - 1))
                 + 4 * PM * PM + 6 * W1 * W1)
    return _bound(nbytes, flops)


def warp_bound(m: int) -> dict:
    n = m * PM * PM
    nbytes = 4 * (m * PI * PI + 3 * n)
    flops = 15 * n
    return _bound(nbytes, flops)


def _bound(nbytes: int, flops: int) -> dict:
    tb = nbytes / PEAK_BYTES * 1e3
    tf = flops / PEAK_FP32 * 1e3
    return dict(bytes=nbytes, flops=flops, bound_ms=max(tb, tf),
                bound_by="bytes" if tb >= tf else "operations")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, arg_sets) -> Tuple[float, float]:
    """Median device time of one call (CUDA events around each call),
    cycling through ``arg_sets`` so no two consecutive calls see the same
    inputs; and the host's time to enqueue one call (host clock over the
    timed calls, which return before the device runs them), both in ms.

    A kernel of a few microseconds finishes before the host has enqueued
    the next one, so events around it would time the host's enqueue gap.
    The timed calls are therefore queued behind a device-side sleep that
    outlasts their enqueue (1.5x the host time of the warm-up calls): the
    device then runs them back to back and each event pair holds device
    time only."""
    for args in arg_sets[:5]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for args in arg_sets[:5]:
        fn(*args)
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / 5
    backlog_s = min(1.5 * host_s * N_TIMED + 1e-3, 5.0)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(N_TIMED)]
    torch.cuda._sleep(int(backlog_s * SM_CLOCK_HZ))
    in_call = 0.0
    for i, (s, e) in enumerate(ev):
        args = arg_sets[i % len(arg_sets)]
        s.record()
        t0 = time.perf_counter()
        fn(*args)
        in_call += time.perf_counter() - t0
        e.record()
    torch.cuda.synchronize()
    return (statistics.median(s.elapsed_time(e) for s, e in ev),
            in_call / N_TIMED * 1e3)


def perturbed(base, rng, dev, n=N_TIMED):
    """n copies of ``base`` tensors with small fresh perturbations."""
    out = []
    for _ in range(n):
        out.append(tuple(
            b + torch.as_tensor(rng.normal(0, 0.01, b.shape).astype(
                np.float32), device=dev) for b in base))
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build() -> float:
    from cv_monoslam_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build()
    secs = time.perf_counter() - t0
    log(f"[build] {secs:.2f} s ({'built' if built else 'cached'}) -> "
        f"{_build.library_path()}")
    return secs


def check_ncc(regions, patches, label: str, errs: dict, *,
              pm: int = PM, w1: int = W1) -> torch.Tensor:
    """Hold one NCC launch to its three limits; returns the scores."""
    from cv_monoslam_tpu_torch.ops import vision

    got, p_hat = vision.ncc_score_map_with_templates(
        regions, patches, pm=pm, w1=w1)
    torch.cuda.synchronize()
    e_phat = float((p_hat - vision.normalized_templates(patches))
                   .abs().max())
    e_core = float((got - vision._ncc_core_ref(regions, p_hat, pm=pm,
                                                w1=w1)).abs().max())
    e_full = float((got - vision.ncc_score_map_ref(regions, patches, pm=pm,
                                                   w1=w1)).abs().max())
    p_sum = float(p_hat.double().sum(dim=(1, 2)).abs().max())
    log(f"[check] ncc  {label}: (a) max|p_hat-plain|={e_phat:.3e} "
        f"(b) max|kernel-plain on its p_hat|={e_core:.3e} "
        f"(c) max|kernel-plain|={e_full:.3e} max|sum p_hat|={p_sum:.2e}")
    for key, e in (("ncc_p_hat", e_phat), ("ncc_core", e_core),
                   ("ncc_score_map", e_full)):
        errs[key] = max(errs[key], e)
    if not (e_phat <= TOL_PHAT and e_core <= TOL_CORE and e_full <= TOL
            and bool(torch.isfinite(got).all())
            and bool(torch.isfinite(p_hat).all())):
        raise AssertionError(f"ncc kernel check failed: {label}")
    return got


def phase_kernel_checks(dev) -> dict:
    from cv_monoslam_tpu_torch.ops import vision

    rng = np.random.default_rng(0)
    errs = {"ncc_score_map": 0.0, "ncc_p_hat": 0.0, "ncc_core": 0.0,
            "warp_bilinear": 0.0}
    for m in (32, 37, 576):
        regions, patches = ncc_inputs(m, rng, dev)
        got = check_ncc(regions, patches, f"M={m}", errs)
        planted = float(got[0, 3, 4])
        flat = float(got[1:3].abs().max())
        public = vision.ncc_score_map(regions, patches, pm=PM, w1=W1)
        log(f"[check] ncc  M={m}: planted={planted:.6f} "
            f"flat max|s|={flat:.3e}")
        # a flat window's variance is a float32 roundoff residue: its
        # score is ~0, not exactly 0 (same bound as the JAX package's test)
        if not (planted >= 0.999 and flat <= 5e-3
                and bool((public == got).all())):
            raise AssertionError(f"ncc kernel check failed at M={m}")

        p, su, sv = warp_inputs(m, rng, dev)
        got = vision.warp_bilinear(p, su, sv)
        want = vision.warp_bilinear_ref(p, su, sv)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        errs["warp_bilinear"] = max(errs["warp_bilinear"], err)
        o = PI - PM
        ident = float((got[0, :-1, :-1] - p[0, o:-1, o:-1]).abs().max())
        edge = float(got[0, -1].abs().max() + got[0, :, -1].abs().max())
        invalid = int((got == 0).sum())
        log(f"[check] warp M={m}: max|kernel-plain|={err:.3e} "
            f"identity interior err={ident:.3e} edge={edge:.1f} "
            f"zero samples={invalid}")
        if not (err <= TOL and ident <= TOL and edge == 0.0):
            raise AssertionError(f"warp kernel check failed at M={m}")

    # a shape no configuration uses: the run-time bounds of the NCC kernel
    pm, w1, m = 9, 13, 37
    regions, patches = ncc_inputs(m, rng, dev, pm=pm, w1=w1)
    if vision.ncc_launch_plan(m, pm, w1)["compiled"]:
        raise AssertionError("non-default shape took the compiled shape")
    got = check_ncc(regions, patches, f"pm={pm} w1={w1} M={m}", errs,
                    pm=pm, w1=w1)
    if not float(got[0, 3, 4]) >= 0.999:
        raise AssertionError("ncc non-default shape: planted match lost")
    return errs


def phase_kernel_times(dev) -> dict:
    from cv_monoslam_tpu_torch.ops import vision
    import torch.nn.functional as F

    rng = np.random.default_rng(1)
    out = {"ncc_score_map": {}, "warp_bilinear": {}}

    # the launch floor: a kernel that does nothing through the same ctypes
    # path, bare and after allocating the warp's output at M = 576
    none = [()] * N_TIMED
    bare, bare_host = time_ms(lambda: vision.empty_launch(dev), none)

    def alloc_and_launch():
        torch.empty((576, PM, PM), dtype=torch.float32, device=dev)
        vision.empty_launch(dev)
    floor, floor_host = time_ms(alloc_and_launch, none)
    out["launch_floor_ms"] = floor
    out["bare_launch_ms"] = bare
    log(f"[time] launch_floor_ms: bare launch {bare:.4f} ms (host "
        f"{bare_host:.4f}), torch.empty + launch {floor:.4f} ms (host "
        f"{floor_host:.4f})")

    for m in (32, 576):
        base = ncc_inputs(m, rng, dev)
        sets = perturbed(base, rng, dev)
        k, host = time_ms(
            lambda r, p: vision.ncc_score_map(r, p, pm=PM, w1=W1), sets)
        pl, _ = time_ms(lambda r, p: vision.ncc_score_map_ref(
            r, p, pm=PM, w1=W1), sets)
        # kernel only: the launch into preallocated outputs
        pre = (torch.empty((m, W1, W1), dtype=torch.float32, device=dev),
               torch.empty((m, PM, PM), dtype=torch.float32, device=dev))
        only, _ = time_ms(
            lambda r, p: vision.ncc_score_map_with_templates(
                r, p, pm=PM, w1=W1, out=pre), sets)
        b = ncc_bound(m)
        out["ncc_score_map"][m] = dict(
            ms=k, host_ms=host, kernel_only_ms=only, plain_ms=pl,
            library_ms=None, **b)
        log(f"[time] ncc  M={m}: kernel {k:.4f} ms (host {host:.4f}), "
            f"kernel only {only:.4f} ms, plain {pl:.4f} ms, "
            f"bound {b['bound_ms'] * 1e3:.3f} us ({b['bound_by']}), "
            f"launch floor {floor:.4f} ms")

        base = warp_inputs(m, rng, dev)
        sets = perturbed(base, rng, dev)
        k, host = time_ms(vision.warp_bilinear, sets)
        pl, _ = time_ms(vision.warp_bilinear_ref, sets)

        # nearest library call: grid_sample, which zero-pads out-of-patch
        # taps instead of dropping the sample — not the same function
        def gs(p, su, sv):
            grid = torch.stack([su, sv], dim=-1) * (2.0 / (PI - 1)) - 1.0
            return F.grid_sample(p[:, None], grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)
        lib, _ = time_ms(gs, sets)
        b = warp_bound(m)
        out["warp_bilinear"][m] = dict(ms=k, host_ms=host, plain_ms=pl,
                                       library_ms=None, grid_sample_ms=lib,
                                       **b)
        log(f"[time] warp M={m}: kernel {k:.4f} ms (host {host:.4f}), "
            f"plain {pl:.4f} ms, "
            f"grid_sample (not the same function) {lib:.4f} ms, "
            f"bound {b['bound_ms'] * 1e3:.3f} us ({b['bound_by']}), "
            f"launch floor {floor:.4f} ms "
            f"(kernel / floor = {k / floor:.2f})")
    return out


def phase_slice(dev, errs: dict) -> dict:
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.frontend import matching
    from cv_monoslam_tpu_torch.io import fixtures
    from cv_monoslam_tpu_torch.ops import vision

    chunk = 32
    seq, track, gt_xy, _ = fixtures.load("bench1_arc")
    cfg = SlamConfig(max_landmarks=32, max_new_per_frame=8,
                     max_detections=48)

    # capture the kernels' real inputs on the first frames of the run
    captured = {"ncc": [], "warp": []}
    real_ncc, real_warp = matching.ncc_score_map, matching.warp_bilinear

    def cap_ncc(regions, patches, **kw):
        if len(captured["ncc"]) < 3:
            captured["ncc"].append((regions.clone(), patches.clone()))
        return real_ncc(regions, patches, **kw)

    def cap_warp(patches, su, sv):
        if len(captured["warp"]) < 3:
            captured["warp"].append((patches.clone(), su.clone(),
                                     sv.clone()))
        return real_warp(patches, su, sv)

    vision.ncc_score_map.launches = 0
    vision.warp_bilinear.launches = 0
    vision.normalized_templates.calls = 0
    matching.ncc_score_map, matching.warp_bilinear = cap_ncc, cap_warp
    try:
        sess = SlamSession(cfg, seq, track, device=dev)
        sess.step_chunk(chunk)                    # warm-up chunk
    finally:
        matching.ncc_score_map, matching.warp_bilinear = real_ncc, real_warp
    torch.cuda.synchronize()
    warm = (vision.ncc_score_map.launches, vision.warp_bilinear.launches)
    t0 = time.perf_counter()
    n0 = len(sess.records)
    sess.run(chunk=chunk)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"ncc_score_map": vision.ncc_score_map.launches,
                "warp_bilinear": vision.warp_bilinear.launches}
    timed_launches = {"ncc_score_map": launches["ncc_score_map"] - warm[0],
                      "warp_bilinear": launches["warp_bilinear"] - warm[1]}
    plain_normalizations = vision.normalized_templates.calls

    recs = sess.records
    n_timed = len(recs) - n0
    traj = sess.trajectory
    ate = sess.ate(gt_xy)
    ids64 = [int(track.frame_id[r.frame]) for r in recs[:64]]
    ate64 = float(np.sqrt(((traj[:64, :2] - gt_xy[ids64]) ** 2)
                          .sum(axis=1).mean()))
    nm = [r.n_matched for r in recs]
    res = dict(frames=len(recs), timed_frames=n_timed,
               fps=n_timed / dt, ate_m=ate, ate64_m=ate64,
               matched_min=min(nm), matched_mean=float(np.mean(nm)),
               peak_map=max(r.n_map for r in recs),
               repairs=recs[-1].n_repairs, escalations=recs[-1].n_escalations,
               skipped=recs[-1].n_skipped, launches=launches,
               timed_launches=timed_launches,
               plain_normalizations=plain_normalizations)
    log("[slice] " + json.dumps(res))

    # kernel vs plain on the captured real frames (not counted above)
    for regions, patches in captured["ncc"]:
        check_ncc(regions, patches, "on a fixture frame", errs)
    for patches, su, sv in captured["warp"]:
        e = float((vision.warp_bilinear(patches, su, sv)
                   - vision.warp_bilinear_ref(patches, su, sv))
                  .abs().max())
        errs["warp_bilinear"] = max(errs["warp_bilinear"], e)
        log(f"[check] warp on a fixture frame: max|kernel-plain|={e:.3e}")
        if not e <= TOL:
            raise AssertionError("warp kernel disagrees on a fixture frame")
    if len(captured["ncc"]) < 3 or len(captured["warp"]) < 3:
        raise AssertionError("no fixture frames captured")

    problems = []
    if not np.all(np.isfinite(traj)):
        problems.append("non-finite poses")
    for name, n in launches.items():
        if n != len(recs) or timed_launches[name] != n_timed:
            problems.append(f"{name} launched {n} times for {len(recs)} "
                            f"tracked frames ({timed_launches[name]} for "
                            f"the {n_timed} timed ones)")
    if plain_normalizations:
        problems.append(f"the plain template normalization ran "
                        f"{plain_normalizations} times on the CUDA path")
    if res["escalations"] or res["skipped"]:
        problems.append("escalated repairs or skipped updates")
    if not ate < 0.03:
        problems.append(f"ATE {ate} >= 0.03 m")
    if not res["matched_mean"] >= 4:
        problems.append(f"mean matches {res['matched_mean']} < 4")
    if problems:
        raise AssertionError("slice checks failed: " + "; ".join(problems))
    return res


def phase_profile(dev, chunk: int = 32) -> None:
    """Where a chunk's time goes: ``torch.profiler`` over one chunk of the
    config-1 slice after a warm-up chunk. Prints wall ms per frame, the
    device's busy share (union of device-side intervals over the wall time)
    and the device time per kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.io import fixtures

    seq, track, _, _ = fixtures.load("bench1_arc")
    sess = SlamSession(SlamConfig(max_landmarks=32, max_new_per_frame=8,
                                  max_detections=48), seq, track, device=dev)
    sess.step_chunk(chunk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = len(sess.step_chunk(chunk))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        k = by_name.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += b - a
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    log(f"[profile] {n} frames: {wall_us / n / 1e3:.3f} ms/frame wall, "
        f"{busy / n / 1e3:.3f} ms/frame device-busy "
        f"({100.0 * busy / wall_us:.1f}% busy), {len(spans) / n:.1f} device "
        f"ops/frame")
    for name, (cnt, us) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][1])[:15]:
        log(f"[profile]   {us / n:9.1f} us/frame  {cnt / n:6.1f}/frame  "
            f"{name[:90]}")
    if not spans:
        raise AssertionError("the profiler recorded no device activity")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="after the smoke, profile one chunk of the slice")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import cv_monoslam_tpu_torch  # noqa: F401  (fails outside the repo)

    dev = torch.device("cuda:0")
    info = card_info()
    log(f"[card] {info['kind']} x{info['count']}; nvidia-smi: {info['smi']}")
    log(f"[card] python {sys.version.split()[0]}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on: covariance math needs FP32")
    phase_build()
    errs = phase_kernel_checks(dev)
    times = phase_kernel_times(dev)
    sl = phase_slice(dev, errs)
    if args.profile:
        phase_profile(dev)

    meta = {
        "ncc_score_map": dict(
            source="cv_monoslam_tpu_torch/ops/csrc/vision_kernels.cu",
            replaces="cv_monoslam_tpu/ops/pallas_vision.py:92"),
        "warp_bilinear": dict(
            source="cv_monoslam_tpu_torch/ops/csrc/vision_kernels.cu",
            replaces="cv_monoslam_tpu/ops/pallas_vision.py:178"),
    }
    kernels = []
    for name, mt in meta.items():
        t32, t576 = times[name][32], times[name][576]
        k = dict(name=name, route="cuda", **mt,
                 launches=sl["launches"][name], max_abs_err=errs[name],
                 ms=t32["ms"], plain_ms=t32["plain_ms"],
                 bound_ms=t32["bound_ms"], bound_by=t32["bound_by"],
                 library_ms=None,
                 launch_floor_ms=times["launch_floor_ms"],
                 bare_launch_ms=times["bare_launch_ms"],
                 host_ms=t32["host_ms"],
                 ms_m576=t576["ms"], plain_ms_m576=t576["plain_ms"],
                 bound_ms_m576=t576["bound_ms"],
                 bound_by_m576=t576["bound_by"],
                 host_ms_m576=t576["host_ms"])
        if name == "ncc_score_map":
            k.update(max_abs_err_p_hat=errs["ncc_p_hat"],
                     max_abs_err_on_own_p_hat=errs["ncc_core"])
            k["kernel_only_ms"] = t32["kernel_only_ms"]
            k["kernel_only_ms_m576"] = t576["kernel_only_ms"]
        if "grid_sample_ms" in t32:
            k["grid_sample_ms"] = t32["grid_sample_ms"]
            k["grid_sample_ms_m576"] = t576["grid_sample_ms"]
        kernels.append(k)
    log(f"[slice] config 1, bench1_arc, float32: {sl['fps']:.2f} frames/s "
        f"over {sl['timed_frames']} frames; ATE {sl['ate_m']:.5f} m "
        f"(64 frames: {sl['ate64_m']:.5f} m)")
    log(info["smi"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": info["kind"],
                                           "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
