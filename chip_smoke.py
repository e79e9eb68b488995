#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py            # the smoke (one card)
    python3 chip_smoke.py --profile  # the smoke, then a profiled chunk
    python3 chip_smoke.py --profile --config 3   # ... of config 3
    python3 chip_smoke.py --profile --config 4   # ... of config 4

Phases, each of which raises on a failed check (the script then exits
non-zero and prints no result):

1. the card: name and power limit (``nvidia-smi``), torch/CUDA versions;
2. build: ``nvcc`` compiles ``cv_monoslam_tpu_torch/ops/csrc/vision_kernels.cu``
   for sm_90a into ``.cache/torch_ext/`` (seconds printed);
3. kernel vs plain version on the card, for both kernels at M = 16, 32, 37
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
5. config 3 at full width: ``sigma_mode="implicit"`` at M = 576 landmarks
   (state dimension 3460) on the frozen ``bench3_grid`` fixture, float32,
   host-gated detection, two warm-up chunks of 8 and 64 timed frames in
   chunks of 8 (the configuration ``bench.py`` calls config 3). Checks: 64
   frames, finite poses, peak matched >= 500, ATE < 0.03 m, no more
   escalated repairs or skipped updates than the JAX engine shows on the
   same frames in float32 on a CPU (``CONFIG3_JAX_CPU``), each kernel
   launched once per frame at M = 576, no plain template normalization,
   and both kernels against their plain versions on three captured frames;
6. the redirect branch: config 1 on the first 48 frames of ``bench1_arc``
   with a redirection forced at frame 24; map size, loop re-adds and stored
   records left on that frame must equal the JAX engine's
   (``REDIRECT_JAX_CPU``), and tracking must go on;
7. checkpoint on the card: a config-3 session is saved after three chunks,
   resumed on ``cuda``, and one more chunk from each must leave the two
   states equal bit for bit;
8. config 4 at full width: the keyframe backend on all 119 tracked frames
   of the frozen ``bench4_lap`` fixture (M = 16, a keyframe every 5 frames,
   BA window 4, float32; the configuration ``bench.py`` calls config 4).
   (a) One run with ``backend=TelemetryCapture()``, then ``replay`` of the
   captured stream at the shipped window-BA gate and at gate 3.0; (b) a
   fresh run with a live ``BackendSession``. Checks: 119 frames, finite
   poses and refined poses; (b) equals (a)'s shipped-gate replay exactly
   (keyframe frames, loop edges, every keyframe pose, the refined
   trajectory); >= 15 keyframes, >= 1 loop edge, refined ATE below filter
   ATE; no more escalated repairs or skipped updates than the JAX engine in
   float32 on a CPU (``CONFIG4_JAX_CPU``, printed beside the card's
   numbers, not gated on); each kernel once per tracked frame at M = 16 in
   each run; both kernels against their plain versions on three captured
   frames. Prints frames/s of both runs and the wall time of every
   ``refine_window`` / ``optimize_graph`` call;
9. the command line: ``python3 -m cv_monoslam_tpu_torch run`` as a
   subprocess with no ``--device`` (it must pick the card), with recorder,
   watchdog, backend and checkpoints on an 8-frame synthetic sequence, a
   second run resumed from its checkpoint, and ``info``; checks the exit
   codes, the files written and that ``info`` names the card;
10. one ``{"kernels": [...]}`` line, and as the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
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

#: config 3 of ``bench.py`` (``bench_large`` -> ``scripts/bench_large.py``)
CONFIG3 = dict(max_landmarks=576, max_new_per_frame=64, max_detections=768,
               update_mode="gram", qr_mode="gram", sigma_mode="implicit",
               gate_detection=False, min_dist=10.0, min_num=480,
               n_initial_raws=768, n_process_raws=768, min_step_xy=0.005)
CONFIG1 = dict(max_landmarks=32, max_new_per_frame=8, max_detections=48)
#: the JAX engine on the same 16 + 64 frames, float32 on a CPU
#: (``PYTHONPATH=. python tests/test_torch_implicit.py``)
CONFIG3_JAX_CPU = dict(escalations=0, skipped=0, repairs=59, peak_map=576,
                       peak_matched=515)
#: the JAX engine on the redirect phase's 48 frames, float32 and float64 on
#: a CPU alike (``PYTHONPATH=. python tests/test_torch_redirect.py``): map
#: size after the branch, landmarks back with is_loop, stored records left
REDIRECT_JAX_CPU = dict(n_map=5, n_loop=5, stored_valid=4)
#: config 4 of ``bench.py`` (``bench_backend``)
CONFIG4 = dict(max_landmarks=16, max_new_per_frame=4, max_detections=32,
               keyframe_every=5, ba_window=4)
#: the JAX engine on the same 119 frames, float32 on a CPU, captured and
#: replayed as ``bench_backend`` does
#: (``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_slice.py``).
#: Only ``escalations`` and ``skipped`` are limits; the loop gates are
#: knife edges of the filter's roundoff, so the rest is printed, not gated.
CONFIG4_JAX_CPU = dict(
    frames=119, repairs=70, escalations=0, skipped=0,
    ate_filter=0.3586413212610804, ate_window_gate3=0.13835291100066124,
    ate_refined=0.13835291100066124, keyframes=23,
    loop_edges=[[0, 20], [0, 21], [1, 22]])


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
    for m in (16, 32, 37, 576):
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

    for m in (16, 32, 576):
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


@contextlib.contextmanager
def captured_kernel_inputs(n: int = 3):
    """While active, the matcher's calls of both kernels keep a copy of
    their first ``n`` argument sets (the real regions, templates and warp
    coordinates of the run)."""
    from cv_monoslam_tpu_torch.frontend import matching

    captured = {"ncc": [], "warp": []}
    real_ncc, real_warp = matching.ncc_score_map, matching.warp_bilinear

    def cap_ncc(regions, patches, **kw):
        if len(captured["ncc"]) < n:
            captured["ncc"].append((regions.clone(), patches.clone()))
        return real_ncc(regions, patches, **kw)

    def cap_warp(patches, su, sv):
        if len(captured["warp"]) < n:
            captured["warp"].append((patches.clone(), su.clone(),
                                     sv.clone()))
        return real_warp(patches, su, sv)

    matching.ncc_score_map, matching.warp_bilinear = cap_ncc, cap_warp
    try:
        yield captured
    finally:
        matching.ncc_score_map, matching.warp_bilinear = real_ncc, real_warp


def check_captured(captured: dict, errs: dict, label: str, m: int) -> None:
    """Kernel vs plain on captured frames (launches not counted for the
    run that captured them: call this after reading the counters)."""
    from cv_monoslam_tpu_torch.ops import vision

    if len(captured["ncc"]) < 3 or len(captured["warp"]) < 3:
        raise AssertionError(f"no frames captured {label}")
    for regions, patches in captured["ncc"]:
        if regions.shape[0] != m:
            raise AssertionError(f"ncc ran at M={regions.shape[0]} {label}")
        check_ncc(regions, patches, label, errs)
    for patches, su, sv in captured["warp"]:
        if patches.shape[0] != m:
            raise AssertionError(f"warp ran at M={patches.shape[0]} {label}")
        e = float((vision.warp_bilinear(patches, su, sv)
                   - vision.warp_bilinear_ref(patches, su, sv))
                  .abs().max())
        errs["warp_bilinear"] = max(errs["warp_bilinear"], e)
        log(f"[check] warp {label}: max|kernel-plain|={e:.3e}")
        if not e <= TOL:
            raise AssertionError(f"warp kernel disagrees {label}")


def reset_counters() -> None:
    from cv_monoslam_tpu_torch.ops import vision

    vision.ncc_score_map.launches = 0
    vision.warp_bilinear.launches = 0
    vision.normalized_templates.calls = 0


def read_counters() -> dict:
    from cv_monoslam_tpu_torch.ops import vision

    return {"ncc_score_map": vision.ncc_score_map.launches,
            "warp_bilinear": vision.warp_bilinear.launches,
            "plain_normalizations": vision.normalized_templates.calls}


def launch_problems(counts: dict, expected: int, what: str) -> list:
    problems = [f"{name} launched {counts[name]} times for {expected} "
                f"tracked frames of {what}"
                for name in ("ncc_score_map", "warp_bilinear")
                if counts[name] != expected]
    if counts["plain_normalizations"]:
        problems.append(f"the plain template normalization ran "
                        f"{counts['plain_normalizations']} times on the "
                        f"CUDA path of {what}")
    return problems


def phase_slice(dev, errs: dict) -> dict:
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.io import fixtures

    chunk = 32
    seq, track, gt_xy, _ = fixtures.load("bench1_arc")
    cfg = SlamConfig(**CONFIG1)

    reset_counters()
    with captured_kernel_inputs() as captured:
        sess = SlamSession(cfg, seq, track, device=dev)
        sess.step_chunk(chunk)                    # warm-up chunk
    torch.cuda.synchronize()
    warm = read_counters()
    t0 = time.perf_counter()
    n0 = len(sess.records)
    sess.run(chunk=chunk)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counters()
    launches = {k: counts[k] for k in ("ncc_score_map", "warp_bilinear")}
    timed_launches = {k: launches[k] - warm[k] for k in launches}

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
               plain_normalizations=counts["plain_normalizations"])
    log("[slice] " + json.dumps(res))

    check_captured(captured, errs, "on a fixture frame", cfg.max_landmarks)

    problems = launch_problems(counts, len(recs), "config 1")
    if not np.all(np.isfinite(traj)):
        problems.append("non-finite poses")
    for name, n in timed_launches.items():
        if n != n_timed:
            problems.append(f"{name} launched {n} times in the {n_timed} "
                            f"timed frames")
    if res["escalations"] or res["skipped"]:
        problems.append("escalated repairs or skipped updates")
    if not ate < 0.03:
        problems.append(f"ATE {ate} >= 0.03 m")
    if not res["matched_mean"] >= 4:
        problems.append(f"mean matches {res['matched_mean']} < 4")
    if problems:
        raise AssertionError("slice checks failed: " + "; ".join(problems))
    return res


def config3_session(dev, chunk: int = 8):
    """A config-3 session warmed up as ``bench.py`` warms it: a detect chunk,
    then a chunk with the gate forced shut (so both variants have run), then
    the gate opened to the telemetry and set to the one-chunk-stale
    cadence."""
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.io import fixtures

    seq, track, gt_xy, _ = fixtures.load("bench3_grid", min_step_xy=0.005)
    cfg = SlamConfig(**CONFIG3)
    sess = SlamSession(cfg, seq, track, device=dev)
    sess.detect_host_gate = True
    sess.step_chunk(chunk)
    sess._last_matched = cfg.min_num
    sess.step_chunk(chunk)
    sess._last_matched = sess.records[-1].n_matched
    sess.detect_gate_margin = 0
    return sess, gt_xy


def phase_config3(dev, errs: dict) -> dict:
    chunk, n_timed = 8, 64
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t_setup = time.perf_counter()
    sess, gt_xy = config3_session(dev, chunk)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup
    n0 = len(sess.records)
    with captured_kernel_inputs() as captured:
        t0 = time.perf_counter()
        sess.run(n_frames=n_timed, chunk=chunk, drop_tail=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = read_counters()
    peak_bytes = torch.cuda.max_memory_allocated()

    recs = sess.records
    done = len(recs) - n0
    traj = sess.trajectory
    res = dict(
        landmarks=sess.cfg.max_landmarks, state_dim=sess.cfg.state_dim,
        frames=done, fps=done / dt, ms_per_frame=dt / max(done, 1) * 1e3,
        setup_s=setup_s, ate_m=sess.ate(gt_xy),
        peak_map=max(r.n_map for r in recs),
        peak_matched=max(r.n_matched for r in recs),
        repairs=recs[-1].n_repairs, escalations=recs[-1].n_escalations,
        skipped=recs[-1].n_skipped,
        max_memory_allocated=peak_bytes,
        chunks_with_detection=sum(sess.chunk_detect),
        chunks_without_detection=len(sess.chunk_detect)
        - sum(sess.chunk_detect),
        chunk_detect=sess.chunk_detect,
        stored_inserts=int(sess.state.stored.seq),
        launches={k: counts[k] for k in ("ncc_score_map", "warp_bilinear")},
        plain_normalizations=counts["plain_normalizations"],
        n_matched=[r.n_matched for r in recs],
        jax_cpu_float32=CONFIG3_JAX_CPU)
    log("[config3] " + json.dumps(res))
    log(f"[config3] M=576 D=3460 bench3_grid float32: {res['fps']:.2f} "
        f"frames/s, {res['ms_per_frame']:.2f} ms/frame over {done} frames; "
        f"peak map {res['peak_map']}, peak matched {res['peak_matched']}; "
        f"ATE {res['ate_m']:.5f} m; repairs {res['repairs']} minor / "
        f"{res['escalations']} escalated / {res['skipped']} skipped; "
        f"max_memory_allocated {peak_bytes / 2**20:.0f} MiB; chunks with / "
        f"without detection {res['chunks_with_detection']} / "
        f"{res['chunks_without_detection']}")

    check_captured(captured, errs, "on a config-3 frame",
                   sess.cfg.max_landmarks)

    problems = launch_problems(counts, len(recs), "config 3")
    if done != n_timed:
        problems.append(f"{done} timed frames, wanted {n_timed}")
    if not np.all(np.isfinite(traj)):
        problems.append("non-finite poses")
    if not res["peak_matched"] >= 500:
        problems.append(f"peak matched {res['peak_matched']} < 500")
    if not res["ate_m"] < 0.03:
        problems.append(f"ATE {res['ate_m']} >= 0.03 m")
    for key in ("escalations", "skipped"):
        if res[key] > CONFIG3_JAX_CPU[key]:
            problems.append(f"{key} {res[key]} > the JAX engine's "
                            f"{CONFIG3_JAX_CPU[key]}")
    if problems:
        raise AssertionError("config-3 checks failed: " + "; ".join(problems))
    return res


def phase_redirect(dev) -> dict:
    """Config 1 on the first 48 frames of bench1_arc with a redirection
    forced at frame 24 (no committed fixture holds one)."""
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.io import fixtures

    at, n_frames = 24, 48
    seq, track, _, _ = fixtures.load("bench1_arc")
    track.redirect[at] = True
    reset_counters()
    sess = SlamSession(SlamConfig(**CONFIG1), seq, track, device=dev)
    sess.run(n_frames=at - 1, chunk=8)
    rec = sess.step()
    got = dict(n_map=rec.n_map, n_loop=int(sess.state.lm.is_loop.sum()),
               stored_valid=int(sess.state.stored.valid.sum()))
    sess.run(n_frames=n_frames - at, chunk=8)
    torch.cuda.synchronize()
    counts = read_counters()
    recs = sess.records
    after = [r.n_matched for r in recs[at:]]
    res = dict(frames=len(recs), redirect_frame=rec.frame,
               redirected=[r.frame for r in recs if r.redirected],
               matched_mean_after=float(np.mean(after)), **got,
               expected=REDIRECT_JAX_CPU,
               launches={k: counts[k] for k in ("ncc_score_map",
                                                "warp_bilinear")})
    log("[redirect] " + json.dumps(res))
    # the redirect frame itself tracks nothing: no kernel runs on it
    problems = launch_problems(counts, n_frames - 1, "the redirect run")
    if len(recs) != n_frames or res["redirected"] != [at]:
        problems.append(f"redirected frames {res['redirected']} of "
                        f"{len(recs)}, wanted [{at}] of {n_frames}")
    for key, want in REDIRECT_JAX_CPU.items():
        if got[key] != want:
            problems.append(f"{key} {got[key]} on the card, {want} from the "
                            f"JAX engine on a CPU")
    if not res["matched_mean_after"] >= 4:
        problems.append(f"mean matches after the redirect "
                        f"{res['matched_mean_after']} < 4")
    if not np.all(np.isfinite(sess.trajectory)):
        problems.append("non-finite poses")
    if problems:
        raise AssertionError("redirect checks failed: " + "; ".join(problems))
    return res


def phase_checkpoint(dev) -> dict:
    """Save a config-3 session after three chunks, resume it on the card,
    run one more chunk from each: the states must be equal bit for bit."""
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.convert import state_to_arrays
    from cv_monoslam_tpu_torch.utils.checkpoint import save_checkpoint

    chunk = 8
    a, _ = config3_session(dev, chunk)
    a.step_chunk(chunk)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"ckpt_{a.counter:06d}.npz")
        t0 = time.perf_counter()
        save_checkpoint(path, a.state, a.counter, a.cfg)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        b = SlamSession.resume(path, a.images, a.track, device=dev)
        resume_s = time.perf_counter() - t0
    if b.state.S.device != a.state.S.device or b.counter != a.counter:
        raise AssertionError("resume: wrong device or counter")
    b.detect_host_gate = a.detect_host_gate
    b.detect_gate_margin = a.detect_gate_margin
    b._last_matched = a._last_matched
    a.step_chunk(chunk)
    b.step_chunk(chunk)
    sa, sb = state_to_arrays(a.state), state_to_arrays(b.state)
    unequal = [k for k in sa
               if not np.array_equal(sa[k], sb[k], equal_nan=True)]
    res = dict(counter=b.counter, file_mib=size / 2**20, save_s=save_s,
               resume_s=resume_s, leaves=len(sa), unequal=unequal,
               n_map=a.records[-1].n_map, n_matched=a.records[-1].n_matched)
    log("[checkpoint] " + json.dumps(res))
    if unequal or a.records[-1].pose.tolist() != b.records[-1].pose.tolist():
        raise AssertionError(f"resumed state differs in {unequal}")
    return res


def timed_solvers(backend) -> dict:
    """Wrap ``backend``'s two solver entry points so each call's wall time
    (host clock, the device synchronized at both ends) is kept."""
    times = {"refine_window": [], "optimize_graph": []}

    def wrap(name):
        real = getattr(backend, name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        setattr(backend, name, timed)

    for name in times:
        wrap(name)
    return times


def backends_differ(a, b) -> list:
    """Where two BackendSessions differ at all (exact comparison)."""
    diffs = []
    if [k.frame for k in a.keyframes] != [k.frame for k in b.keyframes]:
        return ["keyframe frames"]
    if [(i, j) for i, j, _, _ in a.loop_edges] != \
            [(i, j) for i, j, _, _ in b.loop_edges]:
        diffs.append("loop edges")
    elif any(not np.array_equal(ra, rb) or wa != wb
             for (_, _, ra, wa), (_, _, rb, wb)
             in zip(a.loop_edges, b.loop_edges)):
        diffs.append("loop edge measurements")
    for ka, kb in zip(a.keyframes, b.keyframes):
        for f in ("pose", "pose0", "pose_filter", "xyz", "map_xyz"):
            if not np.array_equal(getattr(ka, f), getattr(kb, f)):
                diffs.append(f"{f} of keyframe {ka.frame}")
    return diffs


def phase_config4(dev, errs: dict, smi: str) -> dict:
    """The keyframe backend at ``bench.py``'s config-4 width: capture +
    replay, then a live backend, which must equal the replay exactly."""
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.backend.replay import TelemetryCapture, replay
    from cv_monoslam_tpu_torch.backend.session import BackendSession
    from cv_monoslam_tpu_torch.io import fixtures

    chunk = 8
    seq, track, gt_xy, _ = fixtures.load("bench4_lap")
    cfg = SlamConfig(**CONFIG4)
    n_tracked = len(track) - 1

    def run(backend):
        reset_counters()
        sess = SlamSession(cfg, seq, track, backend=backend, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.run(chunk=chunk)
        torch.cuda.synchronize()
        return sess, time.perf_counter() - t0, read_counters()

    # (a) the filter with its telemetry captured, then the backend by replay
    cap = TelemetryCapture()
    with captured_kernel_inputs() as captured:
        sa, dt_a, counts_a = run(cap)
    t0 = time.perf_counter()
    be, refinements = replay(cap.calls, cfg, device=dev)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    be_g, refs_g = replay(cap.calls, cfg, ba_apply_gate=3.0, device=dev)
    ate_f = float(sa.ate(gt_xy))
    sa.backend, sa.refinements = be_g, refs_g
    ate_g = float(sa.ate(gt_xy, refined=True))
    sa.backend, sa.refinements = be, refinements
    ate_r = float(sa.ate(gt_xy, refined=True))

    # (b) a fresh run with the live backend
    live = BackendSession(cfg)                 # no device named: the card
    solver_ms = timed_solvers(live)
    sb, dt_b, counts_b = run(live)
    if live.device.type != "cuda":
        raise AssertionError(f"the live backend ran on {live.device}")

    recs = sb.records
    summary = live.summary(sb.refinements)
    res = dict(
        frames=len(recs), landmarks=cfg.max_landmarks,
        fps_capture=len(sa.records) / dt_a, fps_live=len(recs) / dt_b,
        replay_s=replay_s,
        ate_filter=ate_f, ate_window_gate3=ate_g, ate_refined=ate_r,
        ate_refined_live=float(sb.ate(gt_xy, refined=True)),
        improved=bool(ate_r < ate_f),
        repairs=recs[-1].n_repairs, escalations=recs[-1].n_escalations,
        skipped=recs[-1].n_skipped,
        matched_mean=float(np.mean([r.n_matched for r in recs])),
        keyframe_frames=[k.frame for k in live.keyframes],
        loop_edges=[[i, j] for i, j, _, _ in live.loop_edges],
        summary=summary,
        gate3_summary=be_g.summary(refs_g),
        solver_calls={k: len(v) for k, v in solver_ms.items()},
        solver_ms_mean={k: (float(np.mean(v)) if v else None)
                        for k, v in solver_ms.items()},
        solver_ms_median={k: (float(np.median(v)) if v else None)
                          for k, v in solver_ms.items()},
        solver_ms_first={k: (v[0] if v else None)
                         for k, v in solver_ms.items()},
        solver_ms_total=float(sum(sum(v) for v in solver_ms.values())),
        launches={k: counts_b[k] for k in ("ncc_score_map", "warp_bilinear")},
        launches_capture_run={k: counts_a[k] for k in ("ncc_score_map",
                                                       "warp_bilinear")},
        jax_cpu_float32=CONFIG4_JAX_CPU)
    log("[config4] " + json.dumps(res, default=str))
    log(f"[config4] M=16 bench4_lap float32 [{smi}]: filter + capture "
        f"{res['fps_capture']:.2f} frames/s, filter + live backend "
        f"{res['fps_live']:.2f} frames/s over {len(recs)} frames; "
        f"ate_filter {ate_f:.4f} m, ate_window_gate3 {ate_g:.4f} m, "
        f"ate_refined {ate_r:.4f} m (JAX engine, float32 on a CPU: "
        f"{CONFIG4_JAX_CPU['ate_filter']:.4f} / "
        f"{CONFIG4_JAX_CPU['ate_window_gate3']:.4f} / "
        f"{CONFIG4_JAX_CPU['ate_refined']:.4f} m); "
        f"{summary['keyframes']} keyframes, loop edges "
        f"{res['loop_edges']} (JAX CPU: {CONFIG4_JAX_CPU['keyframes']}, "
        f"{CONFIG4_JAX_CPU['loop_edges']})")
    for name, v in solver_ms.items():
        if v:
            log(f"[config4] {name} [{smi}]: {len(v)} calls, mean "
                f"{np.mean(v):.3f} ms, median {np.median(v):.3f} ms, first "
                f"{v[0]:.3f} ms, max {max(v):.3f} ms, total "
                f"{sum(v):.1f} ms")

    check_captured(captured, errs, "on a config-4 frame", cfg.max_landmarks)

    problems = (launch_problems(counts_a, n_tracked, "config 4, capture run")
                + launch_problems(counts_b, n_tracked, "config 4, live run"))
    if len(recs) != n_tracked or len(sa.records) != n_tracked:
        problems.append(f"{len(sa.records)} / {len(recs)} frames, wanted "
                        f"{n_tracked}")
    if not (np.all(np.isfinite(sb.trajectory))
            and np.all(np.isfinite(sb.trajectory_refined))
            and np.all(np.isfinite(sa.trajectory_refined))):
        problems.append("non-finite poses or refined poses")
    if not np.array_equal(sa.trajectory, sb.trajectory):
        problems.append("the two filter runs differ")
    problems += [f"live backend != replay: {d}"
                 for d in backends_differ(live, be)]
    if not np.array_equal(sa.trajectory_refined, sb.trajectory_refined):
        problems.append("live refined trajectory != replayed one")
    if len(sb.refinements) != len(refinements):
        problems.append("live and replayed runs solved a different number "
                        "of times")
    if summary["keyframes"] < 15:
        problems.append(f"{summary['keyframes']} keyframes < 15")
    if summary["loop_edges"] < 1:
        problems.append("no loop edge")
    if not ate_r < ate_f:
        problems.append(f"refined ATE {ate_r} not below filter ATE {ate_f}")
    for key in ("escalations", "skipped"):
        if res[key] > CONFIG4_JAX_CPU[key]:
            problems.append(f"{key} {res[key]} > the JAX engine's "
                            f"{CONFIG4_JAX_CPU[key]}")
    if problems:
        raise AssertionError("config-4 checks failed: " + "; ".join(problems))
    return res


def phase_cli(info: dict) -> dict:
    """The command line as a user calls it, in subprocesses: no ``--device``,
    so each must pick the card."""
    root = os.path.dirname(os.path.abspath(__file__))
    base = [sys.executable, "-m", "cv_monoslam_tpu_torch"]

    def call(args):
        t0 = time.perf_counter()
        out = subprocess.run(base + args, cwd=root, capture_output=True,
                             text=True, timeout=600)
        if out.returncode != 0:
            raise AssertionError(
                f"cli {args[0]} exited {out.returncode}: "
                f"{out.stderr[-1500:]}")
        return out.stdout, time.perf_counter() - t0

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "out")
        stdout, res["run_s"] = call(
            ["run", "--frames", "8", "--backend", "--record", "--watchdog",
             "--checkpoint", "--checkpoint-every", "4", "--chunk", "4",
             "--out", out_dir, "--set", "max_landmarks=16",
             "--set", "max_detections=32", "--set", "max_new_per_frame=8",
             "--set", "keyframe_every=2"])
        ckpt = os.path.join(out_dir, "ckpt", "ckpt_000005.npz")
        missing = [n for n in ("RobotPath.txt", "FeaturesInfo.txt",
                               "metrics.jsonl", "trajectory.npz",
                               "keyframes.npz")
                   if not os.path.exists(os.path.join(out_dir, n))]
        if not os.path.exists(ckpt):
            missing.append("ckpt/ckpt_000005.npz")
        poses = np.load(os.path.join(out_dir, "trajectory.npz"))["poses"]
        res["run_stdout"] = stdout.strip().splitlines()
        if (missing or "ATE" not in stdout or "backend:" not in stdout
                or poses.shape != (7, 4) or not np.isfinite(poses).all()):
            raise AssertionError(f"cli run: missing {missing}; output "
                                 f"{stdout[-800:]}")
        out2 = os.path.join(tmp, "out2")
        stdout, res["resume_s"] = call(
            ["run", "--frames", "8", "--resume", ckpt, "--out", out2])
        z = np.load(os.path.join(out2, "trajectory.npz"))
        if list(z["frames"]) != [5, 6, 7] or \
                not np.allclose(z["poses"], poses[4:], atol=1e-4):
            raise AssertionError("cli --resume did not continue the run")
    stdout, res["info_s"] = call(["info"])
    if info["kind"] not in stdout or "torch:" not in stdout:
        raise AssertionError(f"cli info does not name the card: {stdout[:300]}")
    log("[cli] " + json.dumps(res))
    return res


def phase_profile(dev, config: int) -> None:
    """Where a chunk's time goes: ``torch.profiler`` over one chunk after
    the warm-up (config 1: one 32-frame chunk of the slice; config 3: after
    the two warm-up chunks one 8-frame chunk with the detection gate forced
    shut, then one with it forced open; config 4: 16 frames with the live
    backend). Prints wall ms per frame, the device's busy
    share (union of device-side intervals over the wall time), the host's
    synchronizing calls per frame and the device time per kernel name."""
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.io import fixtures

    if config == 1:
        chunk = 32
        seq, track, _, _ = fixtures.load("bench1_arc")
        sess = SlamSession(SlamConfig(**CONFIG1), seq, track, device=dev)
        sess.step_chunk(chunk)
        profile_chunk(sess, chunk, "config 1")
    elif config == 4:
        # two chunks of 8 with the live backend after two warm-up chunks:
        # frames 17-32 hold three keyframes, so three window solves
        from cv_monoslam_tpu_torch.backend.session import BackendSession

        chunk = 8
        seq, track, _, _ = fixtures.load("bench4_lap")
        cfg = SlamConfig(**CONFIG4)
        sess = SlamSession(cfg, seq, track, device=dev,
                           backend=BackendSession(cfg, device=dev))
        sess.step_chunk(chunk)
        sess.step_chunk(chunk)
        n0 = len(sess.refinements)
        profile_chunk(sess, 2 * chunk, "config 4, live backend")
        log(f"[profile] config 4: {len(sess.refinements) - n0} backend "
            f"solves inside the profiled frames")
    else:
        chunk = 8
        sess, _ = config3_session(dev, chunk)
        sess._last_matched = sess.cfg.min_num     # a tracking chunk
        profile_chunk(sess, chunk, "config 3")
        sess._last_matched = 0                    # a detect chunk
        profile_chunk(sess, chunk, "config 3")
        sess._last_matched = sess.cfg.min_num
        sync_census(sess, chunk, "config 3")
        sess._last_matched = 0
        sync_census(sess, chunk, "config 3")


def sync_census(sess, chunk: int, label: str) -> None:
    """Which source lines make the host wait for the device, per frame: one
    chunk under ``torch.cuda.set_sync_debug_mode("warn")``, the warnings
    counted by the port's line that issued the call."""
    import collections
    import traceback
    import warnings

    where = collections.Counter()

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        mine = [f for f in traceback.extract_stack()
                if "cv_monoslam_tpu_torch" in f.filename]
        f = mine[-1] if mine else None
        where[f"{os.path.relpath(f.filename)}:{f.lineno} ({f.name})"
              if f else f"{filename}:{lineno}"] += 1

    real = warnings.showwarning
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            n = len(sess.step_chunk(chunk))
    finally:
        warnings.showwarning = real
        torch.cuda.set_sync_debug_mode("default")
    tag = f"[syncs] {label}, detect={sess.chunk_detect[-1]}"
    log(f"{tag}: {sum(where.values()) / n:.1f} synchronizing calls/frame "
        f"over {n} frames")
    for src, cnt in where.most_common(20):
        log(f"{tag}   {cnt / n:6.2f}/frame  {src}")


def profile_chunk(sess, chunk: int, label: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync_calls = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                  "cudaEventSynchronize")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = len(sess.step_chunk(chunk))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name, syncs = [], {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            syncs += e.name in sync_calls
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
    tag = f"[profile] {label}, detect={sess.chunk_detect[-1]}"
    log(f"{tag}: {n} frames: {wall_us / n / 1e3:.3f} ms/frame wall, "
        f"{busy / n / 1e3:.3f} ms/frame device-busy "
        f"({100.0 * busy / wall_us:.1f}% busy), {len(spans) / n:.1f} device "
        f"ops/frame, {syncs / n:.1f} synchronizing host calls/frame")
    for name, (cnt, us) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][1])[:15]:
        log(f"{tag}   {us / n:9.1f} us/frame  {cnt / n:6.1f}/frame  "
            f"{name[:90]}")
    if not spans:
        raise AssertionError("the profiler recorded no device activity")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="after the smoke, profile a chunk")
    ap.add_argument("--config", type=int, choices=(1, 3, 4), default=1,
                    help="the configuration --profile looks at")
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
    c3 = phase_config3(dev, errs)
    rd = phase_redirect(dev)
    phase_checkpoint(dev)
    c4 = phase_config4(dev, errs, info["smi"])
    phase_cli(info)
    if args.profile:
        phase_profile(dev, args.config)

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
        t16, t32, t576 = (times[name][m] for m in (16, 32, 576))
        k = dict(name=name, route="cuda", **mt,
                 launches=sl["launches"][name],
                 launches_config3=c3["launches"][name],
                 launches_redirect=rd["launches"][name],
                 launches_config4=c4["launches"][name],
                 max_abs_err=errs[name],
                 ms=t32["ms"], plain_ms=t32["plain_ms"],
                 bound_ms=t32["bound_ms"], bound_by=t32["bound_by"],
                 library_ms=None,
                 launch_floor_ms=times["launch_floor_ms"],
                 bare_launch_ms=times["bare_launch_ms"],
                 host_ms=t32["host_ms"],
                 ms_m576=t576["ms"], plain_ms_m576=t576["plain_ms"],
                 bound_ms_m576=t576["bound_ms"],
                 bound_by_m576=t576["bound_by"],
                 host_ms_m576=t576["host_ms"],
                 ms_m16=t16["ms"], plain_ms_m16=t16["plain_ms"],
                 bound_ms_m16=t16["bound_ms"], bound_by_m16=t16["bound_by"])
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
    log(f"[config3] M=576 D=3460, bench3_grid, float32: {c3['fps']:.2f} "
        f"frames/s over {c3['frames']} frames; ATE {c3['ate_m']:.5f} m; peak "
        f"matched {c3['peak_matched']}")
    log(f"[config4] M=16, bench4_lap, float32: {c4['fps_capture']:.2f} "
        f"frames/s with capture, {c4['fps_live']:.2f} with the live backend; "
        f"ATE filter {c4['ate_filter']:.4f} m -> refined "
        f"{c4['ate_refined']:.4f} m; {c4['summary']['keyframes']} keyframes, "
        f"{c4['summary']['loop_edges']} loop edges")
    log(info["smi"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": info["kind"],
                                           "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
