#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py            # the smoke (one card)
    python3 chip_smoke.py --profile  # the smoke, then a profiled chunk
    python3 chip_smoke.py --profile --config 3   # ... of config 3
    python3 chip_smoke.py --profile --config 4   # ... of config 4
    python3 chip_smoke.py --marks    # the build and the stage marks alone
    python3 chip_smoke.py --measure  # the build and phase 3d alone
    python3 chip_smoke.py --baseline DIR   # ... the recurrence and linalg
                                           # kernels timed against DIR's,
                                           # R3 with DIR's gmw_chol

Phases, each of which raises on a failed check (the script then exits
non-zero and prints no result):

1. the card: name and power limit (``nvidia-smi``), torch/CUDA versions;
2. build: ``nvcc`` compiles each source of ``cv_monoslam_tpu_torch/ops/csrc/``
   for sm_90a into ``.cache/torch_ext/``, one process each, all at once
   (seconds printed);
3. kernel vs plain version on the card, for the three kernels at M = 16,
   32, 37 and 576 on seeded random inputs (integer-valued regions like uint8
   frames, a flat window, a flat template, a planted exact match), max
   |diff| <= 1e-4. The NCC kernel normalizes the template itself and also
   returns it, so it is held to three limits: (a) its templates against
   the plain normalization, <= 1e-6; (b) its scores against the plain
   score arithmetic on its own templates, <= 2e-5; (c) its scores against
   the plain version end to end, <= 1e-4; also for one non-default shape
   (pm = 9, w1 = 13), which takes the kernel's run-time bounds. The fused
   kernel (warp + region copy + NCC, the one the matcher runs) on random
   640 x 480 frames with region origins at the four clamped corners, an
   identity warp, a warp that zeroes the last sample row and column, a
   large shear, inf and NaN warps (and at hp_match = 4, hp_init = 6, its
   run-time bounds): warped templates equal to the plain version's
   exactly, its templates <= 1e-6, its scores on them <= 2e-5, scores
   <= 1e-4, and against the chain of the two standalone kernels it
   replaces (max |diff| printed, expected 0, <= 2e-5). Then the launch
   floor (a kernel that does nothing, bare and after the warp's
   ``torch.empty``) and each kernel's time (CUDA events, median over 60
   launches on perturbed inputs): wrapper, kernel only into preallocated
   outputs, host enqueue time, plain version, bound; for the fused kernel
   also the chain it replaces (device and host time per call);
3b. chunk graphs: each full chunk of ``SlamSession.run`` / ``step_chunk``
   is one captured CUDA graph with the filter's gates as conditional nodes
   on the device. The two recurrence kernels (``store_slots``,
   ``gftt_greedy_nms``, ``csrc/scan_kernels.cu``) equal their plain
   versions exactly on seeded inputs that probe their designs' seams
   (:func:`seeded_scan_checks`) and on inputs captured from the eager runs
   below; their times (:func:`scan_times`) cycle through four distinct
   input sets and, with ``--baseline DIR``, run in turns with another
   checkout's kernels, beside the greedy pass's other route. Then
   for config 1 (chunk 32), config 3 (chunk 8, the detect and the tracking
   graph) and config 4's filter (chunk 8): (a) one window from one state
   through the graph and through an eager chunk (the private switch
   ``_graphs``): telemetry rows and final state compared, every discrete
   result equal, a float difference named; (b) ``_dispatch_chunk`` under
   ``torch.cuda.set_sync_debug_mode("error")``, and the synchronizing calls
   of a dispatch and of its finish counted (0 in the dispatch); (c) the
   launches of one replayed chunk (the fused kernel once per frame, the
   standalone ones never; every kernel counts its launches on the device);
   (e) capture seconds per graph, frames/s of ``run`` by both routes over
   the same windows from the same state (graph, eager, eager, graph), peak
   memory of each, and what the graph pool and the conditional bodies'
   pool hold after the captures. Phases 4-8 and 11 below run their chunks
   through the graphs too; their launch counts are read on the device,
   and the fused kernel's captured inputs are read from the graph's
   tensors after the first replay and after the last;
3c. step graphs and modes: (a) the two kernels of
   ``csrc/linalg_kernels.cu``, ``rank_rotate`` (the rotation sweep of
   ``chol_update`` / ``chol_downdate``) and ``gmw_chol`` (the modified
   Cholesky), equal to their plain versions exactly (NaN where NaN) on
   seeded inputs in float32 and float64 (n = 1, 2, 16, 100, 196, 580, k =
   1-3 and 5, downdates that lose positive definiteness, zero entries of
   U, a zero U; indefinite, zero and non-finite A; ``gmw_chol``'s grid
   route at n = 196 with its panel in shared memory and in the workspace,
   ``rank_rotate``'s wide kernel at n = 100 and 196; one set each at n =
   3460, and at n = 4100 / 3700 where the launchers take those routes
   themselves) and on arguments kept from (d)'s eager
   runs, ``gmw_chol``'s in-kernel floors equal to ``_gmw_floors`` on the
   card on every seeded set; their times (with ``--baseline DIR``, in
   turns with that checkout's) against the byte / operation bound, the
   latency bound (one thread running the step's dependent arithmetic
   n + k - 1 times, the wavefront's intervals, or n times), the plain
   version and the library (``cholesky_ex`` where no floor binds); (b) config 1 through ``step()``, 48 frames by the graph
   and the eager route from one state (a chunk replayed among the steps):
   every discrete result equal, no synchronizing call and one event wait
   in each step replay, the fused kernel once per frame, then frames/s of
   ``run(chunk=1)`` by both routes in turns; (c) phase 6's forced redirect
   through the redirect branch's step graph and through the eager step,
   both holding ``REDIRECT_JAX_CPU``; (d) each update / QR mode of
   :data:`MODES` on one config-1 window by the chunk graph and eagerly:
   every discrete result equal, no synchronizing call in the dispatch,
   each linalg kernel launched its count per matched slot times the
   matched slots (read on the device), capture seconds and pools; the
   ``gmw`` mode also at max_landmarks=64 (D = 388: the grid route, a
   cooperative launch captured in a conditional body);
3d. the full-sigma measurement prediction's two kernels
   (``vision.measure_project``, ``vision.measure_merge``,
   ``csrc/vision_kernels.cu``, around the plain version's two reductions)
   on config 1 on the benchmark's blob lap
   (``slambench/traffic/blob_lap.json``, rendered on the card): the kernel
   route against its plain version ``full_rows_ref`` on the sigma sets of
   160 tracked frames, float32 and float64: 0 sentinel flips and 0 pixels,
   visibilities, preds and sis not the plain version's bits; each kernel's
   time beside the launch floor (and the projection's bound), the kernel
   route's and the plain chain's; then chunk graphs of 32 through the plain
   chain and through the kernels: launches (each tracked frame, 0 on a
   forced redirect frame and on the plain route), synchronizing calls of a
   dispatch, device operations a frame, the ``measure`` stage's ms a frame
   and frames/s in turns (plain, kernel, kernel, plain). Phases 3b, 3c, 4,
   5 and 6 count their launches too (config 3: none);
4. the slice: ``SlamSession`` on the frozen ``bench1_arc`` fixture at the
   config-1 settings, float32, ``run(chunk=32)`` over all 104 frames,
   timed after a warm-up chunk; checks the launch counters (the fused
   kernel once per tracked frame, the two standalone kernels and the plain
   template normalization never), the repair counters, ATE and matches,
   and holds the fused kernel against its plain version and against the
   standalone chain (each standalone kernel against its plain version) on
   frames captured from the run;
5. config 3 at full width: ``sigma_mode="implicit"`` at M = 576 landmarks
   (state dimension 3460) on the frozen ``bench3_grid`` fixture, float32,
   host-gated detection, two warm-up chunks of 8 and 64 timed frames in
   chunks of 8 (the configuration ``bench.py`` calls config 3). Checks: 64
   frames, finite poses, peak matched >= 500, ATE < 0.03 m, no more
   escalated repairs or skipped updates than the JAX engine shows on the
   same frames in float32 on a CPU (``CONFIG3_JAX_CPU``), the fused kernel
   launched once per frame at M = 576 (the standalone ones never), no plain
   template normalization, and the kernels against their plain versions on
   three captured frames;
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
   numbers, not gated on); the fused kernel once per tracked frame at M =
   16 in each run; the kernels against their plain versions on three
   captured frames. Prints frames/s of both runs and the wall time of every
   ``refine_window`` / ``optimize_graph`` call. On the card a window solve
   is one replay of a CUDA graph captured at the backend's first solve
   (``backend/session.py``): (c) the captured stream replayed by the graph
   route and by the eager route (the private switch ``_graphs``): every
   refinement dict and the keyframe poses after every solve equal exactly
   (a differing float is named), one event wait per solve, staging +
   replay under ``torch.cuda.set_sync_debug_mode("error")`` after the
   capture; capture seconds, the backend pool's reserve and each route's
   ms per ``refine_window`` / ``optimize_graph`` call printed; (d) singular
   systems: ``ba_solve`` and ``pose_graph_solve`` undamped on a window with
   a filled but unobserved landmark slot and a graph with a node no edge
   touches give non-finite values without raising, and ``refine_window``
   / ``optimize_graph`` with their solvers made singular so report
   ``applied`` False and keep every keyframe pose (at gate 0, where the
   same window unwrapped applies);
9. the command line: ``python3 -m cv_monoslam_tpu_torch run`` as a
   subprocess with no ``--device`` (it must pick the card), with recorder,
   watchdog, backend and checkpoints on an 8-frame synthetic sequence, a
   second run resumed from its checkpoint, and ``info``; checks the exit
   codes, the files written and that ``info`` names the card;
10. the multi-device paths (``cv_monoslam_tpu_torch/parallel/``) at world
   size 1: an NCCL process group in this process and its mesh. On it,
   chunks of a session and frames of ``spmd.run_frames`` run as captured
   CUDA graphs with the collectives inside (the route the JAX package's
   ``jax.jit`` takes). (probe) an ``all_reduce``, a ``broadcast`` and an
   ``all_gather`` inside a ``control.if_`` body (depth 1 and 2), captured
   and replayed with the predicate true, false and true; (b) phase 5's
   config-3 run again with ``dist_chol_panel=64`` under ``set_mesh`` by the
   graph route (phase 5's checks, the fused kernel once per frame, the
   distributed factorizations and those not finite counted on the device),
   then one window through the graph and the eager route (every discrete
   result equal, a float difference named; the dispatch under
   ``set_sync_debug_mode("error")``), frames/s of both on the same windows,
   capture seconds and the pools' reserve; (a) that factorization alone on
   the joint matrix of an eager frame of (b) (n = 4612, padded to 4672,
   panel 64, float32), eagerly and as one captured graph (bit for bit; its
   replay with no synchronizing call), against ``cholesky_ex`` of the same
   matrix: backward error ``|R^T R - A| / |A|`` <= 1e-5 and <= 4x the
   library's, forward error against the float64 factor <= 4x the
   library's, wall and device-busy time of both routes beside
   ``cholesky_ex``'s; (c) ``ba_solve_sharded`` on the
   config-5 problem (W = 8, L = 32768, 4 iterations, float64; its
   iterations one captured graph under NCCL) against ``ba_solve``, poses
   and landmarks to 1e-9, and ``ba_solve`` captured as one graph against
   its eager route bit for bit; ms per iteration of all three;
   (d) the landmark-layout step on 8 frames of config 1 by the graph route
   (a second run with no synchronizing call) and the eager route, both bit
   for bit the single-device step, with the fused kernel launched by the
   sharded path once per frame;
   (e) the same 8 frames on four spawned ranks sharing the card through
   ``gloo`` (NCCL refuses two ranks on one card; ``gloo`` moves CUDA
   tensors through the host, so these ranks run eagerly), 8 slots and the
   fused kernel per rank, held against
   (d)'s single-process run: discrete fields equal, poses to 1e-5;
   (b64) a second witness to (b)'s ATE: the same frames through the
   distributed factorization in float64 by the graph route (plain vision
   versions: the kernels take float32), 64 finite frames, no synchronizing
   call in a dispatch, ATE and the count of factorizations not finite
   printed beside (b)'s, not gated; (f) the ``shard_sqrt`` step (every Gram
   over S's rows a per-rank row-block product summed across the mesh) on
   (d)'s 8 frames: at the one NCCL rank by both routes bit for bit the
   single-device step, both kernels once per frame; at (e)'s four ``gloo``
   ranks each frame's step
   from the single-device state that entered it within
   ``tests/test_torch_spmd.py``'s tolerances, the run through all frames
   with the single-device run's discrete results and the same state on
   every rank, the fused kernel launched on every rank;
11. the reference: the port on the card against the port's ``OracleSLAM``
   (the reference's serial math in NumPy, on the host), on the synthetic
   ``straight`` (18 frames) and ``arc`` (68 frames) sequences. (R1)
   reference-faithful mode (``tests/test_parity.py``'s settings, float64,
   plain vision versions: the kernels take float32; every step a replay
   of a step graph, the ``gmw_chol`` kernel in it): maps and match sets
   equal on the straight 3-frame and arc 2-frame prefixes, poses within
   1e-6, the first-update posterior x within 1e-10 and P within 1e-9; (R2)
   default mode in float32 with the fused kernel at M = 16 over 67 frames:
   ATE at most 1.2 x the oracle's + 0.002 m, it once per tracked frame,
   0 escalated repairs and 0 skipped updates; (R3) faithful mode over 50
   frames: identical match sets on at least 25, mean Jaccard at least 0.55,
   ``gmw_chol`` launched by the step graphs twice per matched slot the
   eager run of the same frames updates (when their match sets agree),
   frames/s by the step graphs and by the eager route (printed); with
   ``--baseline DIR`` the same 50 frames by step graphs four more times,
   DIR's ``gmw_chol`` and this tree's in turns, frames/s of each and
   their match sets equal to the first run's.
   Each value is printed beside the CPU's (``PARITY_CPU``);
12. one ``{"kernels": [...]}`` line, and as the last line
   ``{"ok": true, "device": {...}}``.

Phase 11 runs before phase 10, which opens the process group.
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

TOL = 1e-4          # max |kernel - plain| scores and warps (values <= 255)
TOL_PHAT = 1e-6     # NCC (a): kernel's templates vs plain normalization
TOL_CORE = 2e-5     # NCC (b): kernel's scores vs plain scores on its p_hat
N_TIMED = 60        # timed launches per measurement (median reported)
PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
PEAK_FP32 = 67e12      # H100 SXM FP32 outside the tensor cores, FLOP/s
SM_CLOCK_HZ = 1.98e9   # H100 SXM boost clock: converts a sleep to cycles
PM, W1, PI = 17, 21, 21   # match patch, NCC offsets, init patch (defaults)
RG = W1 + PM - 1
HP_MATCH, HP_INIT = PM // 2, W1 // 2
FRAME_H, FRAME_W = 480, 640   # the camera's frame (every configuration)
#: the vision kernels: the fused one the matcher runs, and the two
#: standalone ones, which the main path must no longer launch
KERNELS = ("warp_ncc_score_map", "ncc_score_map", "warp_bilinear")
#: the two recurrences of csrc/scan_kernels.cu
SCAN_KERNELS = ("store_slots", "gftt_greedy_nms")
#: the full-sigma measurement prediction's two kernels
#: (csrc/vision_kernels.cu): each once per tracked frame of a
#: sigma_mode="full" configuration, never on config 3
MEASURE_KERNELS = ("measure_project", "measure_merge")
#: phase 3d: the benchmark's blob lap (``slambench/traffic/blob_lap.json``)
#: at config 1, started at frame seed mod 105; the tracked frames whose
#: sigma sets are kept (a lap and a half)
MEASURE_SEED = 2147483659
MEASURE_SETS = 160
#: operations of one sigma point through the projection: state_to_world
#: 11, the rotation 15, camera2image 8, distort's set-up 14 and 8 Newton
#: steps of 20, the final scaling 11 (the six sines and cosines counted as
#: one each)
MEASURE_OPS_PER_POINT = 225

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
#: config 5 of ``bench.py``: the window-BA problem of
#: ``scripts/bench_scaling.py:64-104`` (float64)
CONFIG5 = dict(W=8, L=32768, iters=4)
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
#: the reference-faithful mode of ``tests/test_parity.py`` (float64)
FAITHFUL = dict(max_landmarks=16, dtype="float64", update_mode="sequential",
                rho_init_mode="flat", subpixel_match=False,
                qr_mode="householder", detect_zero_blocks=True,
                downdate_mode="gmw")
#: the port with ``device="cpu"`` beside the oracle on the same sequences
#: (``tests/test_torch_parity.py``'s cases): max |pose - oracle| over the
#: prefix windows, and the 50-frame match-set statistics
PARITY_CPU = dict(straight_dpose=3.6e-9, arc_dpose=8.7e-10, identical=36,
                  jaccard=0.720)


#: True in the ranks of ``--ranks`` other than rank 0, which print nothing
#: (their results go back to the parent, which checks them)
_QUIET = False


def log(*a):
    if not _QUIET:
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


def fused_inputs(m: int, rng: np.random.Generator, dev,
                 hp_init: int = HP_INIT, hp_match: int = HP_MATCH):
    """(frame, base, A, init patches) for the fused kernel: a random
    integer-valued frame, region origins clamped by the matcher's own
    ``region_origins`` from centres scattered past the frame's edges (the
    first four at its four corners), near-identity warps as the matcher
    makes them (every fifth scaled out past the border), and special warps
    at landmarks 4-8: identity (its template planted in its region at
    offset (3, 4)), hp_init / hp_match times identity (the last sample row
    and column on the patch edge: zeroed), a large shear and scale (samples
    outside the patch), and inf and NaN entries (a singular J10)."""
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.frontend.matching import region_origins

    pm, w1 = 2 * hp_match + 1, 2 * hp_init + 1
    image = rng.integers(0, 256, (FRAME_H, FRAME_W)).astype(np.float32)
    centers = np.stack([rng.integers(-40, FRAME_W + 40, m),
                        rng.integers(-40, FRAME_H + 40, m)], axis=1)
    centers[:4] = [[-50, -50], [FRAME_W + 50, -50], [-50, FRAME_H + 50],
                   [FRAME_W + 50, FRAME_H + 50]]
    base = region_origins(
        torch.as_tensor(centers, dtype=torch.int32), FRAME_H, FRAME_W,
        SlamConfig(hp_init=hp_init, hp_match=hp_match)).numpy()
    a = np.eye(2, dtype=np.float32)[None] + rng.normal(
        0, 0.15, (m, 2, 2)).astype(np.float32)
    a[::5] *= 1.4
    a[4] = np.eye(2)
    a[5] = (hp_init / hp_match) * np.eye(2)
    a[6] = [[2.0, 0.8], [-0.7, 1.9]]
    a[7] = [[np.inf, -np.inf], [-np.inf, np.inf]]
    a[8] = np.nan
    patches = rng.integers(0, 256, (m, w1, w1)).astype(np.float32)
    o = hp_init - hp_match
    bu, bv = base[4]
    image[bv + 3:bv + 3 + pm, bu + 4:bu + 4 + pm] = \
        patches[4, o:o + pm, o:o + pm]
    return tuple(torch.as_tensor(np.ascontiguousarray(x), device=dev)
                 for x in (image, base, a, patches))


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


def warp_ncc_bound(m: int) -> dict:
    """The fused kernel: bytes of the init patches, warps, origins, warped
    templates and scores, and the frame's region bytes read once; the NCC
    kernel's operations plus 15 per warped sample and 4 per coordinate."""
    n = m * PM * PM
    nbytes = (4 * (m * PI * PI + 4 * m + n + m * W1 * W1) + 4 * 2 * m
              + 4 * min(m * RG * RG, FRAME_H * FRAME_W))
    flops = ncc_bound(m)["flops"] + 15 * n + 4 * 2 * n
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
              pm: int = PM, w1: int = W1):
    """Hold one NCC launch to its three limits; returns the scores and the
    kernel's normalized templates."""
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
    return got, p_hat


def check_fused(args, label: str, errs: dict, *, hp_init: int = HP_INIT,
                hp_match: int = HP_MATCH):
    """Hold one fused launch against its plain version (warped templates
    exactly, its p_hat <= TOL_PHAT, its scores on its own p_hat <=
    TOL_CORE, scores <= TOL) and against the chain it replaces, the
    standalone warp kernel, ``gather_regions`` and the standalone NCC
    kernel, each of which is held to its own limits on the same inputs;
    max |fused - chain| <= TOL_CORE (expected 0: the same device
    functions). Returns the fused scores and warped templates."""
    from cv_monoslam_tpu_torch.ops import vision

    image, base, A, patches = args
    pm, w1 = 2 * hp_match + 1, 2 * hp_init + 1
    hp = dict(hp_init=hp_init, hp_match=hp_match)
    got, warped, p_hat = vision.warp_ncc_score_map_with_templates(*args, **hp)
    public = vision.warp_ncc_score_map(*args, **hp)
    want, want_w = vision.warp_ncc_score_map_ref(*args, **hp)
    regions = vision.gather_regions(image, base, w1 + pm - 1)
    su, sv = vision.warp_sample_coords(A, hp_init, hp_match)
    chain_w = vision.warp_bilinear(patches, su, sv)
    chain_s, chain_p = check_ncc(regions, chain_w, f"chain {label}", errs,
                                 pm=pm, w1=w1)
    torch.cuda.synchronize()
    e_chain_w = float((chain_w - vision.warp_bilinear_ref(patches, su, sv))
                      .abs().max())
    errs["warp_bilinear"] = max(errs["warp_bilinear"], e_chain_w)
    e_warp = float((warped - want_w).abs().max())
    e_phat = float((p_hat - vision.normalized_templates(want_w)).abs().max())
    e_core = float((got - vision._ncc_core_ref(regions, p_hat, pm=pm, w1=w1))
                   .abs().max())
    e_full = float((got - want).abs().max())
    d_chain = max(float((got - chain_s).abs().max()),
                  float((warped - chain_w).abs().max()),
                  float((p_hat - chain_p).abs().max()))
    log(f"[check] fused {label}: max|warped-plain|={e_warp:.3e} "
        f"max|p_hat-plain|={e_phat:.3e} max|scores-plain on its p_hat|="
        f"{e_core:.3e} max|scores-plain|={e_full:.3e} "
        f"max|fused-chain|={d_chain:.3e} (chain warp kernel vs plain "
        f"{e_chain_w:.3e})")
    for key, e in (("warp_ncc_score_map", e_full), ("warp_ncc_warped", e_warp),
                   ("warp_ncc_p_hat", e_phat), ("warp_ncc_core", e_core),
                   ("warp_ncc_chain", d_chain)):
        errs[key] = max(errs[key], e)
    if not (e_warp == 0.0 and e_phat <= TOL_PHAT and e_core <= TOL_CORE
            and e_full <= TOL and d_chain <= TOL_CORE and e_chain_w <= TOL
            and torch.equal(public[0], got)
            and torch.equal(public[1], warped)
            and bool(torch.isfinite(got).all())
            and bool(torch.isfinite(warped).all())):
        raise AssertionError(f"fused kernel check failed: {label}")
    return got, warped


def new_errs() -> dict:
    """The largest |kernel - plain| seen, by kernel and limit (the checks
    raise above their limits)."""
    return {"ncc_score_map": 0.0, "ncc_p_hat": 0.0, "ncc_core": 0.0,
            "warp_bilinear": 0.0, "warp_ncc_score_map": 0.0,
            "warp_ncc_warped": 0.0, "warp_ncc_p_hat": 0.0,
            "warp_ncc_core": 0.0, "warp_ncc_chain": 0.0,
            "store_slots": 0, "gftt_greedy_nms": 0}


def phase_kernel_checks(dev) -> dict:
    from cv_monoslam_tpu_torch.ops import vision

    rng = np.random.default_rng(0)
    errs = new_errs()
    for m in (16, 32, 37, 576):
        regions, patches = ncc_inputs(m, rng, dev)
        got, _ = check_ncc(regions, patches, f"M={m}", errs)
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
    got, _ = check_ncc(regions, patches, f"pm={pm} w1={w1} M={m}", errs,
                       pm=pm, w1=w1)
    if not float(got[0, 3, 4]) >= 0.999:
        raise AssertionError("ncc non-default shape: planted match lost")

    # the fused kernel at every M, then at a shape no configuration uses
    # (its run-time bounds)
    for m, hp_init, hp_match in ((16, HP_INIT, HP_MATCH),
                                 (32, HP_INIT, HP_MATCH),
                                 (37, HP_INIT, HP_MATCH),
                                 (576, HP_INIT, HP_MATCH), (37, 6, 4)):
        pm, w1 = 2 * hp_match + 1, 2 * hp_init + 1
        plan = vision.warp_ncc_launch_plan(m, pm, w1, w1)
        if plan["compiled"] != ((hp_init, hp_match) == (HP_INIT, HP_MATCH)):
            raise AssertionError(f"fused launch plan {plan} at pm={pm}")
        args = fused_inputs(m, rng, dev, hp_init, hp_match)
        label = f"M={m} hp_init={hp_init} hp_match={hp_match}"
        scores, warped = check_fused(args, label, errs, hp_init=hp_init,
                                     hp_match=hp_match)
        o = hp_init - hp_match
        ident = bool(torch.equal(warped[4], args[3][4, o:o + pm, o:o + pm]))
        edge = float(warped[5, -1].abs().max() + warped[5, :, -1].abs().max())
        outside = int((warped[6] == 0).sum())
        singular = float(warped[7:9].abs().max() + scores[7:9].abs().max())
        corners = args[1][:4].tolist()
        planted = float(scores[4, 3, 4])
        log(f"[check] fused {label}: identity warp exact={ident}, edge "
            f"row/column={edge:.1f}, shear: {outside}/{pm * pm} samples "
            f"outside, singular warps max|out|={singular:.1f}, corner "
            f"origins {corners}, planted={planted:.6f}")
        rg = w1 + pm - 1
        if not (ident and edge == 0.0 and outside > 0 and singular == 0.0
                and planted >= 0.999
                and corners == [[0, 0], [FRAME_W - rg, 0],
                                [0, FRAME_H - rg],
                                [FRAME_W - rg, FRAME_H - rg]]):
            raise AssertionError(f"fused kernel check failed: {label}")
    return errs


def phase_kernel_times(dev) -> dict:
    from cv_monoslam_tpu_torch.ops import vision
    import torch.nn.functional as F

    rng = np.random.default_rng(1)
    out = {"ncc_score_map": {}, "warp_bilinear": {}, "warp_ncc_score_map": {}}

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

        out["warp_ncc_score_map"][m] = fused_times(m, rng, dev, floor)
    return out


def fused_times(m: int, rng, dev, floor: float) -> dict:
    """The fused kernel at M landmarks beside the chain it replaces, as
    ``association_rows`` ran it before: ``warp_coords``' arithmetic, the
    warp wrapper, ``gather_regions`` and the NCC wrapper (device time and
    host time per call of each), on perturbed frames, warps and patches."""
    from cv_monoslam_tpu_torch.ops import vision

    hp = dict(hp_init=HP_INIT, hp_match=HP_MATCH)
    image, base, a, patches = fused_inputs(m, rng, dev)
    sets = [(image + torch.as_tensor(rng.normal(0, 0.01, image.shape)
                                     .astype(np.float32), device=dev),
             base, a + torch.as_tensor(rng.normal(0, 0.01, a.shape)
                                       .astype(np.float32), device=dev),
             patches + torch.as_tensor(rng.normal(0, 0.01, patches.shape)
                                       .astype(np.float32), device=dev))
            for _ in range(N_TIMED)]
    k, host = time_ms(lambda *x: vision.warp_ncc_score_map(*x, **hp), sets)
    pre = (torch.empty((m, W1, W1), dtype=torch.float32, device=dev),
           torch.empty((m, PM, PM), dtype=torch.float32, device=dev))
    only, _ = time_ms(lambda *x: vision.warp_ncc_score_map(*x, **hp,
                                                           out=pre), sets)
    # the same launches on 8 input sets cycled, which stay in the L2 cache:
    # how much of the kernel's time is its copies' trips to device memory
    only_l2, _ = time_ms(lambda *x: vision.warp_ncc_score_map(*x, **hp,
                                                              out=pre),
                         sets[:8])

    def chain(im, b, a, p):
        su, sv = vision.warp_sample_coords(a, HP_INIT, HP_MATCH)
        w = vision.warp_bilinear(p, su, sv)
        return vision.ncc_score_map(vision.gather_regions(im, b, RG), w,
                                    pm=PM, w1=W1), w
    ch, ch_host = time_ms(chain, sets)
    pl, _ = time_ms(lambda *x: vision.warp_ncc_score_map_ref(*x, **hp), sets)
    b = warp_ncc_bound(m)
    res = dict(ms=k, host_ms=host, kernel_only_ms=only,
               kernel_only_l2_ms=only_l2, chain_ms=ch,
               chain_host_ms=ch_host, plain_ms=pl, library_ms=None, **b)
    log(f"[time] fused M={m}: kernel only {only:.4f} ms (inputs in L2: "
        f"{only_l2:.4f} ms), wrapper {k:.4f} ms "
        f"(host {host:.4f}); the chain it replaces {ch:.4f} ms (host "
        f"{ch_host:.4f}); plain {pl:.4f} ms; bound "
        f"{b['bound_ms'] * 1e3:.3f} us ({b['bound_by']}); launch floor "
        f"{floor:.4f} ms (kernel / floor = {only / floor:.2f})")
    return res


class _Captured(list):
    """Argument sets of the fused kernel's calls (see
    :func:`captured_kernel_inputs`); ``arm()`` starts the collection."""

    def __init__(self, n: int, armed: bool):
        super().__init__()
        self.n, self.armed = n, armed
        self.nodes = {}          # graph key -> clones the graph makes

    def arm(self) -> None:
        self.armed = True

    def late(self) -> list:
        """Copies of the graphs' clones as they stand now: the argument sets
        of the last replay of every graph captured meanwhile (its last
        window's first ``n`` frames)."""
        return [(tuple(a.clone() for a in args), kw)
                for nodes in self.nodes.values() for args, kw in nodes]


@contextlib.contextmanager
def captured_kernel_inputs(n: int = 3, armed: bool = True):
    """While active (and armed), the matcher's calls of the fused kernel
    keep their first ``n`` argument sets (the real frame, region origins,
    warps and init patches of the run), as the eager route made them
    before the chunk graphs: an eager call's as copies. A graph captured
    meanwhile clones the arguments of its first ``n`` calls at that frame
    (nodes of the graph, so every replay overwrites them); right after a
    replay of that graph they are copied out once more, the values of that
    replay's frames, and ``late()`` copies them out after the last replay.
    A warm-up's calls (a blank window) are not kept. ``armed=False``:
    nothing is kept until ``arm()``."""
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.frontend import matching
    from cv_monoslam_tpu_torch.ops import control

    captured = _Captured(n, armed)
    real = matching.warp_ncc_score_map
    real_capture = SlamSession._capture_chunk
    real_dispatch = SlamSession._dispatch_chunk
    key = [None]

    def cap(image, base, A, init_patch, **kw):
        args = (image, base, A, init_patch)
        if control.warming():
            pass
        elif control.capturing() is not None:
            nodes = captured.nodes.setdefault(key[0], [])
            if len(nodes) < n:
                nodes.append((tuple(a.clone() for a in args), kw))
        elif captured.armed and len(captured) < n:
            captured.append((tuple(a.clone() for a in args), kw))
        return real(image, base, A, init_patch, **kw)

    def capture(self, k, detect, redirect=False):
        key[0] = (id(self), k, detect, redirect)
        try:
            return real_capture(self, k, detect, redirect)
        finally:
            key[0] = None

    def dispatch(self, k):
        out = real_dispatch(self, k)
        nodes = out and captured.nodes.get(
            (id(self), out["k"], self.chunk_detect[-1], False))
        if nodes and captured.armed:
            # queued after this replay, before the next one
            for args, kw in nodes[:n - len(captured)]:
                captured.append((tuple(a.clone() for a in args), kw))
        return out

    matching.warp_ncc_score_map = cap
    SlamSession._capture_chunk = capture
    SlamSession._dispatch_chunk = dispatch
    try:
        yield captured
    finally:
        matching.warp_ncc_score_map = real
        SlamSession._capture_chunk = real_capture
        SlamSession._dispatch_chunk = real_dispatch


def check_captured(captured: "_Captured", errs: dict, label: str,
                   m: int) -> None:
    """The fused kernel against its plain version and against the chain of
    the two standalone kernels (each against its own plain version) on
    captured frames: the run's first ones and, where the run went through
    chunk graphs, those of each graph's last replay (launches not counted
    for the run that captured them: call this after reading the counters
    and after the run's last chunk)."""
    if len(captured) < 3:
        raise AssertionError(f"no frames captured {label}")
    for frames, where in ((captured, label),
                          (captured.late(), f"{label} (last replay)")):
        for args, kw in frames:
            if args[1].shape[0] != m:
                raise AssertionError(f"fused kernel ran at "
                                     f"M={args[1].shape[0]} {where}")
            check_fused(args, where, errs, **kw)


def reset_counters(dev) -> None:
    """Zero the launch counters of card ``dev`` (a rank passes its own) and
    the plain normalization's calls."""
    from cv_monoslam_tpu_torch.ops import vision

    vision.normalized_templates.calls = 0
    vision.reset_device_counts(dev)


def read_counters(dev) -> dict:
    """Every kernel's launches on card ``dev``, counted on the device (also
    under graph replay and inside conditional bodies; one device read),
    and the plain normalization's calls."""
    from cv_monoslam_tpu_torch.ops import vision

    return dict(vision.device_counts(dev),
                plain_normalizations=vision.normalized_templates.calls)


def launches(counts: dict) -> dict:
    return {name: counts[name]
            for name in KERNELS + SCAN_KERNELS + LINALG_KERNELS
            + MEASURE_KERNELS}


def launch_problems(counts: dict, expected: int, what: str,
                    measure: int = None) -> list:
    """The fused kernel once per tracked frame, the standalone kernels, the
    linalg kernels (only the ``sequential`` update modes run them) and the
    plain template normalization never; with ``measure``, each of the
    measurement prediction's two kernels that many times."""
    want = dict.fromkeys(KERNELS + LINALG_KERNELS, 0)
    want["warp_ncc_score_map"] = expected
    if measure is not None:
        want.update(dict.fromkeys(MEASURE_KERNELS, measure))
    problems = [f"{name} launched {counts[name]} times for {expected} "
                f"tracked frames of {what} (wanted {n})"
                for name, n in want.items() if counts[name] != n]
    if counts["plain_normalizations"]:
        problems.append(f"the plain template normalization ran "
                        f"{counts['plain_normalizations']} times on the "
                        f"CUDA path of {what}")
    return problems


# ---------------------------------------------------------------------------
# the two recurrences of csrc/scan_kernels.cu
# ---------------------------------------------------------------------------


#: seeded tables of phase 3b (d): see :func:`store_inputs`
STORE_CASES = ("free", "dup", "evict", "lid_thrice", "lid_in_two_slots",
               "equal_stamps", "stamps_near_max", "all_stored_empty")


def store_inputs(case: str, rng, dev, m: int = 576, s: int = 64):
    """(mask, lid, valid, tlid, stamp, seq) for ``store_slots``: ``free`` a
    half-empty table, ``dup`` records that refresh stored landmarks (one
    twice in the batch), ``evict`` a full table with more records than
    slots, ``lid_thrice`` one new landmark three times in the batch,
    ``lid_in_two_slots`` a table that already holds one landmark in two
    slots and two records of it, ``equal_stamps`` every valid slot with
    one stamp, ``stamps_near_max`` stamps and seq within 2 M of 2^31 - 1,
    ``all_stored_empty`` every record stored on an empty table."""
    valid = np.ones(s, bool)
    tlid = (1000 + np.arange(s)).astype(np.int32)
    stamp = rng.permutation(s).astype(np.int32)
    seq = s
    lid = (2000 + np.arange(m)).astype(np.int32)
    mask = rng.random(m) < 0.1
    if case == "free":
        valid[rng.random(s) < 0.5] = False
    elif case == "dup":
        pick = rng.choice(m, 12, replace=False)
        lid[pick] = tlid[rng.choice(s, 12)]
        lid[pick[1]] = lid[pick[0]]
        mask[pick] = True
    elif case == "evict":
        mask = rng.random(m) < 0.3
    elif case == "lid_thrice":
        pick = rng.choice(m, 3, replace=False)
        lid[pick] = 777
        mask[pick] = True
    elif case == "lid_in_two_slots":
        tlid[[s // 3, s - 1]] = 555
        pick = rng.choice(m, 2, replace=False)
        lid[pick] = 555
        mask[pick] = True
    elif case == "equal_stamps":
        stamp[:] = 5
    elif case == "stamps_near_max":
        stamp = (2 ** 31 - 1 - rng.permutation(s)).astype(np.int32)
        seq = 2 ** 31 - 1 - 2 * m
    elif case == "all_stored_empty":
        valid[:] = False
        stamp[:] = 0
        seq = 0
        mask[:] = True
    else:
        raise ValueError(case)
    t = lambda a, dt: torch.as_tensor(np.asarray(a, dt), device=dev)
    return (t(mask, bool), t(lid, np.int32), t(valid, bool),
            t(tlid, np.int32), t(stamp, np.int32), t(seq, np.int32))


def greedy_inputs(k: int, rng, dev, family: str = "crowded"):
    """(pix, cand) for ``gftt_greedy_nms``: ``crowded`` integer pixels in a
    quarter of the frame (many within min_dist of each other), the last
    tenth not candidates; ``identical`` every corner on one pixel, all
    candidates (only the first is kept); ``none`` no candidate;
    ``interleaved`` every third corner not a candidate."""
    pix = np.stack([rng.integers(0, FRAME_W // 2, k),
                    rng.integers(0, FRAME_H // 2, k)], 1).astype(np.float32)
    cand = np.arange(k) < k - k // 10
    if family == "identical":
        pix[:] = (17.0, 5.0)
        cand[:] = True
    elif family == "none":
        cand[:] = False
    elif family == "interleaved":
        cand = np.arange(k) % 3 != 1
    elif family != "crowded":
        raise ValueError(family)
    return (torch.as_tensor(pix, device=dev),
            torch.as_tensor(cand, device=dev))


def check_scan(name: str, args, label: str, errs: dict, **kw) -> None:
    """One launch of ``name`` against its plain version: equal exactly."""
    from cv_monoslam_tpu_torch.ops import vision

    got = getattr(vision, name)(*args, **kw)
    want = getattr(vision, f"{name}_ref")(*args, **kw)
    torch.cuda.synchronize()
    bad = sum(int((g != w).sum()) for g, w in zip(got, want))
    errs[name] = max(errs.get(name, 0), bad)
    log(f"[check] {name} {label}: {bad} entries differ from the plain "
        f"version")
    if bad:
        raise AssertionError(f"{name} != its plain version {label}")


def store_bound(args) -> dict:
    """Bytes of the inputs and outputs; operations: three comparisons and
    three minimum steps per table slot for each stored record."""
    mask, lid, valid, tlid, stamp, seq = args
    m, s = mask.shape[0], valid.shape[0]
    nbytes = (m + 4 * m) + (s + 8 * s + 4) + (4 * m + 9 * s + 4)
    stored = int(mask.sum())
    return _bound(nbytes, 6 * s * stored)


def greedy_bound(args, min_dist2: float) -> dict:
    """Bytes of pixels, flags, kept and ranks; operations: five per test of
    a candidate against an earlier kept corner (what this input needs)."""
    from cv_monoslam_tpu_torch.ops import vision

    pix, cand = args
    k = cand.shape[0]
    kept, _ = vision.gftt_greedy_nms_ref(pix, cand, min_dist2)
    before = torch.cumsum(kept.to(torch.int64), 0) - kept.to(torch.int64)
    tests = int((before * cand.to(torch.int64)).sum())
    return _bound(8 * k + k + k + 4 * k, 5 * tests + k)


def plain_ms(fn, args, reps: int = 3) -> float:
    """Median wall time of a plain version that is a host loop of small
    device operations (host clock, synchronized at both ends)."""
    fn(*args)
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


@contextlib.contextmanager
def patched(module, name: str, value):
    """``module.name`` set to ``value`` while active."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def load_baseline(root: str):
    """The ``ops/vision.py`` and ``ops/linalg.py`` of another checkout of
    the port at ``root``, with its own ``_build`` and ``control``, under
    the package name ``baseline_ops`` (``.vision``, ``.linalg`` of the
    namespace returned): its recurrence kernels are built from that
    checkout's sources into that checkout's ``.cache/``."""
    import importlib
    import types

    pkg = types.ModuleType("baseline_ops")
    pkg.__path__ = [os.path.join(os.path.abspath(root),
                                 "cv_monoslam_tpu_torch", "ops")]
    sys.modules["baseline_ops"] = pkg
    vision = importlib.import_module("baseline_ops.vision")
    linalg = importlib.import_module("baseline_ops.linalg")
    vision._build.build(["scan_kernels", "linalg_kernels"])
    return types.SimpleNamespace(vision=vision, linalg=linalg)


def scan_variants(sets: list, kind: str, rng, n: int = 4) -> list:
    """Up to ``n`` distinct argument sets: ``sets``, completed where it
    holds fewer by seeded variants that ask for the same work (a greedy
    input with every corner moved by at most one pixel; a store input with
    the table's stamps permuted)."""
    out = list(sets[:n])
    i = 0
    while len(out) < n:
        base = sets[i % len(sets)]
        i += 1
        if kind == "greedy":
            pix, cand, md2 = base
            d = rng.integers(-1, 2, tuple(pix.shape)).astype(np.float32)
            out.append((pix + torch.as_tensor(d, device=pix.device), cand,
                        md2))
        else:
            mask, lid, valid, tlid, stamp, seq = base
            perm = torch.as_tensor(rng.permutation(stamp.shape[0]),
                                   device=stamp.device)
            out.append((mask, lid, valid, tlid, stamp[perm].contiguous(),
                        seq))
    return out


def scan_times(dev, floor: float, runs: dict, baseline=None) -> dict:
    """Kernel and plain times of the two recurrences at the main path's
    shapes, each on four distinct argument sets that :func:`time_ms` cycles
    through: store_slots on the inputs config 3's runs of phase 3b gave it
    (M = 576, S = 64) and on full tables with 30 % of 576 records stored
    (the heaviest store a frame could ask for); the greedy pass on config
    1's (K = 48) and config 3's (K = 768); captured sets completed by
    :func:`scan_variants`. Beside each: the dependent steps of its chain
    (stored records; ceil(K / 32) word-steps) and microseconds per step
    above the launch floor. With ``baseline`` (:func:`load_baseline`):
    that checkout's kernels and this tree's in turns (baseline, this,
    this, baseline) on the same sets, the greedy pass by its other route
    (one block or a grid), and last both greedy routes on seeded inputs
    at K = 96 ... 384, where they cross (``GREEDY_ONE_BLOCK_MAX_K``). The
    plain versions, host loops of small operations, by :func:`plain_ms`.
    Bounds count what each input needs (the median over the sets)."""
    from cv_monoslam_tpu_torch.ops import vision

    rng = np.random.default_rng(5)
    cases = (
        ("store_slots", "store",
         scan_variants(runs["config3"]["store_slots"], "store", rng)),
        ("store_slots_heavy", "store",
         [store_inputs("evict", np.random.default_rng(5 + i), dev)
          for i in range(4)]),
        ("gftt_greedy_nms_k48", "greedy",
         scan_variants(runs["config1"]["gftt_greedy_nms"], "greedy", rng)),
        ("gftt_greedy_nms_k768", "greedy",
         scan_variants(runs["config3"]["gftt_greedy_nms"], "greedy", rng)))
    out = {}
    for name, kind, sets in cases:
        if kind == "store":
            call = lambda mod: mod.store_slots
            ref, args = vision.store_slots_ref, sets
            bounds = [store_bound(a) for a in sets]
            steps = statistics.median(int(a[0].sum()) for a in sets)
            what = (f"M={sets[0][0].shape[0]} S={sets[0][2].shape[0]}, "
                    f"{[int(a[0].sum()) for a in sets]} stored")
        else:
            md2 = sets[0][2]
            call = lambda mod, md2=md2: (
                lambda p, c: mod.gftt_greedy_nms(p, c, md2))
            ref = lambda p, c, md2=md2: vision.gftt_greedy_nms_ref(p, c, md2)
            args = [a[:2] for a in sets]
            bounds = [greedy_bound(a, md2) for a in args]
            k = args[0][1].shape[0]
            steps = -(-k // 32)
            what = f"K={k}"
        b = sorted(bounds, key=lambda x: x["bound_ms"])[len(bounds) // 2]
        turns = ("baseline", "this", "this", "baseline") if baseline \
            else ("this",)
        runs_ms = {"this": [], "baseline": []}
        for who in turns:
            t, host = time_ms(
                call(vision if who == "this" else baseline.vision), args)
            runs_ms[who].append(t)
            if who == "this" and len(runs_ms["this"]) == 1:
                k_ms, host_ms = t, host
        alt_ms = {}  # the greedy pass by its other route
        if kind == "greedy" and baseline is not None:
            grid = k > vision.GREEDY_ONE_BLOCK_MAX_K
            with patched(vision, "GREEDY_ONE_BLOCK_MAX_K",
                         vision.GREEDY_SMEM_MAX_K if grid else 0):
                alt_ms["one block" if grid else "a grid"] = time_ms(
                    call(vision), args)[0]
        pl = plain_ms(ref, args[0])
        per_step = (k_ms - floor) * 1e3 / max(steps, 1)
        out[name] = dict(ms=k_ms, host_ms=host_ms, plain_ms=pl,
                         library_ms=None, shape=what, steps=steps,
                         us_per_step=per_step, ms_runs=runs_ms["this"],
                         baseline_ms=runs_ms["baseline"], alt_ms=alt_ms,
                         **b)
        log(f"[time] {name} {what}: kernel {k_ms:.4f} ms (host "
            f"{host_ms:.4f}; runs {[round(x, 4) for x in runs_ms['this']]}"
            f"), plain {pl:.4f} ms, bound {b['bound_ms'] * 1e3:.4f} us "
            f"({b['bound_by']}), launch floor {floor:.4f} ms; {steps} "
            f"dependent steps, {per_step:.4f} us per step"
            + "".join(f"; {a} {v:.4f} ms" for a, v in alt_ms.items())
            + (f"; baseline {[round(x, 4) for x in runs_ms['baseline']]} "
               f"ms (turns: baseline, this, this, baseline)"
               if baseline else ""))
    if baseline is None:
        return out
    # where the greedy pass's two routes cross (GREEDY_ONE_BLOCK_MAX_K)
    out["greedy_routes"] = {}
    for k in (96, 128, 192, 256, 384):
        sets = [greedy_inputs(k, np.random.default_rng(20 + i), dev)
                for i in range(4)]
        fn = lambda p, c: vision.gftt_greedy_nms(p, c, 100.0)
        row = {}
        for route, limit in (("one block", vision.GREEDY_SMEM_MAX_K),
                             ("a grid", 0)):
            with patched(vision, "GREEDY_ONE_BLOCK_MAX_K", limit):
                row[route] = time_ms(fn, sets)[0]
        out["greedy_routes"][k] = row
        log(f"[time] gftt_greedy_nms routes, seeded K={k}: "
            f"{', '.join(f'{r} {v:.4f} ms' for r, v in row.items())}")
    return out


@contextlib.contextmanager
def captured_scan_inputs(n: int = 4):
    """While active, keep copies of the first ``n`` argument sets of each
    recurrence kernel's eager calls (a warm-up's and a capture's are
    skipped: the warm-up runs on a blank window, and a captured call's
    tensors hold nothing until a replay)."""
    from cv_monoslam_tpu_torch.ops import control, vision

    got = {"store_slots": [], "gftt_greedy_nms": []}
    real = {name: getattr(vision, name) for name in got}

    def hook(name):
        def cap(*args):
            if (len(got[name]) < n and not control.warming()
                    and control.capturing() is None):
                got[name].append(tuple(a.clone() if isinstance(
                    a, torch.Tensor) else a for a in args))
            return real[name](*args)
        return cap

    for name in got:
        setattr(vision, name, hook(name))
    try:
        yield got
    finally:
        for name, fn in real.items():
            setattr(vision, name, fn)


def state_equal(a, b) -> Tuple[list, dict]:
    """Fields of two filter states that differ: (discrete ones, max |diff|
    of each float one)."""
    from cv_monoslam_tpu_torch.convert import state_to_arrays

    sa, sb = state_to_arrays(a), state_to_arrays(b)
    discrete, floats = [], {}
    for key in sa:
        x, y = sa[key], sb[key]
        if np.array_equal(x, y, equal_nan=True):
            continue
        if np.issubdtype(x.dtype, np.floating):
            floats[key] = float(np.nanmax(np.abs(x.astype(np.float64)
                                                 - y.astype(np.float64))))
        else:
            discrete.append(key)
    return discrete, floats


def graph_vs_eager(sess, chunk: int, label: str, eager_ctx=None) -> dict:
    """(a) One window from one state through the graph and through an eager
    chunk (the private switch ``_graphs``): telemetry rows and final states
    compared. (b) The graph's dispatch under ``set_sync_debug_mode
    ("error")``; the launches of the graph's window (``launches``). The
    eager run's recurrence inputs are kept for (d); ``eager_ctx()`` is
    entered around the eager run."""
    from cv_monoslam_tpu_torch.api import _unpack_row
    from cv_monoslam_tpu_torch.ops import control

    c0, matched0 = sess.counter, sess._last_matched
    s0 = control.tree_map(torch.clone, sess.state)
    torch.cuda.synchronize()
    runs = {}
    for route in ("graph", "eager"):
        sess._graphs = route == "graph"
        sess.state = control.tree_map(torch.clone, s0)
        sess.counter, sess._last_matched = c0, matched0
        if route == "graph":
            torch.cuda.synchronize()
            reset_counters(sess.device)
            torch.cuda.set_sync_debug_mode("error")
            try:
                pending = sess._dispatch_chunk(chunk)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            scans = None
        else:
            with captured_scan_inputs() as scans, \
                    (eager_ctx or contextlib.nullcontext)():
                pending = sess._dispatch_chunk(chunk)
        n0 = len(sess.records)
        sess._finish_chunk(pending)
        if route == "graph":
            counts = read_counters(sess.device)
        runs[route] = (pending["rows"].numpy().copy(),
                       control.tree_map(torch.clone, sess.state), scans,
                       sess.records[n0:])
    sess._graphs = True
    rg, sg, _, recs_g = runs["graph"]
    re_, se, scans, recs_e = runs["eager"]
    discrete, floats = state_equal(sg, se)
    M = sess.cfg.max_landmarks
    row_diff = float(np.abs(rg.astype(np.float64) - re_).max())
    tele_discrete = [
        key for key in ("n_map", "n_visible", "n_matched", "redirected",
                        "health", "repairs", "lm_lid", "lm_active",
                        "lm_matched")
        if not all(np.array_equal(_unpack_row(rg[i], M)[key],
                                  _unpack_row(re_[i], M)[key])
                   for i in range(rg.shape[0]))]
    res = dict(label=label, chunk=chunk, detect=sess.chunk_detect[-1],
               rows_equal=bool(np.array_equal(rg, re_)),
               rows_max_abs_diff=row_diff,
               state_equal=not discrete and not floats,
               state_discrete_differ=discrete, state_float_max_diff=floats,
               telemetry_discrete_differ=tele_discrete,
               matched=[r.n_matched for r in recs_g],
               dispatch_syncs=0, launches=counts)
    log(f"[graphs] (a)+(b) {label} detect={res['detect']}: rows equal "
        f"{res['rows_equal']} (max |diff| {row_diff:.3e}), state equal "
        f"{res['state_equal']} {floats if floats else ''}; dispatch under "
        f"set_sync_debug_mode('error'): no synchronizing call")
    if discrete or tele_discrete:
        raise AssertionError(f"graph != eager in discrete results "
                             f"{discrete + tele_discrete} ({label})")
    return res, scans


def dispatch_census(sess, chunk: int) -> Tuple[int, int]:
    """Synchronizing calls of one dispatch and of its finish, counted by
    ``set_sync_debug_mode("warn")``."""
    import warnings

    counts = []
    for step in ("dispatch", "finish"):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                if step == "dispatch":
                    pending = sess._dispatch_chunk(chunk)
                else:
                    sess._finish_chunk(pending)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.append(sum("called a synchronizing CUDA operation"
                          in str(x.message) for x in w))
    return counts[0], counts[1]


def pool_reserved(pool) -> int:
    """Bytes the card's segments of the graph pool ``pool`` hold."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def pool_footprint(sess) -> dict:
    """Bytes the card holds for the session's graphs, read after their
    captures: reserved by the graph pool they share and by the pool of
    their conditional bodies (segments of ``torch.cuda.memory_snapshot()``
    by pool id), and ``memory_reserved()`` of the whole process."""
    return dict(graph_pool=pool_reserved(sess._pool),
                body_pool=pool_reserved(sess._body_pool.id),
                memory_reserved=torch.cuda.memory_reserved())


def routes_fps(sess, start, chunk: int, n_chunks: int) -> dict:
    """(e) frames/s and peak memory of the graph route and the eager route,
    each running ``run(chunk=...)`` over the same ``n_chunks`` windows from
    the same ``start`` (counter, state, last match count), in the order
    graph / eager / eager / graph."""
    from cv_monoslam_tpu_torch.ops import control

    c0, s0, matched0 = start
    out = {"graph": [], "eager": [], "graph_peak": 0, "eager_peak": 0}
    for route in ("graph", "eager", "eager", "graph"):
        sess._graphs = route == "graph"
        sess.state = control.tree_map(torch.clone, s0)
        sess.counter, sess._last_matched = c0, matched0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = len(sess.records)
        t0 = time.perf_counter()
        sess.run(n_frames=n_chunks * chunk, chunk=chunk, drop_tail=True)
        torch.cuda.synchronize()
        out[route].append((len(sess.records) - n0)
                          / (time.perf_counter() - t0))
        out[f"{route}_peak"] = max(out[f"{route}_peak"],
                                   torch.cuda.max_memory_allocated())
    sess._graphs = True
    return out


def seeded_scan_checks(dev, errs: dict) -> None:
    """(d) on seeded inputs: store_slots on every table of
    :data:`STORE_CASES` at S = 1, 40 and 64 (M = 576), on more records than
    its block has threads (M = 1500) and at S = 200 and 1100 (a 256-thread
    block; the table in shared memory, whose warp minimum is the 64-bit
    key's, also on equal, near-maximal and zero stamps); the greedy pass
    at K = 1, 31, 32, 33, 48, 77, 768, 1025 and 4096, on both sides of the
    boundary between one block and one per 32 rows and of the one between
    the bitmask in shared memory and in the scratch, by the other route at
    K = 768 and 1344, and on the identical, no-candidate and interleaved
    families."""
    from cv_monoslam_tpu_torch.ops import vision

    rng = np.random.default_rng(9)
    for case in STORE_CASES:
        for s in (1, 40, 64):
            check_scan("store_slots", store_inputs(case, rng, dev, s=s),
                       f"seeded {case} S={s}", errs)
    for case, m, s in (("evict", 1500, 64), ("evict", 576, 200),
                       ("free", 576, 1100), ("all_stored_empty", 576, 200)):
        check_scan("store_slots", store_inputs(case, rng, dev, m=m, s=s),
                   f"seeded {case} M={m} S={s}", errs)
    for case in ("equal_stamps", "stamps_near_max", "all_stored_empty"):
        check_scan("store_slots", store_inputs(case, rng, dev, s=1100),
                   f"seeded {case} S=1100", errs)
    b1, b2 = vision.GREEDY_ONE_BLOCK_MAX_K, vision.GREEDY_SMEM_MAX_K
    for k in (1, 31, 32, 33, 48, 77, 768, 1025, 4096, b1, b1 + 1, b2,
              b2 + 1):
        check_scan("gftt_greedy_nms", greedy_inputs(k, rng, dev),
                   f"seeded K={k}", errs, min_dist2=100.0)
    with patched(vision, "GREEDY_ONE_BLOCK_MAX_K", b2):
        for k in (768, b2):
            check_scan("gftt_greedy_nms", greedy_inputs(k, rng, dev),
                       f"seeded K={k}, one block", errs, min_dist2=100.0)
    with patched(vision, "GREEDY_ONE_BLOCK_MAX_K", 0):
        check_scan("gftt_greedy_nms", greedy_inputs(48, rng, dev),
                   "seeded K=48, a grid", errs,
                   min_dist2=100.0)
    for family in ("identical", "none", "interleaved"):
        for k in (33, 768):
            args = greedy_inputs(k, rng, dev, family)
            check_scan("gftt_greedy_nms", args, f"seeded {family} K={k}",
                       errs, min_dist2=100.0)
            kept, _ = vision.gftt_greedy_nms(*args, 100.0)
            n_kept = int(kept.sum())
            if family != "interleaved" and n_kept != (family == "identical"):
                raise AssertionError(f"gftt_greedy_nms {family} K={k}: "
                                     f"{n_kept} kept")


def phase_chunk_graphs(dev, errs: dict, floor: float,
                       baseline=None) -> dict:
    """The chunk machinery on the card: for config 1 (chunk 32), config 3
    (chunk 8, both detect keys) and config 4's filter (chunk 8): (a) graph
    equals eager, (b) no synchronizing call in a dispatch, (c) one fused
    launch per tracked frame under replay, (d) the two recurrence kernels
    against their plain versions on seeded and captured inputs, (e)
    capture time per graph, frames/s of both routes, peak memory."""
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.io import fixtures
    from cv_monoslam_tpu_torch.ops import control

    seeded_scan_checks(dev, errs)

    out = {}
    scans_all = {"store_slots": [], "gftt_greedy_nms": []}
    runs = {}
    setups = (
        ("config1", "bench1_arc", {}, CONFIG1, 32, [None]),
        ("config3", "bench3_grid", dict(min_step_xy=0.005), CONFIG3, 8,
         [0, 10 ** 6]),
        ("config4", "bench4_lap", {}, CONFIG4, 8, [None]))
    for name, fixture, fkw, ckw, chunk, gates in setups:
        seq, track, _, _ = fixtures.load(fixture, **fkw)
        cfg = SlamConfig(**ckw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sess = SlamSession(cfg, seq, track, device=dev)
        sess.step_chunk(chunk)                        # captures (chunk, True)
        start = (sess.counter, control.tree_map(torch.clone, sess.state),
                 sess._last_matched)
        res = dict(checks=[])
        for gate in gates:
            if gate is not None:
                sess.detect_host_gate = True
                sess._last_matched = gate
                sess.step_chunk(chunk)                # captures this key
                sess._last_matched = gate
            r, scans = graph_vs_eager(sess, chunk, name)
            res["checks"].append(r)
            for key, calls in scans.items():
                scans_all[key] += calls
                runs.setdefault(name, {}).setdefault(key, []).extend(calls)
            if gate is not None:
                sess._last_matched = gate
            reset_counters(dev)
            n_syncs = dispatch_census(sess, chunk)
            counts = read_counters(dev)
            res.setdefault("dispatch_syncs_per_frame", []).append(
                n_syncs[0] / chunk)
            res.setdefault("finish_syncs_per_chunk", []).append(n_syncs[1])
            problems = launch_problems(
                counts, chunk, f"one {name} chunk",
                measure=0 if name == "config3" else chunk)
            log(f"[graphs] (b)+(c) {name} detect={sess.chunk_detect[-1]}: "
                f"{n_syncs[0] / chunk:.2f} synchronizing calls/frame in the "
                f"dispatch, {n_syncs[1]} in the finish (the telemetry "
                f"event); launches under replay {launches(counts)}, "
                f"store_slots {counts['store_slots']}, gftt_greedy_nms "
                f"{counts['gftt_greedy_nms']}")
            if n_syncs[0] or problems:
                raise AssertionError(f"{name}: {n_syncs[0]} syncs in a "
                                     f"dispatch; {problems}")
        res["capture_s"] = {f"{k}x{'detect' if d else 'track'}": v
                            for (k, d, _, _), v in sess.capture_s.items()}
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        res["footprint"] = pool_footprint(sess)
        if gates[0] is not None:
            sess.detect_gate_margin = 0             # config 3's cadence
        res["fps"] = routes_fps(sess, start, chunk, min(
            3, (len(sess.track) - start[0]) // chunk))
        log(f"[graphs] (e) {name}: capture {res['capture_s']} s; frames/s "
            f"graph {res['fps']['graph']} eager {res['fps']['eager']}; "
            f"max_memory_allocated: whole phase "
            f"{res['max_memory_allocated'] / 2**20:.1f} MiB, graph route "
            f"{res['fps']['graph_peak'] / 2**20:.1f} MiB, eager route "
            f"{res['fps']['eager_peak'] / 2**20:.1f} MiB; reserved after "
            f"the captures: graph pool "
            f"{res['footprint']['graph_pool'] / 2**20:.1f} MiB, body pool "
            f"{res['footprint']['body_pool'] / 2**20:.1f} MiB, process "
            f"{res['footprint']['memory_reserved'] / 2**20:.1f} MiB")
        out[name] = res
    for key, calls in scans_all.items():
        for i, args in enumerate(calls):
            if key == "gftt_greedy_nms":
                check_scan(key, args[:2], f"captured {i}", errs,
                           min_dist2=args[2])
            else:
                check_scan(key, args, f"captured {i}", errs)
    out["captured"] = {k: len(v) for k, v in scans_all.items()}
    if not (runs.get("config3", {}).get("store_slots")
            and runs["config3"].get("gftt_greedy_nms")
            and runs.get("config1", {}).get("gftt_greedy_nms")):
        raise AssertionError(f"recurrence inputs captured: "
                             f"{out['captured']}")
    out["scan_times"] = scan_times(dev, floor, runs, baseline)
    return out


# ---------------------------------------------------------------------------
# phase 3c: step graphs, the other update / QR modes, and the two linalg
# recurrences of csrc/linalg_kernels.cu
# ---------------------------------------------------------------------------

#: the kernels of csrc/linalg_kernels.cu
LINALG_KERNELS = ("rank_rotate", "gmw_chol")
#: phase 3c (d): the update / QR modes at the config-1 widths, and each
#: linalg kernel's launches per matched slot of a frame in that mode;
#: ``sequential_gmw_m64`` at max_landmarks=64 (D = 388: ``gmw_chol``'s grid
#: route, a cooperative launch, in a conditional body)
MODES = (
    ("sequential", dict(update_mode="sequential"),
     dict(rank_rotate=1, gmw_chol=0)),
    ("sequential_gmw", dict(update_mode="sequential", downdate_mode="gmw"),
     dict(rank_rotate=0, gmw_chol=2)),
    ("sequential_gmw_m64", dict(update_mode="sequential",
                                downdate_mode="gmw", max_landmarks=64),
     dict(rank_rotate=0, gmw_chol=2)),
    ("batched_householder", dict(update_mode="batched", qr_mode="householder"),
     dict(rank_rotate=0, gmw_chol=0)),
    ("gram_cholqr2", dict(qr_mode="cholqr2"),
     dict(rank_rotate=0, gmw_chol=0)),
)


def rotate_inputs(n: int, k: int, rng, dev, dtype, case: str = "random"):
    """(r, u) for ``rank_rotate``: r upper triangular with N(0, 1) entries
    above a diagonal of |N(0, 1)| + 2; u (k, n) rows of scale 0.3
    (``random``: a downdate keeps positive definiteness almost everywhere),
    3 (``pd_loss``: many downdate columns lose it and are skipped), with a
    third of their entries 0 (``zeros_in_u``), or all 0 (``zero``)."""
    r = np.triu(rng.normal(size=(n, n)))
    r[np.diag_indices(n)] = np.abs(r[np.diag_indices(n)]) + 2.0
    u = rng.normal(size=(k, n)) * (3.0 if case == "pd_loss" else 0.3)
    if case == "zeros_in_u":
        u[rng.random(u.shape) < 1 / 3] = 0.0
    elif case == "zero":
        u[:] = 0.0
    elif case not in ("random", "pd_loss"):
        raise ValueError(case)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return t(r), t(u)


def gmw_inputs(n: int, rng, dev, dtype, case: str = "spd"):
    """A for ``gmw_chol``: ``spd`` B^T B / n + 0.01 I; ``gram_minus`` the
    sequential update's form, a Gram minus an outer product larger than it
    in one direction; ``indefinite`` a symmetric N(0, 1) matrix; ``zero``;
    ``nonfinite`` the spd matrix with one entry +inf and another NaN."""
    b = torch.as_tensor(rng.normal(size=(n, n)), dtype=dtype, device=dev)
    if case in ("spd", "nonfinite", "gram_minus"):
        a = b.T @ b / n + 0.01 * torch.eye(n, dtype=dtype, device=dev)
        if case == "gram_minus":
            v = torch.as_tensor(rng.normal(size=n), dtype=dtype, device=dev)
            a = a - 4.0 * torch.outer(v, v)
        elif case == "nonfinite":
            i, j = rng.choice(n, 2, replace=False) if n > 1 else (0, 0)
            a[i, j] = float("inf")
            a[j, max(i - 1, 0)] = float("nan")
    elif case == "indefinite":
        a = 0.5 * (b + b.T)
    elif case == "zero":
        a = torch.zeros((n, n), dtype=dtype, device=dev)
    else:
        raise ValueError(case)
    return (a.contiguous(),)


def exact_diff(got: torch.Tensor, want: torch.Tensor) -> Tuple[int, float]:
    """(entries that differ, NaN matching NaN; max |diff| over the entries
    finite in both)."""
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    both = torch.isfinite(got) & torch.isfinite(want)
    diff = (got - want)[both].abs()
    return int((~same).sum()), float(diff.max()) if diff.numel() else 0.0


def linalg_call(name: str, args, plain: bool = False, mod=None):
    """One call of kernel ``name`` (or its plain version) on ``args``:
    ``rank_rotate`` (r, u, downdate), ``gmw_chol`` (a,); ``mod``: another
    checkout's ``ops/linalg.py`` (:func:`load_baseline`)."""
    from cv_monoslam_tpu_torch.ops import linalg

    mod = mod or linalg
    if name == "rank_rotate":
        r, u, downdate = args
        if plain:
            return (linalg.chol_downdate_ref(r, u) if downdate
                    else linalg.chol_update_ref(r, u))
        return mod.rank_rotate(r, u, downdate,
                               eps=1e-12 if downdate else 0.0)
    return (linalg.gmw_chol_ref if plain else mod.gmw_chol)(*args)


def check_linalg(name: str, args, label: str, errs: dict) -> float:
    """One launch of ``name`` against its plain version: equal exactly
    (NaN where it is NaN). Returns the plain version's seconds."""
    got = linalg_call(name, args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = linalg_call(name, args, plain=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    bad, md = exact_diff(got, want)
    errs[name] = max(errs.get(name, 0.0), md)
    nonfinite = int((~torch.isfinite(want)).sum())
    log(f"[check] {name} {label}: {bad} entries differ from the plain "
        f"version (max |diff| {md:.3e}; {nonfinite} not finite in both)")
    if bad:
        raise AssertionError(f"{name} != its plain version {label}")
    return plain_s


def check_gmw_route(a: torch.Tensor, label: str, errs: dict,
                    **route) -> int:
    """``gmw_chol``'s kernel by the route ``route`` picks
    (``linalg._gmw_launch``'s ``route``: 1 the grid, its panel in shared
    memory, 2 in the workspace; default: the launcher's) with its own
    floors: S against the plain version and the floors (delta, beta^2)
    against ``_gmw_floors`` on the card, both exactly. Returns the floors'
    differing entries (0)."""
    from cv_monoslam_tpu_torch.ops import linalg

    s = torch.empty_like(a)
    fl = torch.empty(2, dtype=a.dtype, device=a.device)
    linalg._gmw_launch(a, s, fl, **route)
    bad, md = exact_diff(s, linalg.gmw_chol_ref(a))
    fbad, _ = exact_diff(fl, linalg._gmw_floors(a))
    errs["gmw_chol"] = max(errs.get("gmw_chol", 0.0), md)
    if route:
        log(f"[check] gmw_chol {label} {route}: {bad} entries differ from "
            f"the plain version, floors {fbad} of 2")
    if bad or fbad:
        raise AssertionError(f"gmw_chol {label} {route}: {bad} entries, "
                             f"floors {fl.tolist()} against "
                             f"{linalg._gmw_floors(a).tolist()}")
    return fbad


def check_rotate_wide(r: torch.Tensor, u: torch.Tensor, downdate: bool,
                      label: str, errs: dict) -> None:
    """``rank_rotate``'s wide kernel (one row of U a launch, the launcher's
    route above n = 4096) forced at this n (``linalg._rotate_launch``'s
    ``route=1``): equal to the plain version exactly."""
    from cv_monoslam_tpu_torch.ops import linalg

    eps = 1e-12 if downdate else 0.0
    got = linalg._rotate_launch(r, u, downdate, eps, route=1)
    want = linalg_call("rank_rotate", (r, u, downdate), plain=True)
    bad, md = exact_diff(got, want)
    errs["rank_rotate"] = max(errs["rank_rotate"], md)
    log(f"[check] rank_rotate {label} by the wide kernel: {bad} entries "
        f"differ from the plain version")
    if bad:
        raise AssertionError(f"rank_rotate wide kernel {label}: {bad} "
                             f"entries differ")


def rotate_bound(n: int, k: int, itemsize: int) -> dict:
    """R in, R' out, U in; operations: six per column right of a pivot
    (four products, two sums) and ten per pivot, for each row of U. The
    rate is 67 TFLOP/s for both types: float32 outside the tensor cores,
    float64 through them (34 TFLOP/s outside)."""
    return _bound((2 * n * n + k * n) * itemsize,
                  k * (3 * n * (n - 1) + 10 * n))


def gmw_bound(n: int, itemsize: int) -> dict:
    """A in, S out; operations: three per entry of each pivot's trailing
    lower triangle (rows i > j, columns j < l <= i: the entries the
    function reads again), two per entry of S, a few per pivot (the rate
    as :func:`rotate_bound`'s)."""
    return _bound(2 * n * n * itemsize,
                  sum(3 * (n - j - 1) * (n - j) // 2 for j in range(n))
                  + 2 * n * n + 8 * n)


def seeded_linalg_checks(dev, errs: dict) -> dict:
    """(a) on seeded inputs, float32 and float64: ``rank_rotate`` both ways
    at n = 16, 100, 196, 580 and k = 1, 2, 3 (k = 5 at n = 100: a wavefront
    of four rows, then one), its PD-loss, zero-entry and all-zero U at n =
    196 and 580; ``gmw_chol`` at n = 1, 2 and the same n on every case of
    :func:`gmw_inputs` (one block up to n = 338 / 238, the panel-deferred
    grid above), each set's in-kernel floors against ``_gmw_floors`` on the
    card; the grid route at n = 196 too, its panel in shared memory and in
    the workspace, and ``rank_rotate``'s wide kernel at n = 100 and 196;
    one set of each at n = 3460 (config 3's D), where the plain loops take
    seconds, and at the widths where the launchers leave their fast routes:
    ``rank_rotate`` at n = 4100 float32 (the wide kernel), ``gmw_chol`` at
    n = 3700 float64 (the grid's panel in the workspace). Returns the plain
    versions' seconds at n = 3460."""
    rng = np.random.default_rng(12)
    plain_s = {}
    floor_sets = 0
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).split(".")[1]
        for n in (1, 2, 16, 100, 196, 580):
            for k in (1, 2, 3) if n > 2 else ():
                for downdate in (True, False):
                    r, u = rotate_inputs(n, k, rng, dev, dtype)
                    check_linalg("rank_rotate", (r, u, downdate),
                                 f"{dt} n={n} k={k} "
                                 f"{'down' if downdate else 'up'}date", errs)
            if n in (196, 580):
                for case in ("pd_loss", "zeros_in_u", "zero"):
                    r, u = rotate_inputs(n, 2, rng, dev, dtype, case)
                    check_linalg("rank_rotate", (r, u, True),
                                 f"{dt} n={n} k=2 downdate {case}", errs)
            if n == 100:
                r, u = rotate_inputs(n, 5, rng, dev, dtype, "zeros_in_u")
                check_linalg("rank_rotate", (r, u, True),
                             f"{dt} n={n} k=5 downdate zeros_in_u", errs)
            for case in ("spd", "gram_minus", "indefinite", "zero",
                         "nonfinite"):
                a = gmw_inputs(n, rng, dev, dtype, case)
                check_linalg("gmw_chol", a, f"{dt} n={n} {case}", errs)
                check_gmw_route(a[0], f"{dt} n={n} {case}", errs)
                floor_sets += 1
                if n == 196:
                    for route in (1, 2):
                        check_gmw_route(a[0], f"{dt} n={n} {case}", errs,
                                        route=route)
            if n in (100, 196):
                for case in ("random", "pd_loss", "zeros_in_u"):
                    r, u = rotate_inputs(n, 3, rng, dev, dtype, case)
                    for downdate in (True, False):
                        check_rotate_wide(
                            r, u, downdate, f"{dt} n={n} k=3 {case} "
                            f"{'down' if downdate else 'up'}date", errs)
        n = 3460
        r, u = rotate_inputs(n, 1, rng, dev, dtype, "pd_loss")
        plain_s[("rank_rotate", dt)] = check_linalg(
            "rank_rotate", (r, u, True), f"{dt} n={n} k=1 downdate pd_loss",
            errs)
        a = gmw_inputs(n, rng, dev, dtype, "gram_minus")
        plain_s[("gmw_chol", dt)] = check_linalg(
            "gmw_chol", a, f"{dt} n={n} gram_minus", errs)
        check_gmw_route(a[0], f"{dt} n={n} gram_minus", errs)
        floor_sets += 1
        if dtype == torch.float32:
            r, u = rotate_inputs(4100, 2, rng, dev, dtype, "pd_loss")
            check_linalg("rank_rotate", (r, u, True),
                         f"{dt} n=4100 k=2 downdate pd_loss (wide kernel)",
                         errs)
        else:
            a = gmw_inputs(3700, rng, dev, dtype, "gram_minus")
            check_linalg("gmw_chol", a, f"{dt} n=3700 gram_minus (panel "
                         f"in the workspace)", errs)
            check_gmw_route(a[0], f"{dt} n=3700 gram_minus", errs)
            floor_sets += 1
    log(f"[check] gmw_chol floors: the kernel's (delta, beta^2) equal "
        f"_gmw_floors on the card on all {floor_sets} seeded sets")
    return plain_s


def chain_latency_ms(name: str, steps: int, dtype, dev) -> float:
    """The latency bound on card ``dev``: one thread running ``steps`` of
    the recurrence's dependent step arithmetic (``cvms_chain_latency``),
    CUDA events."""
    from cv_monoslam_tpu_torch.ops import _build, linalg

    lib = _build.load(linalg._SIGNATURES, "linalg_kernels")
    # r, u, ua, rb, eps, a0, a1, beta2, delta; the result
    io = torch.tensor([2.0, 0.3, 0.25, 0.125, 1e-12, 1.0, 0.5, 1.0, 1e-12,
                       0.0], dtype=dtype, device=dev)
    f64, kind = int(dtype == torch.float64), int(name == "gmw_chol")
    return time_ms(lambda: _build.launch(
        lib, "cvms_chain_latency", "chain latency", dev, f64, kind, steps,
        io.data_ptr()), [()])[0]


def linalg_times(dev, floor: float, plain_large: dict,
                 baseline=None) -> dict:
    """Kernel time against the bounds, the plain version and the library
    at the shapes of the main paths (``rank_rotate`` n = 196, k = 2,
    float32: config 1 sequential; ``gmw_chol`` n = 196 float32: config 1
    gmw, n = 100 float64: faithful mode) and at n = 580 and 3460: CUDA
    events behind a device backlog (:func:`time_ms`, four distinct input
    sets) up to n = 580, the host clock over three synchronized calls at
    3460. With ``baseline`` (:func:`load_baseline`) that checkout's
    kernels and this tree's in turns (baseline, this, this, baseline).
    Beside each: dependent steps (the wavefront's n + k - 1 intervals, n
    pivots) and µs per step above the launch floor; the latency bound
    (:func:`chain_latency_ms`, those steps of one thread) and the kernel's
    time over it;
    ``gmw_chol``'s library call, ``torch.linalg.cholesky_ex(upper=True)``
    on ``spd`` sets where no floor binds (the same function there; the
    kernel timed on the same sets, max |S - R| / max |R| printed);
    ``rank_rotate``'s ``cholesky_ex`` of R^T R - U^T U, not the same
    function (no PD-loss skip)."""
    rng = np.random.default_rng(13)
    out = {}
    shapes = (("rank_rotate", 196, 2, torch.float32),
              ("rank_rotate", 100, 2, torch.float64),
              ("rank_rotate", 580, 2, torch.float32),
              ("rank_rotate", 3460, 1, torch.float32),
              ("gmw_chol", 196, 0, torch.float32),
              ("gmw_chol", 100, 0, torch.float64),
              ("gmw_chol", 580, 0, torch.float32),
              ("gmw_chol", 3460, 0, torch.float32))
    chol = lambda a: torch.linalg.cholesky_ex(a, upper=True)
    for name, n, k, dtype in shapes:
        dt = str(dtype).split(".")[1]
        if name == "rank_rotate":
            sets = [rotate_inputs(n, k, rng, dev, dtype) + (True,)
                    for _ in range(4)]
            b, steps = rotate_bound(n, k, dtype.itemsize), n + k - 1
        else:
            sets = [gmw_inputs(n, rng, dev, dtype, "gram_minus")
                    for _ in range(4)]
            b, steps = gmw_bound(n, dtype.itemsize), n

        def timed(fn, arg_sets):
            if n <= 580:
                return time_ms(fn, arg_sets)
            return plain_ms(fn, arg_sets[0]), None  # ms a call: 3 suffice

        turns = ("baseline", "this", "this", "baseline") if baseline \
            else ("this",)
        runs = {"this": [], "baseline": []}
        for who in turns:
            mod = baseline.linalg if who == "baseline" else None
            t, h = timed(lambda *a: linalg_call(name, a, mod=mod), sets)
            runs[who].append(t)
            if who == "this" and len(runs["this"]) == 1:
                ms, host = t, h
        if n == 3460:
            pl = plain_large[(name, dt)] * 1e3
        else:
            pl = plain_ms(lambda *a: linalg_call(name, a, plain=True),
                          sets[0])
        lat = chain_latency_ms(name, steps, dtype, dev)
        extra = {}
        if name == "gmw_chol":
            spd = [gmw_inputs(n, rng, dev, dtype, "spd") for _ in range(4)]
            lib = timed(chol, spd)[0]
            ms_spd = timed(lambda a: linalg_call(name, (a,)), spd)[0]
            r_lib = chol(spd[0][0])[0]
            rel = float((linalg_call(name, spd[0]) - r_lib).abs().max()
                        / r_lib.abs().max())
            extra = dict(ms_spd=ms_spd, library_rel_diff=rel)
            lib_text = (f"library cholesky_ex {lib:.4f} ms on spd sets "
                        f"(kernel {ms_spd:.4f} ms there, max |S - R| / "
                        f"max |R| {rel:.2e})")
        else:
            grams = [(r.T @ r - u.T @ u,) for r, u, _ in sets]
            extra = dict(chol_gram_ms=timed(chol, grams)[0])
            lib = None
            lib_text = (f"cholesky_ex of R^T R - U^T U "
                        f"{extra['chol_gram_ms']:.4f} ms (not the same "
                        f"function: no PD-loss skip)")
        key = f"{name}_n{n}_{dt}"
        step = "intervals" if name == "rank_rotate" else "pivots"
        out[key] = dict(ms=ms, host_ms=host, plain_ms=pl, steps=steps,
                        us_per_step=(ms - floor) / steps * 1e3,
                        shape=f"n={n}" + (f", k={k}" if k else "") + f", {dt}",
                        library_ms=lib, latency_ms=lat,
                        ms_runs=runs["this"], baseline_ms=runs["baseline"],
                        **extra, **b)
        log(f"[time] {name} n={n}{f' k={k}' if k else ''} {dt}: kernel "
            f"{ms:.4f} ms "
            f"{f'(host {host:.4f})' if host else '(host clock, 3 calls)'}"
            f", runs {[round(x, 4) for x in runs['this']]}"
            + (f", baseline {[round(x, 4) for x in runs['baseline']]} ms "
               f"(turns: baseline, this, this, baseline; this "
               f"{min(runs['baseline']) / max(runs['this']):.1f}x faster "
               f"at least)" if baseline else "")
            + f"; plain {pl:.2f} ms; bound {b['bound_ms'] * 1e3:.3f} us "
            f"({b['bound_by']}); latency bound {lat:.4f} ms ({steps} "
            f"dependent {step} of one thread), kernel {ms / lat:.2f}x it; "
            f"{out[key]['us_per_step']:.3f} us per {step[:-1]} above the "
            f"launch floor {floor:.4f} ms; {lib_text}")
    return out


@contextlib.contextmanager
def counted_event_waits():
    """Counts ``torch.cuda.Event.synchronize`` calls while active."""
    real = torch.cuda.Event.synchronize
    n = [0]

    def wait(self):
        n[0] += 1
        return real(self)

    torch.cuda.Event.synchronize = wait
    try:
        yield n
    finally:
        torch.cuda.Event.synchronize = real


@contextlib.contextmanager
def kept_telemetry(sess):
    """Every frame's telemetry dict (copies) while active."""
    import copy

    teles = []
    real = sess._post_frame

    def post(rec, tele):
        teles.append(copy.deepcopy(tele))
        return real(rec, tele)

    sess._post_frame = post
    try:
        yield teles
    finally:
        del sess._post_frame


TELE_DISCRETE = ("n_map", "n_visible", "n_matched", "redirected", "health",
                 "repairs", "lm_lid", "lm_active", "lm_matched")


def telemetry_differ(a: list, b: list) -> Tuple[list, dict]:
    """Discrete telemetry fields that differ between two runs' frames, and
    the max |diff| of each float field."""
    if len(a) != len(b):
        return [f"{len(a)} vs {len(b)} frames"], {}
    discrete = sorted({key for x, y in zip(a, b) for key in TELE_DISCRETE
                       if not np.array_equal(x[key], y[key])})
    floats = {}
    for key in ("pose", "pose_sqrt_cov", "lm_match_px", "lm_xyz"):
        d = max(float(np.abs(np.asarray(x[key], np.float64)
                             - np.asarray(y[key], np.float64)).max())
                for x, y in zip(a, b))
        if d:
            floats[key] = d
    return discrete, floats


def step_graph_config1(dev) -> dict:
    """(b) Config 1 through ``step()``: 48 frames of ``bench1_arc`` from one
    state by the graph route and by the eager route (23 steps, one chunk of
    8, 17 steps: a chunk graph captured and replayed between step
    replays); telemetry and final state compared; every step replay after
    the first under ``set_sync_debug_mode("error")`` with its event waits
    counted; the fused kernel once per frame; then frames/s of
    ``run(chunk=1)`` by both routes on the same 24 frames (graph, eager,
    eager, graph)."""
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.io import fixtures
    from cv_monoslam_tpu_torch.ops import control

    seq, track, _, _ = fixtures.load("bench1_arc")
    sess = SlamSession(SlamConfig(**CONFIG1), seq, track, device=dev)
    c0, s0 = sess.counter, control.tree_map(torch.clone, sess.state)
    runs = {}
    for route in ("graph", "eager"):
        sess._graphs = route == "graph"
        sess.state = control.tree_map(torch.clone, s0)
        sess.counter, sess._last_matched = c0, 0
        waits, guarded = 0, 0
        torch.cuda.synchronize()
        reset_counters(dev)
        with kept_telemetry(sess) as teles:
            for i in range(41):
                if i == 23:
                    sess.step_chunk(8)          # a chunk between steps
                    continue
                if route == "eager" or i == 0:  # 0: the capture
                    sess.step()
                    continue
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    with counted_event_waits() as n:
                        sess.step()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                waits += n[0]
                guarded += 1
        torch.cuda.synchronize()
        runs[route] = dict(teles=teles, counts=read_counters(dev),
                           state=control.tree_map(torch.clone, sess.state),
                           waits=waits, guarded=guarded)
    sess._graphs = True
    g, e = runs["graph"], runs["eager"]
    tele_d, tele_f = telemetry_differ(g["teles"], e["teles"])
    st_d, st_f = state_equal(g["state"], e["state"])
    problems = []
    for route, r in runs.items():
        problems += launch_problems(r["counts"], 48, f"config 1 by step() "
                                    f"({route})", measure=48)
    capture = {("x".join(str(x) for x in key[:3])): v
               for key, v in sess.capture_s.items()}
    start = (c0, s0, 0)
    fps = routes_fps(sess, start, 1, 24)
    res = dict(frames=len(g["teles"]), telemetry_discrete_differ=tele_d,
               telemetry_float_max_diff=tele_f, state_discrete_differ=st_d,
               state_float_max_diff=st_f, guarded_steps=g["guarded"],
               event_waits=g["waits"], capture_s=capture, fps=fps,
               launches=launches(g["counts"]),
               launches_eager=launches(e["counts"]))
    log(f"[steps] (b) config 1, 48 frames by step() (23 steps, a chunk of "
        f"8, 17 steps): graph == eager in every discrete result "
        f"{not tele_d and not st_d} (telemetry floats {tele_f}, state floats "
        f"{st_f}); {g['guarded']} step replays under set_sync_debug_mode("
        f"'error'): no synchronizing call, {g['waits']} event waits; "
        f"launches by the graph route {res['launches']}; capture {capture} "
        f"s; run(chunk=1) frames/s graph {fps['graph']} eager "
        f"{fps['eager']}")
    if tele_d or st_d:
        problems.append(f"step graph != eager step in {tele_d + st_d}")
    if g["waits"] != g["guarded"]:
        problems.append(f"{g['waits']} event waits in {g['guarded']} steps")
    if problems:
        raise AssertionError("step graphs (b): " + "; ".join(problems))
    return res


def step_graph_redirect(dev) -> dict:
    """(c) Phase 6's forced redirect (frame 24 of ``bench1_arc``, config 1)
    through the step graph of the redirect branch and through the eager
    step, from one state: telemetry and state compared, both holding
    ``REDIRECT_JAX_CPU``; the redirect graph's second replay under
    ``set_sync_debug_mode("error")``."""
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.io import fixtures
    from cv_monoslam_tpu_torch.ops import control

    at = 24
    seq, track, _, _ = fixtures.load("bench1_arc")
    track.redirect[at] = True
    sess = SlamSession(SlamConfig(**CONFIG1), seq, track, device=dev)
    sess.run(n_frames=at - 1, chunk=8)
    c0, m0 = sess.counter, sess._last_matched
    s0 = control.tree_map(torch.clone, sess.state)
    runs = {}
    for route in ("graph", "eager"):
        sess._graphs = route == "graph"
        for rep in range(2 if route == "graph" else 1):
            sess.state = control.tree_map(torch.clone, s0)
            sess.counter, sess._last_matched = c0, m0
            torch.cuda.synchronize()
            with kept_telemetry(sess) as teles, \
                    contextlib.ExitStack() as stack:
                if rep:             # the replay after the capture
                    torch.cuda.set_sync_debug_mode("error")
                    stack.callback(torch.cuda.set_sync_debug_mode, "default")
                rec = sess.step()
        runs[route] = dict(
            teles=teles, state=control.tree_map(torch.clone, sess.state),
            got=dict(n_map=rec.n_map,
                     n_loop=int(sess.state.lm.is_loop.sum()),
                     stored_valid=int(sess.state.stored.valid.sum())),
            redirected=rec.redirected)
    sess._graphs = True
    g, e = runs["graph"], runs["eager"]
    tele_d, tele_f = telemetry_differ(g["teles"], e["teles"])
    st_d, st_f = state_equal(g["state"], e["state"])
    keys = [k for k in sess.capture_s if k[2]]
    res = dict(graph=g["got"], eager=e["got"], expected=REDIRECT_JAX_CPU,
               telemetry_discrete_differ=tele_d, telemetry_float_max_diff=tele_f,
               state_discrete_differ=st_d, state_float_max_diff=st_f,
               capture_s=[sess.capture_s[k] for k in keys])
    log(f"[steps] (c) forced redirect at frame {at} through the redirect "
        f"branch's step graph: {g['got']} (eager {e['got']}, JAX on a CPU "
        f"{REDIRECT_JAX_CPU}); graph == eager in every discrete result "
        f"{not tele_d and not st_d} (telemetry floats {tele_f}, state floats "
        f"{st_f}); its second replay under set_sync_debug_mode('error'): no "
        f"synchronizing call; capture {res['capture_s']} s")
    problems = []
    if len(keys) != 1 or not (g["redirected"] and e["redirected"]):
        problems.append(f"redirect graphs {keys}")
    if tele_d or st_d:
        problems.append(f"graph != eager in {tele_d + st_d}")
    for route, r in runs.items():
        if r["got"] != REDIRECT_JAX_CPU:
            problems.append(f"{route}: {r['got']} != {REDIRECT_JAX_CPU}")
    if problems:
        raise AssertionError("step graphs (c): " + "; ".join(problems))
    return res


@contextlib.contextmanager
def recorded_updates(kept: list, matched: list, n: int = 3):
    """While active: the matched slots each ``kalman_update`` sees (one host
    read each, eager only) and the arguments of the first ``n`` calls of
    the two linalg kernels by the sequential update (copies)."""
    from cv_monoslam_tpu_torch.filter import srukf, update

    real_update = srukf.kalman_update
    real_down, real_gmw = update.chol_downdate, update.gmw_chol

    def kalman(state, cache, cfg):
        matched.append(int(state.lm.matched.sum()))
        return real_update(state, cache, cfg)

    def keep(name, args):
        if sum(k == name for k, _ in kept) < n:
            kept.append((name, args))

    def down(r, u, *a):
        keep("rank_rotate", (r.clone(), u.clone(), True))
        return real_down(r, u, *a)

    def gmw(a):
        keep("gmw_chol", (a.clone(),))
        return real_gmw(a)

    with patched(srukf, "kalman_update", kalman), \
            patched(update, "chol_downdate", down), \
            patched(update, "gmw_chol", gmw):
        yield


def step_graph_modes(dev, errs: dict) -> dict:
    """(d) Each update / QR mode of :data:`MODES` at the config-1 widths:
    the first window of 8 frames, once more after its capture, by the
    chunk graph and by the eager route from one state (:func:`graph_vs_eager`: every discrete result equal, the
    dispatch under ``set_sync_debug_mode("error")``), each linalg kernel's
    launches in the graph's window equal to the matched slots of its frames
    times the mode's count per slot (read on the device; the slots from the
    eager run of the same window); capture seconds and the pools' reserve;
    both kernels against their plain versions on arguments kept from the
    eager runs."""
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.io import fixtures

    from cv_monoslam_tpu_torch.ops import control

    seq, track, _, _ = fixtures.load("bench1_arc")
    out, kept, problems = {}, [], []
    for name, kw, per_slot in MODES:
        sess = SlamSession(SlamConfig(**{**CONFIG1, **kw}), seq, track,
                           device=dev)
        # the first window, where the sequential modes still match most
        # landmarks (in float32 they lose most matches from frame 5 on)
        c0, s0 = sess.counter, control.tree_map(torch.clone, sess.state)
        sess.step_chunk(8)                      # captures (8, detect)
        sess.state, sess.counter = s0, c0
        sess._last_matched = 0
        matched, kept_mode = [], []
        r, _ = graph_vs_eager(
            sess, 8, name,
            eager_ctx=lambda: recorded_updates(kept_mode, matched))
        kept += kept_mode
        counts = r["launches"]
        want = {k: sum(matched) * per_slot[k] for k in LINALG_KERNELS}
        got = {k: counts[k] for k in LINALG_KERNELS}
        fp = pool_footprint(sess)
        out[name] = dict(graph_vs_eager=r, matched_slots=sum(matched),
                         launches=got, expected=want,
                         capture_s=list(sess.capture_s.values()),
                         footprint=fp)
        log(f"[steps] (d) {name}: graph == eager rows {r['rows_equal']} "
            f"(max |diff| {r['rows_max_abs_diff']:.3e}), state "
            f"{r['state_equal']} {r['state_float_max_diff'] or ''}; dispatch "
            f"under set_sync_debug_mode('error'): no synchronizing call; "
            f"{sum(matched)} matched slots in the window, linalg launches "
            f"{got} (want {want}), fused {counts['warp_ncc_score_map']}; "
            f"capture {out[name]['capture_s']} s; reserved: graph pool "
            f"{fp['graph_pool'] / 2**20:.1f} MiB, body pool "
            f"{fp['body_pool'] / 2**20:.1f} MiB")
        if got != want or counts["warp_ncc_score_map"] != 8:
            problems.append(f"{name}: launches {got} (want {want}), fused "
                            f"{counts['warp_ncc_score_map']} in 8 frames")
    for i, (name, args) in enumerate(kept):
        check_linalg(name, args, f"captured {i} (n={args[0].shape[0]}, "
                     f"{args[0].dtype})", errs)
    if {name for name, _ in kept} != set(LINALG_KERNELS):
        problems.append(f"kept arguments of {[n for n, _ in kept]}")
    if problems:
        raise AssertionError("step graphs (d): " + "; ".join(problems))
    return out


def phase_step_graphs(dev, errs: dict, floor: float,
                      baseline=None) -> dict:
    """Phase 3c: (a) the two linalg kernels against their plain versions on
    seeded inputs, exactly, and their times; (b) config 1 through step
    graphs; (c) the redirect branch as a graph; (d) every update / QR
    mode by the chunk graphs."""
    errs.setdefault("rank_rotate", 0.0)
    errs.setdefault("gmw_chol", 0.0)
    plain_large = seeded_linalg_checks(dev, errs)
    out = dict(times=linalg_times(dev, floor, plain_large, baseline))
    out["b"] = step_graph_config1(dev)
    out["c"] = step_graph_redirect(dev)
    out["d"] = step_graph_modes(dev, errs)
    return out


def phase_slice(dev, errs: dict) -> dict:
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.io import fixtures

    chunk = 32
    seq, track, gt_xy, _ = fixtures.load("bench1_arc")
    cfg = SlamConfig(**CONFIG1)

    reset_counters(dev)
    with captured_kernel_inputs() as captured:
        sess = SlamSession(cfg, seq, track, device=dev)
        sess.step_chunk(chunk)                    # warm-up chunk
    torch.cuda.synchronize()
    warm = read_counters(dev)
    t0 = time.perf_counter()
    n0 = len(sess.records)
    sess.run(chunk=chunk)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counters(dev)
    timed_launches = {k: counts[k] - warm[k]
                      for k in KERNELS + MEASURE_KERNELS}

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
               skipped=recs[-1].n_skipped, launches=launches(counts),
               timed_launches=timed_launches,
               plain_normalizations=counts["plain_normalizations"])
    log("[slice] " + json.dumps(res))

    check_captured(captured, errs, "on a fixture frame", cfg.max_landmarks)

    problems = launch_problems(counts, len(recs), "config 1",
                               measure=len(recs))
    if not counts["gftt_greedy_nms"]:
        problems.append("the greedy separation kernel never launched")
    if not np.all(np.isfinite(traj)):
        problems.append("non-finite poses")
    for name, n in timed_launches.items():
        if n != (n_timed if name in ("warp_ncc_score_map",)
                 + MEASURE_KERNELS else 0):
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


def config3_session(dev, chunk: int, **extra):
    """A config-3 session warmed up as ``bench.py`` warms it: a detect chunk,
    then a chunk with the gate forced shut (so both variants have run), then
    the gate opened to the telemetry and set to the one-chunk-stale
    cadence. ``extra`` overrides config fields."""
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.io import fixtures

    seq, track, gt_xy, _ = fixtures.load("bench3_grid", min_step_xy=0.005)
    cfg = SlamConfig(**CONFIG3, **extra)
    sess = SlamSession(cfg, seq, track, device=dev)
    sess.detect_host_gate = True
    sess.step_chunk(chunk)
    sess._last_matched = cfg.min_num
    sess.step_chunk(chunk)
    sess._last_matched = sess.records[-1].n_matched
    sess.detect_gate_margin = 0
    return sess, gt_xy


def phase_config3(dev, errs: dict, tag: str = "config3",
                  check: bool = True, **extra) -> dict:
    """Config 3 at full width; ``extra`` overrides config fields (the
    multi-device phase runs it with ``dist_chol_panel`` under a mesh).
    ``check=False`` returns the failed checks as ``problems`` instead of
    raising (a rank of ``--ranks`` reports them with its float64 witness
    beside them). The result also holds :func:`run_digest` of the run."""
    chunk, n_timed = 8, 64
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(dev)
    with captured_kernel_inputs(armed=False) as captured:
        t_setup = time.perf_counter()
        sess, gt_xy = config3_session(dev, chunk, **extra)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_setup
        n0 = len(sess.records)
        captured.arm()          # the timed run's first frames
        t0 = time.perf_counter()
        sess.run(n_frames=n_timed, chunk=chunk, drop_tail=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = read_counters(dev)
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
        launches=launches(counts),
        plain_normalizations=counts["plain_normalizations"],
        n_matched=[r.n_matched for r in recs],
        jax_cpu_float32=CONFIG3_JAX_CPU, **extra)
    log(f"[{tag}] " + json.dumps(res))
    log(f"[{tag}] M=576 D=3460 bench3_grid float32: {res['fps']:.2f} "
        f"frames/s, {res['ms_per_frame']:.2f} ms/frame over {done} frames; "
        f"peak map {res['peak_map']}, peak matched {res['peak_matched']}; "
        f"ATE {res['ate_m']:.5f} m; repairs {res['repairs']} minor / "
        f"{res['escalations']} escalated / {res['skipped']} skipped; "
        f"max_memory_allocated {peak_bytes / 2**20:.0f} MiB; chunks with / "
        f"without detection {res['chunks_with_detection']} / "
        f"{res['chunks_without_detection']}")

    check_captured(captured, errs, "on a config-3 frame",
                   sess.cfg.max_landmarks)

    problems = launch_problems(counts, len(recs), "config 3", measure=0)
    problems += [f"{name} never launched" for name in SCAN_KERNELS
                 if not counts[name]]
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
    if problems and check:
        raise AssertionError(f"{tag} checks failed: " + "; ".join(problems))
    res["problems"] = problems
    res["digest"] = run_digest(sess)
    return res


def run_digest(sess) -> dict:
    """sha256 of a session's records (every field but the wall time), of
    its trajectory and of each field of its state: ranks that hold the
    same run bit for bit give the same digests."""
    import hashlib

    from cv_monoslam_tpu_torch.convert import state_to_arrays

    def sha(*parts) -> str:
        h = hashlib.sha256()
        for p in parts:
            h.update(np.ascontiguousarray(p).tobytes())
        return h.hexdigest()[:16]

    recs = [sha(np.asarray([r.frame, r.n_map, r.n_visible, r.n_matched,
                            r.redirected, r.n_repairs, r.n_escalations,
                            r.n_skipped], np.int64), r.pose, r.pose_sqrt_cov)
            for r in sess.records]
    return dict(records=sha(np.frombuffer("".join(recs).encode(), np.uint8)),
                trajectory=sha(sess.trajectory),
                state={k: sha(v) for k, v in
                       state_to_arrays(sess.state).items()})


def phase_redirect(dev) -> dict:
    """Config 1 on the first 48 frames of bench1_arc with a redirection
    forced at frame 24 (no committed fixture holds one)."""
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.io import fixtures

    at, n_frames = 24, 48
    seq, track, _, _ = fixtures.load("bench1_arc")
    track.redirect[at] = True
    reset_counters(dev)
    sess = SlamSession(SlamConfig(**CONFIG1), seq, track, device=dev)
    sess.run(n_frames=at - 1, chunk=8)
    rec = sess.step()
    got = dict(n_map=rec.n_map, n_loop=int(sess.state.lm.is_loop.sum()),
               stored_valid=int(sess.state.stored.valid.sum()))
    sess.run(n_frames=n_frames - at, chunk=8)
    torch.cuda.synchronize()
    counts = read_counters(dev)
    recs = sess.records
    after = [r.n_matched for r in recs[at:]]
    res = dict(frames=len(recs), redirect_frame=rec.frame,
               redirected=[r.frame for r in recs if r.redirected],
               matched_mean_after=float(np.mean(after)), **got,
               expected=REDIRECT_JAX_CPU,
               launches=launches(counts))
    log("[redirect] " + json.dumps(res))
    # the redirect frame itself tracks nothing: no kernel runs on it
    problems = launch_problems(counts, n_frames - 1, "the redirect run",
                               measure=n_frames - 1)
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


def replay_route(calls, cfg, dev, graphs: bool) -> dict:
    """(c) The captured telemetry replayed through a ``BackendSession`` by
    one route (``_graphs``): the backend, its refinement dicts, the
    keyframe poses after every solve, each solve's wall ms (host clock,
    synchronized at both ends) and event waits. On the graph route every
    call after the capture stages and replays under
    ``set_sync_debug_mode("error")``."""
    from cv_monoslam_tpu_torch.backend.replay import replay
    from cv_monoslam_tpu_torch.backend.session import BackendSession

    poses_after, waits = [], [0]
    ms = {"refine_window": [], "optimize_graph": []}
    real = {name: getattr(BackendSession, name)
            for name in (*ms, "_dispatch_window")}
    real_wait = torch.cuda.Event.synchronize

    def timed(name):
        def call(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](self, *a, **kw)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            poses_after.append(np.stack([k.pose for k in self.keyframes]))
            return out
        return call

    def dispatch(self, arrays):
        if not (graphs and self._window_graphs):    # a capture syncs
            return real["_dispatch_window"](self, arrays)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real["_dispatch_window"](self, arrays)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def wait(event):
        waits[0] += 1
        return real_wait(event)

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(BackendSession, "_graphs", graphs))
        stack.enter_context(patched(BackendSession, "_dispatch_window",
                                    dispatch))
        stack.enter_context(patched(torch.cuda.Event, "synchronize", wait))
        for name in ms:
            stack.enter_context(patched(BackendSession, name, timed(name)))
        be, refs = replay(calls, cfg, device=dev)
    return dict(backend=be, refinements=refs, poses_after=poses_after,
                ms=ms, event_waits=waits[0])


def refinements_differ(a: list, b: list) -> list:
    """Where two lists of refinement dicts differ at all (exact, NaN equal
    to NaN), by call and field."""
    if len(a) != len(b):
        return [f"{len(a)} / {len(b)} solves"]
    diffs = []
    for i, (ra, rb) in enumerate(zip(a, b)):
        if sorted(ra) != sorted(rb):
            diffs.append(f"solve {i}: fields {sorted(ra)} / {sorted(rb)}")
            continue
        for key in ra:
            x, y = np.asarray(ra[key]), np.asarray(rb[key])
            same = (np.array_equal(x, y, equal_nan=True)
                    if x.dtype.kind == "f" else np.array_equal(x, y))
            if not same:
                d = (f" (max |diff| "
                     f"{float(np.nanmax(np.abs(x - y))):.3e})"
                     if x.dtype.kind == "f" else "")
                diffs.append(f"solve {i}: {key}{d}")
    return diffs


def ms_stats(v: list) -> dict:
    return (dict(calls=len(v), mean=float(np.mean(v)),
                 median=float(np.median(v)), first=v[0], max=max(v),
                 total=float(sum(v))) if v else dict(calls=0))


def singular_checks(live, cfg, dev) -> dict:
    """(d) Singular systems on the card: ``ba_solve`` on a window with its
    last landmark slot filled but unobserved and ``pose_graph_solve`` with a
    node no edge touches, both undamped, must give non-finite results, not
    raise; ``refine_window`` / ``optimize_graph`` on the live run's
    keyframes with their solvers made singular in the same way must report
    ``applied`` False and keep every keyframe pose (gate 0, where the
    unwrapped window solve applies)."""
    import copy
    import dataclasses

    from cv_monoslam_tpu_torch.backend import ba, pose_graph
    from cv_monoslam_tpu_torch.backend import session as sess_mod

    def last_set(mask):
        return torch.cat([mask[:-1], torch.ones_like(mask[-1:])])

    def ba_singular(prob, cfg_, **kw):
        prob = dataclasses.replace(prob, lm_mask=last_set(prob.lm_mask))
        return ba.ba_solve(prob, cfg_, damping=0.0, **kw)

    def graph_singular(g, **kw):
        g = dataclasses.replace(g, node_mask=last_set(g.node_mask))
        return pose_graph.pose_graph_solve(g, damping=0.0, **kw)

    gate0 = dataclasses.replace(cfg, ba_apply_gate=0.0)

    def backend():
        be = sess_mod.BackendSession(gate0, max_lms=96, device=dev)
        be.keyframes = copy.deepcopy(live.keyframes)
        return be

    res, problems = {}, []
    plain = backend()
    res["plain_applied"] = plain.refine_window()["applied"]
    with patched(sess_mod, "ba_solve", ba_singular), \
            patched(sess_mod, "pose_graph_solve", graph_singular):
        prob = plain.window_problem()
        poses, lms, costs = sess_mod.ba_solve(prob, gate0)
        g = plain.graph()
        nodes, gcosts = sess_mod.pose_graph_solve(g)
        res["ba_solve_finite"] = bool(torch.isfinite(poses).all())
        res["pose_graph_solve_finite"] = bool(torch.isfinite(nodes).all())
        for name in ("refine_window", "optimize_graph"):
            be = backend()
            before = np.stack([k.pose for k in be.keyframes])
            out = getattr(be, name)()
            kept = np.array_equal(before,
                                  np.stack([k.pose for k in be.keyframes]))
            res[name] = dict(
                finite=bool(np.isfinite(out["poses" if name ==
                                            "refine_window" else
                                            "nodes"]).all()),
                applied=out.get("applied"), poses_kept=kept,
                graph_route=bool(be._window_graphs))
            if not kept or out.get("applied") or res[name]["finite"]:
                problems.append(f"{name} on a singular system: {res[name]}")
    if res["ba_solve_finite"] or res["pose_graph_solve_finite"]:
        problems.append("a singular solve gave finite values")
    if res["plain_applied"] is not True:
        problems.append("the unwrapped window solve did not apply at gate 0")
    log("[config4] (d) singular systems " + json.dumps(res))
    if problems:
        raise AssertionError("; ".join(problems))
    return res


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
        reset_counters(dev)
        sess = SlamSession(cfg, seq, track, backend=backend, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.run(chunk=chunk)
        torch.cuda.synchronize()
        return sess, time.perf_counter() - t0, read_counters(dev)

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

    # (c) the replay by the graph route and by the eager route
    routes = {name: replay_route(cap.calls, cfg, dev, name == "graph")
              for name in ("graph", "eager")}
    rg, re_ = routes["graph"], routes["eager"]
    route_diffs = refinements_differ(rg["refinements"], re_["refinements"])
    if len(rg["poses_after"]) != len(re_["poses_after"]) or any(
            not np.array_equal(a, b)
            for a, b in zip(rg["poses_after"], re_["poses_after"])):
        route_diffs.append("keyframe poses after a solve")
    be_graph = rg["backend"]
    backend_graphs = dict(
        capture_s=[round(v, 4) for v in be_graph.capture_s.values()],
        graphs=len(be_graph._window_graphs),
        pool_reserved_mib=(pool_reserved(be_graph._pool) / 2**20
                           if be_graph._pool is not None else 0.0),
        event_waits=dict(graph=rg["event_waits"],
                         eager=re_["event_waits"]),
        solves=len(rg["refinements"]),
        equal=not route_diffs, differ=route_diffs,
        ms={name: {k: ms_stats(v) for k, v in r["ms"].items()}
            for name, r in routes.items()})
    log("[config4] (c) backend graph vs eager " + json.dumps(backend_graphs))
    for name, r in routes.items():
        for solver, v in r["ms"].items():
            if v:
                log(f"[config4] (c) {name} route {solver} [{smi}]: "
                    f"{len(v)} calls, mean {np.mean(v):.3f} ms, median "
                    f"{np.median(v):.3f} ms, first {v[0]:.3f} ms, max "
                    f"{max(v):.3f} ms, total {sum(v):.1f} ms")
    log(f"[config4] (c) graph route: capture {backend_graphs['capture_s']} "
        f"s, pool {backend_graphs['pool_reserved_mib']:.1f} MiB reserved; "
        f"staging + replay under set_sync_debug_mode('error') on "
        f"{len(rg['ms']['refine_window']) - 1} calls; event waits "
        f"{rg['event_waits']} for {len(rg['refinements'])} solves; graph "
        f"== eager: {not route_diffs} {route_diffs if route_diffs else ''}")
    singular = singular_checks(live, cfg, dev)

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
        live_capture_s=list(live.capture_s.values()),
        backend_graphs=backend_graphs, singular=singular,
        launches=launches(counts_b),
        launches_capture_run=launches(counts_a),
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
    problems += [f"backend graph route != eager route: {d}"
                 for d in route_diffs]
    if not live._window_graphs or len(be_graph._window_graphs) != 1:
        problems.append("the window solves did not run as one graph")
    if rg["event_waits"] != len(rg["refinements"]):
        problems.append(f"{rg['event_waits']} event waits for "
                        f"{len(rg['refinements'])} solves")
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


def _match_sets(state) -> Tuple[list, list]:
    lm = state.lm
    act, lid, mt = (v.cpu().numpy() for v in (lm.active, lm.lid, lm.matched))
    return (sorted(int(l) for l, a in zip(lid, act) if a),
            sorted(int(l) for l, a, m in zip(lid, act, mt) if a and m))


def _oracle_sets(oracle) -> Tuple[list, list]:
    return (sorted(l.lid for l in oracle.landmarks),
            sorted(l.lid for l in oracle.landmarks if l.matched))


def first_update_posterior(state, oracle) -> dict:
    """max |x - oracle| and max |P - oracle| (P = S^T S) over the oracle's
    landmark rows and the robot's."""
    act, lid, ex, eS = (v.cpu().numpy() for v in (
        state.lm.active, state.lm.lid, state.x, state.S))
    rows = []
    for ol in oracle.landmarks:
        s = int(np.flatnonzero(act & (lid == ol.lid))[0])
        rows += list(range(6 * s, 6 * s + 6))
    rows = np.asarray(rows + [len(ex) - 4 + i for i in range(4)])
    return dict(first_update_dx=float(np.abs(ex[rows] - oracle.x).max()),
                first_update_dP=float(np.abs((eS.T @ eS)[np.ix_(rows, rows)]
                                             - oracle.S.T @ oracle.S).max()))


def phase_reference(dev, smi: str, baseline=None) -> dict:
    """The port on the card against the port's ``OracleSLAM`` (the serial
    NumPy transcription of the reference, on the host): (R1) faithful mode
    in float64 over the prefix windows and the first-update posterior;
    (R2) default mode in float32 with the fused kernel over 67 frames, ATE
    band; (R3) faithful mode, 50 frames, match-set statistics. Faithful
    runs take the plain vision versions (``vision_backend="xla"``): the
    kernels take float32. With ``baseline`` (:func:`load_baseline`), R3's
    50 frames again by step graphs, without the oracle, with that
    checkout's ``gmw_chol`` and this tree's in turns (baseline, this, this,
    baseline): frames/s of each, match sets against the first R3 run."""
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.io.synthetic import get_sequence
    from cv_monoslam_tpu_torch.models.oracle import OracleSLAM

    t0 = time.perf_counter()
    # the arc sequence's trajectory and frames are prefixes of each other
    # for every n, so 68 frames serve the 18-, 60- and 68-frame cases of
    # the CPU tests
    seqs = {"straight": get_sequence("straight", 18, 0),
            "arc": get_sequence("arc", 68, 0)}
    res = dict(render_s=time.perf_counter() - t0, oracle_s=0.0)
    faithful = SlamConfig(**FAITHFUL, vision_backend="xla")
    problems = []

    def pair(kind, cfg, oracle_cfg=None):
        seq, track, gt_xy, _ = seqs[kind]
        t = time.perf_counter()
        oracle = OracleSLAM(oracle_cfg or cfg, seq, track)
        res["oracle_s"] += time.perf_counter() - t
        return oracle, SlamSession(cfg, seq, track, device=dev), track, gt_xy

    def oracle_step(oracle):
        t = time.perf_counter()
        oracle.step()
        res["oracle_s"] += time.perf_counter() - t

    # (R1) prefix windows: maps and match sets equal on every frame, pose
    # within 1e-6 (the card's float64 BLAS / solver round otherwise than
    # the CPU's LAPACK; the CPU test keeps 1e-9 for arc); after the first
    # straight frame, the posterior over the oracle's landmark rows
    for kind, n in (("straight", 3), ("arc", 2)):
        oracle, sess, _, _ = pair(kind, faithful)
        if _oracle_sets(oracle)[0] != _match_sets(sess.state)[0]:
            problems.append(f"{kind}: initial maps differ")
        d = []
        for k in range(n):
            oracle_step(oracle)
            rec = sess.step()
            if _oracle_sets(oracle) != _match_sets(sess.state):
                problems.append(f"{kind} frame {k + 1}: maps or match sets "
                                f"differ")
            d.append(float(np.abs(np.asarray(rec.pose)
                                  - oracle.x[-4:]).max()))
            if kind == "straight" and k == 0:
                res.update(first_update_posterior(sess.state, oracle))
        res[f"{kind}_dpose"] = d
        if not max(d) <= 1e-6:
            problems.append(f"{kind}: |pose - oracle| {max(d)} > 1e-6")
    if not (res["first_update_dx"] <= 1e-10
            and res["first_update_dP"] <= 1e-9):
        problems.append(f"first-update posterior |dx| "
                        f"{res['first_update_dx']}, |dP| "
                        f"{res['first_update_dP']}")

    # (R2) default mode, float32, the fused kernel, M = 16: the ATE band
    oracle, sess, track, gt_xy = pair(
        "arc", SlamConfig(max_landmarks=16),
        SlamConfig(max_landmarks=16, dtype="float64"))
    while oracle.counter < len(track):
        oracle_step(oracle)
    otraj = np.stack(oracle.traj)
    ids = track.frame_id[1:len(otraj) + 1]
    res["ate_oracle"] = float(np.sqrt(((otraj[:, :2] - gt_xy[ids]) ** 2)
                                      .sum(1).mean()))
    reset_counters(dev)
    sess.run(chunk=32)
    torch.cuda.synchronize()
    counts = read_counters(dev)
    recs = sess.records
    res.update(ate_port=float(sess.ate(gt_xy)), frames=len(recs),
               escalations=recs[-1].n_escalations,
               skipped=recs[-1].n_skipped,
               launches=launches(counts))
    band = 1.2 * res["ate_oracle"] + 0.002
    problems += launch_problems(counts, len(recs), "(R2)")
    if len(recs) < 64 or not res["ate_port"] <= band:
        problems.append(f"(R2) ATE {res['ate_port']} over {len(recs)} "
                        f"frames, band {band}")
    if res["escalations"] or res["skipped"]:
        problems.append("(R2) escalated repairs or skipped updates")

    # (R3) faithful mode, 50 frames: match-set statistics, through the
    # step graphs (frames 2-50 timed: the first captures); then the same
    # frames by the eager route, timed alike, its match sets beside
    oracle, sess, _, _ = pair("arc", faithful)
    identical, jac, graph_sets = 0, [], []
    reset_counters(dev)
    port_s = 0.0
    for i in range(50):
        oracle_step(oracle)
        t = time.perf_counter()
        sess.step()
        port_s += (time.perf_counter() - t) * (i > 0)
        e = set(_match_sets(sess.state)[1])
        o = set(_oracle_sets(oracle)[1])
        graph_sets.append(e)
        identical += e == o
        jac.append(len(e & o) / len(e | o) if e | o else 1.0)
    torch.cuda.synchronize()
    counts = read_counters(dev)
    res["launches_faithful"] = counts
    res.update(identical=identical, jaccard=float(np.mean(jac)),
               r3_fps_graph=49 / port_s,
               r3_step_graphs=sorted(str(k[:3]) for k in sess._chunk_steps))
    if not (identical >= 25 and res["jaccard"] >= 0.55):
        problems.append(f"(R3) {identical}/50 identical, mean Jaccard "
                        f"{res['jaccard']}")
    if not any(k[0] == 1 for k in sess._chunk_steps) or not counts[
            "gmw_chol"] or counts["rank_rotate"]:
        problems.append(f"(R3) step graphs {res['r3_step_graphs']}, "
                        f"launches {counts}")
    seq, track, _, _ = seqs["arc"]
    eager = SlamSession(faithful, seq, track, device=dev)
    eager._graphs = False
    port_s, same, matched = 0.0, 0, []
    with recorded_updates([], matched, n=0):
        for i in range(50):
            t = time.perf_counter()
            eager.step()
            port_s += (time.perf_counter() - t) * (i > 0)
            same += set(_match_sets(eager.state)[1]) == graph_sets[i]
    res.update(r3_fps_eager=49 / port_s, r3_eager_same_sets=same,
               r3_matched_slots=sum(matched))
    if baseline is not None:
        from cv_monoslam_tpu_torch.filter import update

        ab = {"baseline": [], "this": []}
        for who in ("baseline", "this", "this", "baseline"):
            fn = baseline.linalg.gmw_chol if who == "baseline" \
                else update.gmw_chol
            with patched(update, "gmw_chol", fn):
                s_ab = SlamSession(faithful, seq, track, device=dev)
                port_s, same = 0.0, 0
                for i in range(50):
                    t = time.perf_counter()
                    s_ab.step()
                    port_s += (time.perf_counter() - t) * (i > 0)
                    same += set(_match_sets(s_ab.state)[1]) == graph_sets[i]
            ab[who].append(49 / port_s)
            if same != 50:
                problems.append(f"(R3 A/B) {who}: match sets equal to the "
                                f"first run's on {same}/50 frames")
        res["r3_ab_fps"] = ab
        log(f"[reference] [{smi}] (R3 A/B) faithful mode by step graphs, "
            f"frames/s in turns (baseline, this, this, baseline): this "
            f"{[round(x, 2) for x in ab['this']]}, baseline "
            f"{[round(x, 2) for x in ab['baseline']]}")
    if same == 50 and counts["gmw_chol"] != 2 * sum(matched):
        problems.append(f"(R3) gmw_chol launched {counts['gmw_chol']} "
                        f"times by the step graphs for {sum(matched)} "
                        f"matched slots")
    res["seconds"] = time.perf_counter() - t0

    log("[reference] " + json.dumps(res))
    cpu = PARITY_CPU
    log(f"[reference] [{smi}] (R3) faithful mode by step graphs "
        f"{res['r3_fps_graph']:.2f} frames/s, eager "
        f"{res['r3_fps_eager']:.2f} frames/s (frames 2-50); eager match "
        f"sets equal to the graph's on {res['r3_eager_same_sets']}/50 "
        f"frames; {res['r3_matched_slots']} matched slots updated (eager "
        f"run); launches {res['launches_faithful']}")
    log(f"[reference] [{smi}] (R1) max|pose - oracle|: straight "
        f"{max(res['straight_dpose']):.3e} (CPU {cpu['straight_dpose']:.1e}),"
        f" arc {max(res['arc_dpose']):.3e} (CPU {cpu['arc_dpose']:.1e}); "
        f"first update |dx| {res['first_update_dx']:.3e}, |dP| "
        f"{res['first_update_dP']:.3e}; (R2) float32 + kernels ATE "
        f"{res['ate_port']:.6f} m vs oracle {res['ate_oracle']:.6f} m over "
        f"{res['frames']} frames; (R3) {identical}/50 identical match sets "
        f"(CPU {cpu['identical']}/50), mean Jaccard {res['jaccard']:.3f} "
        f"(CPU {cpu['jaccard']:.3f}); oracle {res['oracle_s']:.1f} s, "
        f"rendering {res['render_s']:.1f} s")
    if problems:
        raise AssertionError("reference checks failed: " + "; ".join(problems))
    return res


@contextlib.contextmanager
def kept_dist_chol_matrix():
    """While active, keep a copy of the matrix of the first call of the
    distributed factorization (``parallel.dist_chol.chol_rowsharded_padded``,
    which the filter's joint update imports at each call). Eager only: a
    copy made inside a capture would hold the latest replay's values."""
    from cv_monoslam_tpu_torch.parallel import dist_chol

    kept = []
    real = dist_chol.chol_rowsharded_padded

    def keep(A, mesh, panel=64):
        if not kept:
            kept.append(A.clone())
        return real(A, mesh, panel)

    dist_chol.chol_rowsharded_padded = keep
    try:
        yield kept
    finally:
        dist_chol.chol_rowsharded_padded = real


def no_sync(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: a
    synchronizing CUDA call in it raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def config5_problem(dev):
    """``scripts/bench_scaling.py``'s config-5 window-BA problem (W = 8
    keyframes, L = 32768 ceiling landmarks, float64), made with numpy from
    seed 0 and the port's ``project_planar`` on the card."""
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.backend.ba import BAProblem, project_planar

    W, L = CONFIG5["W"], CONFIG5["L"]
    rng = np.random.default_rng(0)
    cfg = SlamConfig(dtype="float64")
    poses_gt = np.stack([0.05 * np.arange(W), 0.01 * np.arange(W),
                         0.02 * np.arange(W)], axis=1)
    lms = np.stack([rng.uniform(-0.8, 1.2, L), rng.uniform(-0.6, 0.8, L),
                    np.full(L, 3.0)], axis=1)
    obs = project_planar(torch.as_tensor(poses_gt, device=dev)[:, None],
                         torch.as_tensor(lms, device=dev)[None],
                         cfg).cpu().numpy()
    mask = ((obs[..., 0] > 20) & (obs[..., 0] < 620)
            & (obs[..., 1] > 20) & (obs[..., 1] < 460))
    obs = obs + rng.normal(0, 0.3, obs.shape)
    odo_rel = np.zeros((W - 1, 3))
    for w in range(W - 1):
        c, s = np.cos(poses_gt[w, 2]), np.sin(poses_gt[w, 2])
        d = poses_gt[w + 1, :2] - poses_gt[w, :2]
        odo_rel[w] = [c * d[0] + s * d[1], -s * d[0] + c * d[1],
                      poses_gt[w + 1, 2] - poses_gt[w, 2]]
    poses0 = poses_gt + rng.normal(0, 0.01, poses_gt.shape)
    poses0[0] = poses_gt[0]
    landmarks = lms + rng.normal(0, 0.01, lms.shape)

    def t(a):
        return torch.as_tensor(a, device=dev)

    prob = BAProblem(poses=t(poses0), landmarks=t(landmarks), obs=t(obs),
                     obs_mask=t(mask), odo_rel=t(odo_rel),
                     kf_mask=t(np.ones(W, bool)),
                     lm_mask=t(mask.sum(0) >= 2), prior_poses=t(poses0),
                     prior_iw=t(np.full((W, 3), 1e-6)))
    return prob, cfg


def md_probe(mesh) -> dict:
    """(probe) NCCL collectives inside a conditional body: an
    ``all_reduce``, a ``broadcast`` and an ``all_gather`` inside a
    ``control.if_`` body (at nesting depth 1, and at depth 2 inside an
    outer body that is always taken), warmed up on the body streams,
    captured into one CUDA graph and replayed with the predicate true,
    false and true again, on new operands each time. Taken, every output
    must hold the collective's result; not taken, its sentinel. Returns the
    outcome per depth ("captured" or the error)."""
    from cv_monoslam_tpu_torch.ops import control

    dev, n = mesh.device, 4096
    x = torch.zeros(n, device=dev)
    red, bc = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    gat = torch.zeros(mesh.size * n, device=dev)
    pred = torch.zeros((), dtype=torch.bool, device=dev)
    outer = torch.ones((), dtype=torch.bool, device=dev)

    def body():
        red.copy_(2 * x)
        mesh.all_reduce(red)
        bc.copy_(x + 1)
        mesh.broadcast(bc, 0)
        gat.copy_(mesh.all_gather(3 * x))

    out, body_pool = {}, torch.cuda.MemPool()
    for depth in (1, 2):
        def region():
            if depth == 1:
                control.if_(pred, body)
            else:
                control.if_(outer, lambda: control.if_(pred, body))

        try:
            side = control.capture_stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side), control.warmup():
                region()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side), \
                    control.capture(body_pool):
                region()
            wrong = []
            for i, taken in enumerate((True, False, True)):
                x.copy_(torch.arange(n, device=dev) * (0.5 + i))
                for t in (red, bc, gat):
                    t.fill_(-1.0)
                pred.fill_(taken)
                graph.replay()
                torch.cuda.synchronize()
                want = ((2 * mesh.size * x, x + 1, (3 * x).repeat(mesh.size))
                        if taken else (-torch.ones_like(red),) * 2
                        + (-torch.ones_like(gat),))
                wrong += [f"{name} (taken={taken})" for name, got, w in
                          zip(("all_reduce", "broadcast", "all_gather"),
                              (red, bc, gat), want)
                          if not torch.equal(got, w)]
            out[depth] = ("captured" if not wrong
                          else "captured, wrong values: " + ", ".join(wrong))
        except Exception as e:           # the outcome is what is reported
            out[depth] = f"{type(e).__name__}: {e}"
    log(f"[multidevice] (probe) NCCL collectives in a conditional body at "
        f"{mesh.size} rank(s): " + json.dumps(out))
    return out


def md_chol(mesh, A: torch.Tensor, smi: str, tag: str = "(a)") -> dict:
    """(a) The distributed factorization of a config-3 joint matrix (kept
    from an eager frame of (b)'s session) against ``cholesky_ex`` of the
    same matrix, and the times of both; the factorization eagerly and as
    one captured CUDA graph (collectives inside), bit for bit, its replay
    under ``set_sync_debug_mode("error")``."""
    from cv_monoslam_tpu_torch.ops import control
    from cv_monoslam_tpu_torch.parallel.dist_chol import \
        chol_rowsharded_padded

    A = 0.5 * (A + A.T)                  # both factorizations get this A
    n, panel = A.shape[0], 64
    r_dist = chol_rowsharded_padded(A, mesh, panel)
    t0 = time.perf_counter()
    graph, r_graph = control.capture_graph(
        lambda a: chol_rowsharded_padded(a, mesh, panel), (A,),
        torch.cuda.graph_pool_handle())
    no_sync(graph.replay)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    graph_equal = torch.equal(r_graph, r_dist)
    r_lib, info = torch.linalg.cholesky_ex(A, upper=True)
    r_64 = torch.linalg.cholesky(A.double(), upper=True)
    a_norm = float(torch.linalg.norm(A.double()))

    def backward(r):
        r = r.double()
        return float(torch.linalg.norm(r.T @ r - A.double())) / a_norm

    res = dict(n=n, n_padded=-(-n // panel) * panel, panel=panel,
               library_info=int(info),
               max_abs_diff=float((r_dist - r_lib).abs().max()),
               backward_err=backward(r_dist),
               backward_err_library=backward(r_lib),
               forward_err=float((r_dist.double() - r_64).abs().max()),
               forward_err_library=float((r_lib.double() - r_64).abs()
                                         .max()),
               lower_max=float(torch.tril(r_dist, -1).abs().max()),
               graph_equal_eager=graph_equal, capture_s=capture_s,
               graph_replay_syncs=0)
    # eagerly the host paces the distributed factorization (thousands of
    # launches and 3 collectives per panel), so CUDA events around it time
    # the host: its cost is the synchronized wall time, and its device work
    # the busy time of a profiled call; the same for the graph's replay;
    # cholesky_ex is device-paced (time_ms)
    res["eager_ms"], res["eager_busy_ms"], res["eager_device_ops"] = \
        wall_and_busy_ms(lambda: chol_rowsharded_padded(A, mesh, panel))
    res["ms"], res["device_busy_ms"], res["device_ops"] = wall_and_busy_ms(
        graph.replay)
    sets = [(A + (1e-6 * k) * torch.eye(n, device=A.device),)
            for k in range(1, 5)]
    res["library_ms"], _ = time_ms(
        lambda a: torch.linalg.cholesky_ex(a, upper=True), sets)
    res["library_wall_ms"], res["library_busy_ms"], _ = wall_and_busy_ms(
        lambda: torch.linalg.cholesky_ex(A, upper=True))
    n_pad = res["n_padded"]
    res["bound"] = _bound(8 * n_pad * n_pad, n_pad ** 3 // 3)
    res["ranks"] = mesh.size
    log(f"[multidevice] {tag} dist_chol " + json.dumps(res))
    log(f"[multidevice] {tag} [{smi}] n={n} (padded {n_pad}), panel {panel}, "
        f"{mesh.size} rank(s), one captured graph (capture {capture_s:.2f} s, == eager "
        f"{graph_equal}, replay with 0 synchronizing calls): "
        f"{res['ms']:.3f} ms wall ({res['device_busy_ms']:.3f} ms "
        f"device-busy, {res['device_ops']} device ops) per factorization; "
        f"eager {res['eager_ms']:.3f} ms wall ({res['eager_busy_ms']:.3f} "
        f"ms device-busy, {res['eager_device_ops']} device ops); "
        f"cholesky_ex {res['library_ms']:.3f} ms (wall "
        f"{res['library_wall_ms']:.3f} ms); "
        f"max|R_dist-R_lib|={res['max_abs_diff']:.3e}, "
        f"|R^T R-A|/|A|={res['backward_err']:.3e} (library "
        f"{res['backward_err_library']:.3e}), max|R-R_f64|="
        f"{res['forward_err']:.3e} (library "
        f"{res['forward_err_library']:.3e})")
    # limits: both factors are backward-stable float32 factorizations of
    # the same matrix, so the distributed one may be no more than 4x
    # farther from A (backward) and from the float64 factor (forward, the
    # matrix's conditioning sets the scale) than the library's, and the
    # backward error itself stays at float32 roundoff (1e-5)
    problems = []
    if not (res["backward_err"] <= 1e-5 and res["backward_err"]
            <= 4 * res["backward_err_library"] + 1e-7):
        problems.append(f"backward error {res['backward_err']}")
    if not res["forward_err"] <= 4 * res["forward_err_library"] + 1e-6:
        problems.append(f"forward error {res['forward_err']}")
    if res["lower_max"] != 0.0 or res["library_info"] != 0:
        problems.append("not upper triangular, or the library failed")
    if not graph_equal:
        problems.append("the captured factorization differs from eager")
    if problems:
        raise AssertionError(f"dist_chol checks failed {tag}: "
                             + "; ".join(problems))
    return res


def ba_single(dev) -> dict:
    """The config-5 problem's ``ba_solve`` on the card ``dev``, eagerly and
    as one captured graph (``control.capture_graph``, as the backend's
    window solves run): the problem, the poses, landmarks and costs, both
    routes bit for bit, and ms per iteration of each (wall and
    device-busy)."""
    from cv_monoslam_tpu_torch.backend.ba import ba_solve
    from cv_monoslam_tpu_torch.ops import control

    iters = CONFIG5["iters"]
    prob, cfg = config5_problem(dev)

    def single():
        return ba_solve(prob, cfg, iters=iters)

    p1, l1, c1 = single()
    t0 = time.perf_counter()
    graph, (pg, lg, cg) = control.capture_graph(
        lambda p: ba_solve(p, cfg, iters=iters), (prob,),
        torch.cuda.graph_pool_handle())
    graph.replay()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    graph_equal = all(torch.equal(a, b) for a, b in
                      ((pg, p1), (lg, l1), (cg, c1)))
    # host-paced: synchronized wall time, and a profiled call's busy time
    ms, busy, _ = wall_and_busy_ms(single, reps=3)
    ms_graph, busy_graph, _ = wall_and_busy_ms(graph.replay, reps=3)
    return dict(prob=prob, cfg=cfg, poses=p1, landmarks=l1, costs=c1,
                capture_single_s=capture_s, graph_equal_eager=graph_equal,
                ms_per_iter_single=ms / iters,
                busy_ms_per_iter_single=busy / iters,
                ms_per_iter_single_graph=ms_graph / iters,
                busy_ms_per_iter_single_graph=busy_graph / iters)


def ba_sharded(mesh, prob, cfg) -> dict:
    """``ba_solve_sharded`` of ``prob`` over ``mesh`` (on an NCCL mesh its
    iterations are one captured graph, captured by the first call): the
    poses, all landmarks and the costs, whether it was captured, the
    first call's seconds, and ms per iteration (wall and device-busy)."""
    from cv_monoslam_tpu_torch.parallel.dist_ba import (ba_solve_sharded,
                                                        gather_landmarks)

    iters = CONFIG5["iters"]

    def sharded():
        return ba_solve_sharded(prob, cfg, mesh, iters=iters)

    t0 = time.perf_counter()
    ps, ls, cs = sharded()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    ms, busy, _ = wall_and_busy_ms(sharded, reps=3)
    return dict(poses=ps, landmarks=gather_landmarks(ls, mesh), costs=cs,
                captured=any(isinstance(k, tuple)
                             and k[0] == "ba_solve_sharded"
                             for k in mesh.graphs),
                capture_sharded_s=capture_s, ms_per_iter_sharded=ms / iters,
                busy_ms_per_iter_sharded=busy / iters)


def ba_compare(one: dict, sh: dict, ranks: int, smi: str,
               tag: str = "(c)") -> dict:
    """(c) / (c4): the sharded solve (:func:`ba_sharded`, its arrays as
    numpy or tensors) against ``ba_solve`` on one card
    (:func:`ba_single`): poses and landmarks to 1e-9 (rtol, atol 1e-11),
    both ``ba_solve`` routes bit for bit, the sharded iterations captured,
    finite costs that fall; ms per iteration of all three printed."""
    def host(t):
        return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t))

    p1, l1 = host(one["poses"]), host(one["landmarks"])
    ps, lms, cs = (host(sh[k]) for k in ("poses", "landmarks", "costs"))
    res = dict(W=CONFIG5["W"], L=CONFIG5["L"], iters=CONFIG5["iters"],
               ranks=ranks, observed=int(one["prob"].obs_mask.sum()),
               active_landmarks=int(one["prob"].lm_mask.sum()),
               max_pose_diff=float(np.abs(ps - p1).max()),
               max_landmark_diff=float(np.abs(lms - l1).max()),
               cost_first=float(cs[0]), cost_last=float(cs[-1]),
               cost_last_single=float(host(one["costs"])[-1]),
               sharded_captured=bool(sh["captured"]),
               **{k: one[k] for k in (
                   "capture_single_s", "graph_equal_eager",
                   "ms_per_iter_single", "ms_per_iter_single_graph",
                   "busy_ms_per_iter_single",
                   "busy_ms_per_iter_single_graph")},
               **{k: sh[k] for k in (
                   "capture_sharded_s", "ms_per_iter_sharded",
                   "busy_ms_per_iter_sharded")})
    log(f"[multidevice] {tag} dist_ba " + json.dumps(res))
    log(f"[multidevice] {tag} [{smi}] W={res['W']} L={res['L']} float64, "
        f"{ranks} rank(s): ba_solve_sharded (captured under NCCL: "
        f"{res['sharded_captured']}) {res['ms_per_iter_sharded']:.3f} "
        f"ms/iteration ({res['busy_ms_per_iter_sharded']:.3f} device-busy), "
        f"ba_solve on one card, graph route "
        f"{res['ms_per_iter_single_graph']:.3f} ms/iteration "
        f"({res['busy_ms_per_iter_single_graph']:.3f} device-busy), eager "
        f"route {res['ms_per_iter_single']:.3f} ms/iteration "
        f"({res['busy_ms_per_iter_single']:.3f} device-busy); graph == "
        f"eager {res['graph_equal_eager']}; max|pose diff| "
        f"{res['max_pose_diff']:.3e}")
    close = (np.allclose(ps, p1, rtol=1e-9, atol=1e-11)
             and np.allclose(lms, l1, rtol=1e-9, atol=1e-11))
    if not (close and res["graph_equal_eager"] and res["sharded_captured"]
            and bool(np.isfinite(cs).all())
            and res["cost_last"] < res["cost_first"]):
        raise AssertionError(f"dist_ba checks failed {tag}")
    return res


def md_ba(mesh, dev, smi: str) -> dict:
    """(c) ``ba_solve_sharded`` on the config-5 problem (on the NCCL mesh
    its iterations are one captured graph) against the port's ``ba_solve``
    on the card by both routes (:func:`ba_compare`)."""
    one = ba_single(dev)
    return ba_compare(one, ba_sharded(mesh, one["prob"], one["cfg"]),
                      mesh.size, smi)


def config1_track(dev, frames: int):
    """Config 1 on bench1_arc as a session prepares it: the state after
    frame 0, frames 0 .. frames-1 in the filter dtype, odometry, flags."""
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.io import fixtures

    seq, track, _, _ = fixtures.load("bench1_arc")
    cfg = SlamConfig(**CONFIG1)
    sess = SlamSession(cfg, seq, track, device=dev)
    images = torch.stack([
        sess._to_device(sess._prep_image(seq.get(int(track.frame_id[k]))))
        for k in range(frames)])
    return (cfg, sess.state, images, sess._odo[:frames],
            np.asarray(sess._redirect[:frames]))


def sharded_routes(mesh, inputs, layout) -> dict:
    """``spmd.run_frames`` on (d)'s frames by the graph route (on the NCCL
    mesh each frame one replay of a captured graph of the step; the first
    call captures it, and the kernels' launches over that call are counted
    on the device), a second time under ``set_sync_debug_mode("error")``,
    and by the eager route (the private switch ``spmd._GRAPHS``). Returns
    each run's (state, outputs), the counts and the first call's seconds
    (capture and replays)."""
    from cv_monoslam_tpu_torch.parallel import spmd

    cfg, state0, images, odo, redirect = inputs

    def run():
        return spmd.run_frames(state0, images, odo, redirect, cfg, mesh,
                               layout)

    torch.cuda.synchronize()
    reset_counters(mesh.device)
    t0 = time.perf_counter()
    graph = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_counters(mesh.device)
    again = no_sync(run)
    with patched(spmd, "_GRAPHS", False):
        eager = run()
    torch.cuda.synchronize()
    return dict(graph=graph, again=again, eager=eager, counts=counts,
                first_call_s=first_s, replay_syncs=0)


def routes_differ(runs: dict, want: dict, poses: np.ndarray) -> list:
    """What differs, bit for bit, between each route of
    :func:`sharded_routes` and the single-device run (its final state's
    arrays ``want`` and per-frame ``poses``)."""
    from cv_monoslam_tpu_torch.convert import state_to_arrays

    unequal = []
    for route in ("graph", "again", "eager"):
        st, outs = runs[route]
        got = state_to_arrays(st)
        unequal += [f"{route}: {k}" for k in want
                    if not np.array_equal(want[k], got[k], equal_nan=True)]
        if not np.array_equal(outs["pose"].cpu().numpy(), poses):
            unequal.append(f"{route}: per-frame poses")
    return unequal


def config1_single(dev, frames: int = 8) -> dict:
    """Config 1's first ``frames`` frames by the single-device step on
    ``dev``, the reference of (d)-(f) and of the ranks' (d4): the inputs
    (cfg, state after frame 0, images, odometry, redirect flags), the
    per-frame poses, the final state's arrays and its x, S and discrete
    table fields, and each frame's step (the state entering it, and its
    pose, x and S)."""
    from cv_monoslam_tpu_torch.convert import state_to_arrays
    from cv_monoslam_tpu_torch.filter.srukf import slam_step

    cfg, state0, images, odo, redirect = config1_track(dev, frames)
    state = state0
    poses, entering, after = [], [], []
    for k in range(1, frames):
        entering.append(state)
        state, out = slam_step(state, images[k], odo[k - 1], odo[k],
                               bool(redirect[k]), cfg)
        poses.append(out["pose"])
        after.append(dict(pose=out["pose"], x=state.x, S=state.S))
    want = state_to_arrays(state)
    return dict(
        frames=frames - 1, inputs=(cfg, state0, images, odo, redirect),
        single=dict(pose=torch.stack(poses).cpu().numpy(), x=want["x"],
                    S=want["S"], **{k: want[f"lm.{k}"] for k in
                                    ("active", "matched", "lid")}),
        single_state=want,
        single_steps=(entering, [{k: v.cpu().numpy() for k, v in
                                  a.items()} for a in after]))


def md_landmark_step(mesh, dev) -> dict:
    """(d) The landmark-layout step on 8 frames of config 1 at world size
    1 by the graph route and by the eager route (:func:`sharded_routes`):
    both bit for bit the single-device step, the fused kernel launched by
    the sharded path once per frame under replay, no synchronizing call in
    the graph route's frames."""
    from cv_monoslam_tpu_torch.parallel.mesh import state_shardings

    ref = config1_single(dev)
    frames = ref["frames"] + 1
    cfg = ref["inputs"][0]
    runs = sharded_routes(mesh, ref["inputs"], state_shardings(mesh, cfg))
    counts = runs["counts"]
    unequal = routes_differ(runs, ref["single_state"], ref["single"]["pose"])
    res = dict(frames=frames - 1, unequal=unequal,
               n_matched=runs["graph"][1]["n_matched"].tolist(),
               launches=launches(counts),
               plain_normalizations=counts["plain_normalizations"],
               first_call_s=runs["first_call_s"],
               replay_syncs=runs["replay_syncs"])
    log("[multidevice] (d) landmark-layout step, graph route == eager "
        "route == single device " + json.dumps(res))
    problems = launch_problems(counts, frames - 1,
                               "the landmark-layout step")
    if unequal:
        problems.append(f"differs from the single-device step in {unequal}")
    if problems:
        raise AssertionError("landmark-layout checks failed: "
                             + "; ".join(problems))
    res.update({k: ref[k] for k in ("single", "single_state", "single_steps",
                                    "inputs")})
    return res


def md_shard_sqrt(mesh, d: dict) -> dict:
    """(f) The ``shard_sqrt`` step (every Gram over S's rows a per-rank
    row-block product summed across the mesh) on (d)'s 8 frames of config
    1 at world size 1 by the graph route and by the eager route: both bit
    for bit the single-device step, the fused kernel launched once per
    frame under replay, no synchronizing call in the graph route's
    frames."""
    from cv_monoslam_tpu_torch.parallel.mesh import state_shardings

    cfg = d["inputs"][0]
    runs = sharded_routes(mesh, d["inputs"],
                          state_shardings(mesh, cfg, shard_sqrt=True))
    counts = runs["counts"]
    unequal = routes_differ(runs, d["single_state"], d["single"]["pose"])
    res = dict(frames=d["frames"], state_dim=cfg.state_dim, unequal=unequal,
               launches=launches(counts),
               plain_normalizations=counts["plain_normalizations"],
               first_call_s=runs["first_call_s"],
               replay_syncs=runs["replay_syncs"])
    log("[multidevice] (f) shard_sqrt step, 1 rank, graph route == eager "
        "route == single device " + json.dumps(res))
    problems = launch_problems(counts, d["frames"], "the shard_sqrt step")
    if unequal:
        problems.append(f"differs from the single-device step in {unequal}")
    if problems:
        raise AssertionError("shard_sqrt checks failed: "
                             + "; ".join(problems))
    return res


def _slots_seen(captured: "_Captured") -> int:
    """The slot count of the first fused-kernel call kept by
    :func:`captured_kernel_inputs`: an eager call's, else the first
    captured graph's."""
    first = list(captured) or [c for nodes in captured.nodes.values()
                               for c in nodes]
    return int(first[0][0][1].shape[0])


def _landmark_rank(dev, state0, images, odo, redirect, cfg, entering):
    """One rank of (e) / (f4) (spawned; ``gloo``, the ranks sharing the
    card) or of the ranks' (d4) (NCCL, a card each): config 1's frames
    through ``spmd.run_frames`` in the landmark layout and then in the
    ``shard_sqrt`` layout; for each, the poses, the final state's x, S and
    discrete table fields, the kernel launch counts on this rank's card and
    the slot count the kernels saw; on NCCL (the graph route) also the
    same frames by the eager route. Then, in the ``shard_sqrt`` layout, one
    step from each state in ``entering`` (the single-device state that
    entered each frame): pose, x and S of each."""
    from cv_monoslam_tpu_torch.parallel import spmd
    from cv_monoslam_tpu_torch.parallel.launch import to_device
    from cv_monoslam_tpu_torch.parallel.mesh import make_mesh, state_shardings
    from cv_monoslam_tpu_torch.parallel.spmd import (run_frames,
                                                     sharded_slam_step)

    mesh = make_mesh(device=dev)
    state0, images, odo, redirect, entering = to_device(
        (state0, images, odo, redirect, entering), dev)
    out = {}
    for name, shard_sqrt in (("landmark", False), ("sqrt", True)):
        layout = state_shardings(mesh, cfg, shard_sqrt)
        reset_counters(dev)
        with captured_kernel_inputs(n=1) as captured:
            st, outs = run_frames(state0, images, odo, redirect, cfg, mesh,
                                  layout)
        torch.cuda.synchronize()
        out[name] = dict(pose=outs["pose"], x=st.x, S=st.S,
                         active=st.lm.active, matched=st.lm.matched,
                         lid=st.lm.lid, counts=read_counters(dev),
                         slots=_slots_seen(captured),
                         graphs=mesh.captures and spmd._GRAPHS)
        if mesh.captures:
            with patched(spmd, "_GRAPHS", False):
                st, outs = run_frames(state0, images, odo, redirect, cfg,
                                      mesh, layout)
            out[name]["eager"] = dict(pose=outs["pose"], x=st.x, S=st.S)
    steps = []
    layout = state_shardings(mesh, cfg, shard_sqrt=True)
    for k, st in enumerate(entering, start=1):
        st, o = sharded_slam_step(st, images[k], odo[k - 1], odo[k],
                                  bool(redirect[k]), cfg, mesh, layout)
        steps.append(dict(pose=o["pose"], x=st.x, S=st.S))
    out["sqrt"]["steps"] = steps
    return out


def md_four_ranks(d: dict, smi: str, both: list = None,
                  tag: str = "(e)") -> dict:
    """(e) Four ranks on the one card (``gloo``, which moves CUDA tensors
    through the host; NCCL refuses two ranks on one card): 8 frames of config
    1 in the landmark layout, 8 slots per rank, held against (d)'s
    single-process run to the CPU tests' tolerances. The same spawn runs
    (f)'s ``shard_sqrt`` layout; its results are kept for
    :func:`md_four_ranks_sqrt`. ``both`` (each rank's
    :func:`_landmark_rank` result) is given by the ranks' (d4), which
    runs them on NCCL ranks with a card each: then also the graph route
    equal to the eager route, bit for bit, on every rank."""
    from cv_monoslam_tpu_torch.parallel import launch

    cfg, *inputs = d["inputs"]
    t0 = time.perf_counter()
    if both is None:
        both = launch.spawn(_landmark_rank, 4, "cuda",
                            *launch.to_numpy(tuple(inputs)), cfg,
                            launch.to_numpy(d["single_steps"][0]),
                            timeout_s=300.0, backend="gloo")
    wall = time.perf_counter() - t0
    n = len(both)
    ranks = [r["landmark"] for r in both]
    want = d["single"]
    frames = d["frames"]
    res = dict(ranks=n, seconds=wall,
               max_pose_diff=max(float(np.abs(r["pose"] - want["pose"])
                                       .max()) for r in ranks),
               slots_per_rank=[r["slots"] for r in ranks],
               graph_route=[bool(r["graphs"]) for r in ranks],
               launches_per_rank=[{k: r["counts"][k] for k in
                                   KERNELS}
                                  for r in ranks])
    what = ("gloo ranks on one card" if tag == "(e)"
            else "NCCL ranks, a card each")
    log(f"[multidevice] {tag} {n} {what} " + json.dumps(res))
    log(f"[multidevice] {tag} [{smi}] {n} ranks x {cfg.max_landmarks // n} "
        f"slots, {frames} frames of config 1: max|pose - single| "
        f"{res['max_pose_diff']:.3e} (<= 1e-5), {wall:.1f} s")
    problems = []
    for i, r in enumerate(ranks):
        problems += [f"rank {i}: {p}" for p in
                     launch_problems(r["counts"], frames, tag)]
        if r["slots"] != cfg.max_landmarks // n:
            problems.append(f"rank {i} ran the kernels on {r['slots']} "
                            f"slots, wanted {cfg.max_landmarks // n}")
        for k in ("active", "matched", "lid"):
            if not np.array_equal(r[k], want[k]):
                problems.append(f"rank {i}: lm_{k} differs")
        for k in ("pose", "x", "S"):
            if not np.array_equal(r[k], ranks[0][k]):
                problems.append(f"rank {i}: {k} differs from rank 0's")
            if "eager" in r and not np.array_equal(r[k], r["eager"][k]):
                problems.append(f"rank {i}: {k} of the graph route differs "
                                f"from the eager route")
    if not res["max_pose_diff"] <= 1e-5:
        problems.append(f"pose differs by {res['max_pose_diff']}")
    if problems:
        raise AssertionError(f"{n}-rank checks failed: "
                             + "; ".join(problems))
    res["sqrt_ranks"] = [r["sqrt"] for r in both]
    return res


def md_four_ranks_sqrt(d: dict, e: dict, smi: str,
                       tag: str = "(f)") -> dict:
    """(f) at four ``gloo`` ranks on the card (run by (e)'s spawn), or at
    the ranks' NCCL ranks ((d4)). Each
    frame's ``shard_sqrt`` step from the single-device state that entered
    it, against the single-device step, to ``tests/test_torch_spmd.py``'s
    tolerances for one step (pose rtol 1e-5 / atol 1e-6, x 1e-4 / 1e-5, S
    1e-3 / 1e-4). The 7 frames run through from frame 0: discrete fields
    equal to the single-device run, every rank the same, the fused kernel
    launched by the sharded path on every rank (on NCCL: the graph route
    equal to the eager route). Its poses are printed, not
    gated: in float32 the rank-summed Grams round otherwise than one
    product, S differs by ~1e-6 after a step, and the filter amplifies
    that ~25-fold per frame (the same run in float64 stays within 1e-12)."""
    ranks = e.pop("sqrt_ranks")
    want = d["single"]
    frames = d["frames"]
    steps = d["single_steps"][1]
    step_diffs = {k: max(float(np.abs(r["steps"][i][k] - steps[i][k]).max())
                         for r in ranks for i in range(frames))
                  for k in ("pose", "x", "S")}
    run_diffs = {k: max(float(np.abs(r[k] - want[k]).max()) for r in ranks)
                 for k in ("pose", "x", "S")}
    n = len(ranks)
    res = dict(ranks=n, frames=frames, state_dim=d["inputs"][0].state_dim,
               max_abs_diff_one_step=step_diffs,
               max_abs_diff_run=run_diffs,
               slots_per_rank=[r["slots"] for r in ranks],
               launches_per_rank=[{k: r["counts"][k] for k in
                                   KERNELS}
                                  for r in ranks])
    log(f"[multidevice] {tag} shard_sqrt step, {n} ranks "
        + json.dumps(res))
    log(f"[multidevice] {tag} [{smi}] shard_sqrt, {n} ranks, D = "
        f"{res['state_dim']}, {frames} frames of config 1: one step from the "
        f"single-device state, max|diff| pose {step_diffs['pose']:.3e}, x "
        f"{step_diffs['x']:.3e}, S {step_diffs['S']:.3e}; run through, pose "
        f"{run_diffs['pose']:.3e}, x {run_diffs['x']:.3e}, S "
        f"{run_diffs['S']:.3e} (not gated)")
    problems = []
    for i, r in enumerate(ranks):
        problems += [f"rank {i}: {p}" for p in
                     launch_problems(r["counts"], frames, tag)]
        for k in ("active", "matched", "lid"):
            if not np.array_equal(r[k], want[k]):
                problems.append(f"rank {i}: lm_{k} differs")
        for k in ("pose", "x", "S"):
            if not np.array_equal(r[k], ranks[0][k]):
                problems.append(f"rank {i}: {k} differs from rank 0's")
            if "eager" in r and not np.array_equal(r[k], r["eager"][k]):
                problems.append(f"rank {i}: {k} of the graph route differs "
                                f"from the eager route")
        if r["slots"] != want["active"].shape[0]:
            problems.append(f"rank {i} ran the kernels on {r['slots']} slots")
        for k, rtol, atol in (("pose", 1e-5, 1e-6), ("x", 1e-4, 1e-5),
                              ("S", 1e-3, 1e-4)):
            if not all(np.allclose(got[k], ref[k], rtol=rtol, atol=atol)
                       for got, ref in zip(r["steps"], steps)):
                problems.append(f"rank {i}: one-step {k} outside rtol "
                                f"{rtol} / atol {atol}")
    if problems:
        raise AssertionError(f"{n}-rank shard_sqrt checks failed: "
                             + "; ".join(problems))
    return res


def md_config3(mesh, dev, errs: dict, c3: dict, smi: str,
               shard_sqrt: bool = False, check: bool = True,
               profile: bool = False) -> dict:
    """(b) Config 3 with ``dist_chol_panel=64`` under the mesh
    (``set_mesh(mesh, shard_sqrt=shard_sqrt)``): phase 5's
    run and limits by the graph route (each chunk one captured graph, the
    collectives and the 1e-3 rung's conditional node inside), the
    distributed factorizations and those not finite counted on the device;
    then on a second session warmed up the same way one window through the
    graph and through the eager route (:func:`graph_vs_eager`: every
    discrete result equal, a float difference named, the graph's dispatch
    under ``set_sync_debug_mode("error")``), frames/s of both routes on the
    same windows from the same state (graph, eager, eager, graph), capture
    seconds, the pools' reserve, and the matrix of one eager frame's
    factorization for (a). ``check=False``: phase 5's failed limits are
    returned as ``problems`` (:func:`phase_config3`). ``profile``: after
    the routes, one tracking chunk (the detection gate shut) profiled
    (:func:`profile_chunk`; on a mesh of several ranks every rank runs
    the chunk and rank 0 profiles it)."""
    from cv_monoslam_tpu_torch.ops import control
    from cv_monoslam_tpu_torch.parallel import dist_chol
    from cv_monoslam_tpu_torch.parallel.mesh import set_mesh

    layout = "shard_sqrt" if shard_sqrt else "landmark"
    t0 = time.perf_counter()
    with set_mesh(mesh, shard_sqrt=shard_sqrt):
        dist_chol.reset_device_counts(dev)
        b = phase_config3(dev, errs, tag=f"config3_dist_chol_{layout}",
                          check=check, dist_chol_panel=64)
        counts = dist_chol.device_counts(dev)
        b["dist_chol_calls"], b["rung1"] = (counts["calls"],
                                            counts["not_finite"])
        frames = b["frames"] + 16
        log(f"[multidevice] (b) config 3 through dist_chol, {layout} "
            f"layout, {mesh.size} rank(s), graph route: "
            f"{b['fps']:.2f} frames/s (phase 5: {c3['fps']:.2f} frames/s, "
            f"same call) [{smi}]; {counts['calls']} distributed "
            f"factorizations in {frames} frames (counted on the device), "
            f"{b['rung1']} of them not finite (frames sent to the 1e-3 "
            f"rung); ATE {b['ate_m']:.5f} m (phase 5: {c3['ate_m']:.5f} m)")
        if counts["calls"] < frames:
            raise AssertionError(
                f"the distributed factorization ran {counts['calls']} "
                f"times in {frames} frames")
        sess, _ = config3_session(dev, 8, dist_chol_panel=64)
        start = (sess.counter, control.tree_map(torch.clone, sess.state),
                 sess._last_matched)
        b["graph_vs_eager"], _ = graph_vs_eager(sess, 8,
                                                "config3_dist_chol")
        b["routes"] = routes_fps(sess, start, 8, 3)
        b["capture_s"] = {f"{k}x{'detect' if d else 'track'}": v
                          for (k, d, _, _), v in sess.capture_s.items()}
        b["footprint"] = pool_footprint(sess)
        if profile:
            sess._last_matched = sess.cfg.min_num
            if mesh.rank == 0:
                b["profile"] = profile_chunk(
                    sess, 8, f"config 3 through dist_chol, {layout}, "
                    f"{mesh.size} rank(s), graph")
            else:
                sess.step_chunk(8)
        sess._graphs = False
        with kept_dist_chol_matrix() as kept:
            sess.step()
        sess._graphs = True
    b["kept"] = kept[0]
    fps = b["routes"]
    log(f"[multidevice] (b) [{smi}] config 3 through dist_chol, {layout}, "
        f"{mesh.size} rank(s), same windows "
        f"from the same state (graph, eager, eager, graph): frames/s graph "
        f"{fps['graph']} eager {fps['eager']}; capture {b['capture_s']} s; "
        f"reserved after the captures: graph pool "
        f"{b['footprint']['graph_pool'] / 2**20:.1f} MiB, body pool "
        f"{b['footprint']['body_pool'] / 2**20:.1f} MiB; graph == eager "
        f"rows {b['graph_vs_eager']['rows_equal']}, state "
        f"{b['graph_vs_eager']['state_equal']}; "
        f"{time.perf_counter() - t0:.1f} s")
    return b


def md_witness64(mesh, dev, b: dict, smi: str,
                 shard_sqrt: bool = False) -> dict:
    """(b64) A second witness to (b)'s ATE: (b)'s frames through the
    distributed factorization in float64 by the graph route, with the
    plain vision versions (the kernels take float32), in (b)'s layout.
    Whether float64
    needs the 1e-3 rung, and where its ATE falls against (b)'s, tells the
    rung's share of the float32 spread from the filter's ordinary roundoff.
    Checks 64 finite frames and no synchronizing call in the dispatch of
    its last chunk; the ATE is read, not gated."""
    from cv_monoslam_tpu_torch.parallel import dist_chol
    from cv_monoslam_tpu_torch.parallel.mesh import set_mesh

    layout = "shard_sqrt" if shard_sqrt else "landmark"
    with set_mesh(mesh, shard_sqrt=shard_sqrt):
        dist_chol.reset_device_counts(dev)
        sess, gt_xy = config3_session(dev, 8, dist_chol_panel=64,
                                      dtype="float64", vision_backend="xla")
        n0 = len(sess.records)
        t0 = time.perf_counter()
        sess.run(n_frames=56, chunk=8, drop_tail=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        syncs = dispatch_census(sess, 8)
        counts = dist_chol.device_counts(dev)
    recs = sess.records
    res = dict(frames=len(recs) - n0, fps=56 / dt, graph_route=True,
               layout=layout, ranks=mesh.size,
               ate_m=sess.ate(gt_xy), dist_chol_calls=counts["calls"],
               rung1=counts["not_finite"], dispatch_syncs=syncs[0],
               peak_matched=max(r.n_matched for r in recs),
               repairs=recs[-1].n_repairs,
               escalations=recs[-1].n_escalations,
               skipped=recs[-1].n_skipped)
    log("[multidevice] (b64) config 3 float64 " + json.dumps(res))
    log(f"[multidevice] (b64) [{smi}] config 3 through dist_chol in float64 "
        f"by the graph route, {layout}, {mesh.size} rank(s): ATE "
        f"{res['ate_m']:.5f} m, {res['rung1']} of "
        f"{res['dist_chol_calls']} factorizations not finite (counted on "
        f"the device); float32 (b): ATE {b['ate_m']:.5f} m, {b['rung1']} "
        f"of {b['dist_chol_calls']}; {res['fps']:.2f} frames/s; "
        f"{syncs[0]} synchronizing calls in a dispatch")
    if (res["frames"] != 64 or not np.all(np.isfinite(sess.trajectory))
            or syncs[0]):
        raise AssertionError("float64 witness: not 64 finite frames, or a "
                             "synchronizing call in a dispatch")
    res["digest"] = run_digest(sess)
    return res


def phase_multidevice(dev, errs: dict, c3: dict, smi: str) -> dict:
    """The multi-device paths at world size 1: an NCCL process group in this
    process (``file://`` rendezvous in a temporary directory), its mesh,
    then (probe) NCCL collectives inside a conditional body, (b) config 3
    through the distributed joint factorization by the graph route and the
    eager route, (a) that factorization alone, eagerly and as a graph, on
    the matrix of an eager frame of (b), (c) distributed BA on the config-5
    problem, (d) the landmark-layout step and (f) the shard_sqrt step on
    config 1 by both routes, (e) / (f4) the same on four spawned ranks
    sharing the card, (b64) (b) in float64. The group is closed at the end,
    also on failure."""
    import torch.distributed as dist
    from cv_monoslam_tpu_torch.parallel import launch
    from cv_monoslam_tpu_torch.parallel.mesh import make_mesh

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        launch.init_process(0, 1, "cuda", os.path.join(tmp, "rendezvous"))
        try:
            mesh = make_mesh()
            log(f"[multidevice] NCCL group: rank {mesh.rank} of "
                f"{mesh.size} on {mesh.device}")
            out["probe"] = md_probe(mesh)
            if any(v != "captured" for v in out["probe"].values()):
                raise AssertionError(f"NCCL collectives in a conditional "
                                     f"body: {out['probe']}")
            for key, fn in (("b", lambda: md_config3(mesh, dev, errs, c3,
                                                     smi)),
                            ("a", lambda: md_chol(mesh, out["b"].pop("kept"),
                                                  smi)),
                            ("c", lambda: md_ba(mesh, dev, smi)),
                            ("d", lambda: md_landmark_step(mesh, dev)),
                            ("f", lambda: md_shard_sqrt(mesh, out["d"])),
                            ("e", lambda: md_four_ranks(out["d"], smi)),
                            ("f4", lambda: md_four_ranks_sqrt(
                                out["d"], out["e"], smi)),
                            ("b64", lambda: md_witness64(mesh, dev, out["b"],
                                                         smi))):
                t0 = time.perf_counter()
                out[key] = fn()
                log(f"[multidevice] ({key}) {time.perf_counter() - t0:.1f} s")
        finally:
            dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# --ranks N: the mesh paths on N NCCL ranks, a card each
# ---------------------------------------------------------------------------

#: seconds each phase of a rank of ``--ranks`` may take; a rank still in
#: the phase then prints its threads' tracebacks and exits, so a hang (a
#: collective that one rank never reaches, a replayed graph whose NCCL
#: kernels wait forever) names its phase and ends the run
RANK_DEADLINES = {"p4": 90, "d4": 120, "b4 landmark": 240,
                  "b4 shard_sqrt": 240, "b64 landmark": 150,
                  "b64 shard_sqrt": 150, "a4": 150, "c4": 120}
#: seconds the ranks may take to start (imports, CUDA, the NCCL group)
RANK_START_S = 180


@contextlib.contextmanager
def deadline(rank: int, name: str):
    """Phase ``name`` of a rank under its deadline (:data:`RANK_DEADLINES`):
    past it, ``faulthandler`` writes every thread's traceback to stderr
    and exits the process; the spawning parent then stops every rank."""
    import faulthandler

    seconds = RANK_DEADLINES[name]
    print(f"[ranks] rank {rank}: ({name}) starts, deadline {seconds} s",
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    faulthandler.dump_traceback_later(seconds, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
    log(f"[ranks] ({name}) {time.perf_counter() - t0:.1f} s")


def _tensor_digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def _mesh_rank(dev, config1: tuple, entering: list, c3: dict, smi: str,
               profile: bool) -> dict:
    """One NCCL rank of ``--ranks`` (spawned by ``launch.spawn``; its card
    is ``dev``), every phase under its deadline: (p4) :func:`md_probe`;
    (d4) :func:`_landmark_rank` on config 1's 8 frames (``config1``: the
    parent's inputs, ``entering``: the single-device states entering each
    frame); (b4) :func:`md_config3` in the landmark and the
    ``shard_sqrt`` layout (phase 5's limits reported, not raised); (b64)
    :func:`md_witness64` in both; (a4) :func:`md_chol` on the joint matrix
    of an eager frame of (b4)'s landmark run; (c4) :func:`ba_sharded` on
    the config-5 problem made on this card. Rank 0 prints; the parent
    checks every rank's results against its single-card references and
    against rank 0's."""
    global _QUIET
    from cv_monoslam_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device=dev)
    _QUIET = mesh.rank != 0
    r = mesh.rank
    errs = new_errs()
    out = dict(rank=r, device=str(dev), card=torch.cuda.get_device_name(dev))
    log(f"[ranks] NCCL group of {mesh.size} ranks; rank 0 on {dev}")
    with deadline(r, "p4"):
        out["p4"] = md_probe(mesh)
    if any(v != "captured" for v in out["p4"].values()):
        # the 1e-3 rung of (b4) holds its collectives in such a body
        raise AssertionError(f"(p4) rank {r}: NCCL collectives in a "
                             f"conditional body: {out['p4']}")
    with deadline(r, "d4"):
        out["d4"] = _landmark_rank(dev, *config1, entering)
    kept = None
    for layout, sq in (("landmark", False), ("shard_sqrt", True)):
        with deadline(r, f"b4 {layout}"):
            torch.cuda.reset_peak_memory_stats(dev)
            b = md_config3(mesh, dev, errs, c3, smi, shard_sqrt=sq,
                           check=False, profile=profile and sq)
            b["peak_memory"] = torch.cuda.max_memory_allocated(dev)
            matrix = b.pop("kept")
            kept = matrix if kept is None else kept
            out[f"b4 {layout}"] = b
    for layout, sq in (("landmark", False), ("shard_sqrt", True)):
        with deadline(r, f"b64 {layout}"):
            out[f"b64 {layout}"] = md_witness64(mesh, dev, out[f"b4 {layout}"],
                                                smi, shard_sqrt=sq)
    with deadline(r, "a4"):
        out["a4"] = md_chol(mesh, kept, smi, tag="(a4)")
        out["a4"]["matrix_digest"] = _tensor_digest(kept)
        out["a4_matrix"] = kept if r == 0 else None
    with deadline(r, "c4"):
        prob, cfg = config5_problem(dev)
        out["c4"] = ba_sharded(mesh, prob, cfg)
    return out


def digests_differ(a: dict, b: dict) -> list:
    """The parts of two :func:`run_digest` results that differ."""
    return ([k for k in ("records", "trajectory") if a[k] != b[k]]
            + [f"state.{k}" for k in a["state"]
               if a["state"][k] != b["state"][k]])


def ranks_config3(ranks: list, c3: dict, layout: str, smi: str) -> list:
    """(b4) / (b64) of one layout, from every rank's results: prints the
    frames/s and the speed-up over the single card (phase 5 in the same
    call), the routes, captures, pools and peak memory of each rank, and
    returns what failed: phase 5's limits on any rank, a rank whose
    records, trajectory or state differ from rank 0's (in float32 or in
    float64)."""
    n = len(ranks)
    bs = [r[f"b4 {layout}"] for r in ranks]
    ws = [r[f"b64 {layout}"] for r in ranks]
    b0, w0 = bs[0], ws[0]
    problems = []
    for i, (b, w) in enumerate(zip(bs, ws)):
        problems += [f"rank {i}: {p}" for p in b["problems"]]
        for what, got, want in (("float32", b, b0), ("float64", w, w0)):
            differ = digests_differ(got["digest"], want["digest"])
            if differ:
                problems.append(f"rank {i} ({what}) differs from rank 0 in "
                                f"{differ[:6]}")
    res = dict(
        layout=layout, ranks=n, fps=b0["fps"], fps_single_card=c3["fps"],
        speedup=b0["fps"] / c3["fps"], fps_per_rank=[b["fps"] for b in bs],
        ate_m=b0["ate_m"], ate_single_card_m=c3["ate_m"],
        peak_matched=b0["peak_matched"], escalations=b0["escalations"],
        skipped=b0["skipped"], dist_chol_calls=[b["dist_chol_calls"]
                                                for b in bs],
        rung1=[b["rung1"] for b in bs],
        routes_graph=b0["routes"]["graph"], routes_eager=b0["routes"]["eager"],
        graph_equal_eager_rows=[b["graph_vs_eager"]["rows_equal"]
                                for b in bs],
        capture_s=[b["capture_s"] for b in bs],
        graph_pool_mib=[b["footprint"]["graph_pool"] / 2**20 for b in bs],
        body_pool_mib=[b["footprint"]["body_pool"] / 2**20 for b in bs],
        peak_memory_mib=[b["peak_memory"] / 2**20 for b in bs],
        launches_per_rank=[b["launches"] for b in bs],
        float64_ate_m=w0["ate_m"], float64_rung1=[w["rung1"] for w in ws],
        float64_fps=w0["fps"], problems=problems)
    if "profile" in b0:
        res["profile_rank0"] = b0["profile"]
    log(f"[ranks] (b4) {layout} " + json.dumps(res))
    log(f"[ranks] (b4) [{smi}] config 3 through dist_chol, {layout} layout, "
        f"{n} ranks: {res['fps']:.2f} frames/s by the graph route against "
        f"{c3['fps']:.2f} on one card (phase 5, same call): speed-up "
        f"{res['speedup']:.3f}; same windows graph {res['routes_graph']} / "
        f"eager {res['routes_eager']} f/s; ATE {res['ate_m']:.5f} m "
        f"(float64 {res['float64_ate_m']:.5f} m), peak matched "
        f"{res['peak_matched']}, {res['escalations']} escalated, "
        f"{res['skipped']} skipped; rung taken {res['rung1']} (float64 "
        f"{res['float64_rung1']}); ranks equal to rank 0: "
        f"{not any('differs from rank 0' in p for p in problems)}")
    return problems


def main_ranks(n: int, profile: bool) -> int:
    """``--ranks n``: the multi-device paths on ``n`` NCCL ranks, card r
    for rank r. The kernels are built, the single-card references run on
    card 0 in this process (config 1's 8 frames by the single-device
    step, phase 5's config-3 run, config 5's ``ba_solve``), then ``n``
    ranks are spawned (:func:`_mesh_rank`) and their results checked here;
    last, at one NCCL rank in this process, config 3 through the
    distributed factorization (its frames/s, the scaling baseline) and
    (a4)'s matrix factorized at world size 1."""
    import torch.distributed as dist
    from cv_monoslam_tpu_torch.parallel import launch
    from cv_monoslam_tpu_torch.parallel.mesh import make_mesh, set_mesh

    cards = torch.cuda.device_count()
    if cards < n:
        print(f"chip_smoke: --ranks {n} needs {n} cards (one per NCCL "
              f"rank), this machine has {cards}", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    info = card_info()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    for i, line in enumerate(smi):
        log(f"[card] {i}: {line}")
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60).stdout.rstrip()
    for line in topo.splitlines():
        log(f"[topo] {line}")
    log("[topo] peer access (row: from card, column: to card): " + "; ".join(
        " ".join("-" if i == j else
                 str(int(torch.cuda.can_device_access_peer(i, j)))
                 for j in range(cards)) for i in range(cards)))
    log(f"[card] python {sys.version.split()[0]}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}, NCCL {torch.cuda.nccl.version()}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on: covariance math needs FP32")
    used = "; ".join(smi[:n])

    def run(phase, *a):
        t0 = time.perf_counter()
        out = phase(*a)
        log(f"[phase] {phase.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    run(phase_build)
    c1 = run(config1_single, dev)
    errs = new_errs()
    c3 = run(phase_config3, dev, errs)
    one = run(ba_single, dev)
    cfg1, *inputs = c1["inputs"]
    t0 = time.perf_counter()
    ranks = launch.spawn(
        _mesh_rank, n, "cuda", launch.to_numpy(tuple(inputs)) + (cfg1,),
        launch.to_numpy(c1["single_steps"][0]),
        dict(fps=c3["fps"], ate_m=c3["ate_m"]), used, profile,
        timeout_s=RANK_START_S + sum(RANK_DEADLINES.values()))
    log(f"[phase] {n} ranks: {time.perf_counter() - t0:.1f} s")
    failed = []
    for i, r in enumerate(ranks):
        log(f"[ranks] rank {i} ran on {r['device']} ({r['card']})")
    log(f"[ranks] (p4) [{used}] NCCL collectives in a conditional body at "
        f"{n} ranks, per rank: " + json.dumps([r["p4"] for r in ranks]))
    d4 = md_four_ranks(c1, used, both=[r["d4"] for r in ranks], tag="(d4)")
    f4 = md_four_ranks_sqrt(c1, d4, used, tag="(d4 shard_sqrt)")
    for layout in ("landmark", "shard_sqrt"):
        failed += [f"(b4 {layout}) {p}"
                   for p in ranks_config3(ranks, c3, layout, used)]
    a4 = ranks[0]["a4"]
    if len({r["a4"]["matrix_digest"] for r in ranks}) != 1:
        failed.append("(a4) the ranks kept different matrices")
    c4 = ba_compare(one, ranks[0]["c4"], n, used, tag="(c4)")
    for i, r in enumerate(ranks):
        if not all(np.array_equal(r["c4"][k], ranks[0]["c4"][k])
                   for k in ("poses", "landmarks", "costs")):
            failed.append(f"(c4) rank {i} differs from rank 0")

    # world size 1 in this process: the scaling baseline and (a4)'s matrix
    with tempfile.TemporaryDirectory() as tmp:
        launch.init_process(0, 1, "cuda", os.path.join(tmp, "rendezvous"))
        try:
            mesh1 = make_mesh()
            with set_mesh(mesh1):
                b1 = phase_config3(dev, errs, "config3_dist_chol_one_rank",
                                   check=False, dist_chol_panel=64)
            failed += [f"(b1) {p}" for p in b1["problems"]]
            a1 = md_chol(mesh1, torch.as_tensor(ranks[0]["a4_matrix"],
                                                device=dev),
                         smi[0], tag="(a1)")
        finally:
            dist.destroy_process_group()
    summary = dict(
        ranks=n, cards=smi[:n],
        launches_per_rank={
            phase: [r[key]["launches"] for r in ranks]
            for phase, key in (("b4 landmark", "b4 landmark"),
                               ("b4 shard_sqrt", "b4 shard_sqrt"))},
        launches_per_rank_d4=d4["launches_per_rank"],
        launches_per_rank_d4_shard_sqrt=f4["launches_per_rank"],
        config3_fps=dict(single_card=c3["fps"], one_rank_dist_chol=b1["fps"],
                         **{layout: ranks[0][f"b4 {layout}"]["fps"]
                            for layout in ("landmark", "shard_sqrt")}),
        dist_chol_ms=dict(ranks=a4["ms"], ranks_busy=a4["device_busy_ms"],
                          ranks_eager=a4["eager_ms"], one_rank=a1["ms"],
                          one_rank_busy=a1["device_busy_ms"],
                          cholesky_ex=a1["library_ms"],
                          cholesky_ex_rank0=a4["library_ms"]),
        ba_ms_per_iter=dict(ranks=c4["ms_per_iter_sharded"],
                            single_card_graph=c4["ms_per_iter_single_graph"],
                            single_card_eager=c4["ms_per_iter_single"]),
        failed=failed)
    log(f"[ranks] config 3 frames/s [{used}]: one card "
        f"{c3['fps']:.2f}, one NCCL rank through dist_chol {b1['fps']:.2f}, "
        f"{n} ranks landmark {summary['config3_fps']['landmark']:.2f} / "
        f"shard_sqrt {summary['config3_fps']['shard_sqrt']:.2f}; dist_chol "
        f"n=4612 as a graph {a4['ms']:.3f} ms at {n} ranks, {a1['ms']:.3f} "
        f"ms at one, cholesky_ex {a1['library_ms']:.3f} ms; BA config 5 "
        f"{c4['ms_per_iter_sharded']:.3f} ms/iteration at {n} ranks, "
        f"{c4['ms_per_iter_single_graph']:.3f} on one card")
    log(json.dumps({"ranks": summary}))
    if failed:
        raise AssertionError("--ranks checks failed: " + "; ".join(failed))
    for line in smi[:n]:
        log(line)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": info["kind"],
                                           "count": n}}))
    return 0


def phase_profile(dev, config: int) -> None:
    """Where a chunk's time goes: ``torch.profiler`` over one chunk after
    the warm-up, by the graph route and then by the eager route (the
    private switch ``_graphs``), each on the same window from the same
    state (config 1: one 32-frame chunk of the slice; config 3: after the
    two warm-up chunks one 8-frame chunk with the detection gate forced
    shut, then one with it forced open; config 4: 16 frames with the live
    backend). Prints wall ms per frame, the device's busy share (union of
    device-side intervals over the wall time), the host's synchronizing
    calls per frame and the device time per kernel name; for config 3
    also the census of the source lines that synchronize."""
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.io import fixtures
    from cv_monoslam_tpu_torch.ops import control

    def both_routes(sess, frames, label, gate=None):
        c0 = sess.counter
        s0 = control.tree_map(torch.clone, sess.state)
        for graphs in (True, False):
            sess._graphs = graphs
            sess.state = control.tree_map(torch.clone, s0)
            sess.counter = c0
            if gate is not None:
                sess._last_matched = gate
            profile_chunk(sess, frames, label + (", graph" if graphs
                                                 else ", eager"))
        sess._graphs = True

    if config == 1:
        chunk = 32
        seq, track, _, _ = fixtures.load("bench1_arc")
        sess = SlamSession(SlamConfig(**CONFIG1), seq, track, device=dev)
        sess.step_chunk(chunk)
        sess.step_chunk(chunk)          # the graph captured and replayed
        both_routes(sess, chunk, "config 1")
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
        profile_chunk(sess, chunk, "config 4, live backend, graph",
                      n_chunks=2)
        log(f"[profile] config 4: {len(sess.refinements) - n0} backend "
            f"solves inside the profiled frames")
    else:
        chunk = 8
        sess, _ = config3_session(dev, chunk)
        both_routes(sess, chunk, "config 3", gate=sess.cfg.min_num)
        both_routes(sess, chunk, "config 3", gate=0)
        for gate in (sess.cfg.min_num, 0):
            sess._last_matched = gate
            sync_census(sess, chunk, "config 3, graph")


def sync_census(sess, chunk: int, label: str) -> None:
    """Which source lines make the host wait for the device: one chunk's
    dispatch and then its finish under ``torch.cuda.set_sync_debug_mode(
    "warn")``, the warnings counted by the port's line that issued the
    call."""
    import collections
    import traceback
    import warnings

    where = {"dispatch": collections.Counter(),
             "finish": collections.Counter()}
    step = ["dispatch"]

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        mine = [f for f in traceback.extract_stack()
                if "cv_monoslam_tpu_torch" in f.filename]
        f = mine[-1] if mine else None
        where[step[0]][f"{os.path.relpath(f.filename)}:{f.lineno} "
                       f"({f.name})" if f else f"{filename}:{lineno}"] += 1

    real = warnings.showwarning
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            pending = sess._dispatch_chunk(chunk)
            step[0] = "finish"
            n = len(sess._finish_chunk(pending))
    finally:
        warnings.showwarning = real
        torch.cuda.set_sync_debug_mode("default")
    tag = f"[syncs] {label}, detect={sess.chunk_detect[-1]}"
    log(f"{tag}: {sum(where['dispatch'].values()) / n:.1f} synchronizing "
        f"calls/frame inside the chunk (its dispatch), "
        f"{sum(where['finish'].values())} in its finish, over {n} frames")
    for part, counter in where.items():
        for src, cnt in counter.most_common(20):
            log(f"{tag}   {part}: {cnt / n:6.2f}/frame  {src}")


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def wall_and_busy_ms(fn, reps: int = 5) -> Tuple[float, float, int]:
    """For a call that the host, not the device, paces: the median wall
    time of ``reps`` calls (host clock, synchronized at both ends), and of
    one profiled call the device-busy time (the union of its device
    intervals, clipped to the call's span: at four NCCL ranks the profiler
    gave an eager call's NCCL kernels intervals of seconds) and its count
    of device operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("wall_and_busy_ms"):
            fn()
            torch.cuda.synchronize()
    # the annotation also leaves a device-side event spanning the call
    call = next(e.time_range for e in prof.events()
                if e.name == "wall_and_busy_ms"
                and e.device_type != DeviceType.CUDA)
    lo, hi = call.start, call.end
    spans = [(max(e.time_range.start, lo), min(e.time_range.end, hi))
             for e in prof.events() if e.device_type == DeviceType.CUDA
             and e.name != "wall_and_busy_ms"]
    return (statistics.median(walls),
            union_us([(a, b) for a, b in spans if b > a]) / 1e3, len(spans))


def profile_chunk(sess, chunk: int, label: str, n_chunks: int = 1) -> dict:
    """``torch.profiler`` over ``n_chunks`` calls of ``step_chunk(chunk)``
    (whose graph the caller has captured already): wall and device-busy
    time per frame, the NCCL kernels' share of the busy time, the device's
    idle gaps (the largest, and the time in gaps over 10 µs) and the
    device time by kernel name; returns the first of these."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync_calls = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                  "cudaEventSynchronize")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = sum(len(sess.step_chunk(chunk)) for _ in range(n_chunks))
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
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy = union_us(spans)
    nccl = union_us([(e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and "nccl" in e.name.lower()])
    gaps, end = [], None
    for a, b in sorted(spans):
        if end is not None and a > end:
            gaps.append(a - end)
        end = b if end is None else max(end, b)
    res = dict(frames=n, wall_ms_per_frame=wall_us / n / 1e3,
               busy_ms_per_frame=busy / n / 1e3, busy_share=busy / wall_us,
               device_ops_per_frame=len(spans) / n,
               syncs_per_frame=syncs / n, nccl_share_of_busy=nccl / busy,
               nccl_ms_per_frame=nccl / n / 1e3,
               largest_gap_us=max(gaps, default=0.0),
               gaps_over_10us_ms_per_frame=sum(
                   g for g in gaps if g > 10.0) / n / 1e3)
    tag = f"[profile] {label}, detect={sess.chunk_detect[-1]}"
    log(f"{tag}: {n} frames: {res['wall_ms_per_frame']:.3f} ms/frame wall, "
        f"{res['busy_ms_per_frame']:.3f} ms/frame device-busy "
        f"({100.0 * res['busy_share']:.1f}% busy), "
        f"{res['device_ops_per_frame']:.1f} device ops/frame, "
        f"{res['syncs_per_frame']:.1f} synchronizing host calls/frame; NCCL "
        f"kernels {res['nccl_ms_per_frame']:.3f} ms/frame "
        f"({100.0 * res['nccl_share_of_busy']:.1f}% of busy); idle gaps: "
        f"largest {res['largest_gap_us']:.1f} us, "
        f"{res['gaps_over_10us_ms_per_frame']:.3f} ms/frame in gaps over "
        f"10 us")
    for name, (cnt, us) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][1])[:15]:
        log(f"{tag}   {us / n:9.1f} us/frame  {cnt / n:6.1f}/frame  "
            f"{name[:90]}")
    return res


def _mark_log(doc: dict) -> list:
    """(stage, start us, end us) of every stage mark in a Chrome trace, in
    start order."""
    marks = []
    for e in doc["traceEvents"] if isinstance(doc, dict) else doc:
        name = str(e.get("name", ""))
        i = name.find("stage_mark_")
        if e.get("cat") != "kernel" or i < 0:
            continue
        stage = name[i + len("stage_mark_"):].split("_kernel")[0]
        marks.append((stage, float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return sorted(marks, key=lambda m: m[1])


def phase_marks(dev) -> dict:
    """The stage marks (``vision.stage_mark``) on the card: (a)
    ``%globaltimer``'s resolution, from 400 replays of a graph of two
    back-to-back marks, each replay's interval read alone, and the mean
    interval of 256 back-to-back marks in one graph; (b) config 1 by
    ``run(chunk=8)`` (a detect and a tracking key, the host gate forced both
    ways) and by ``step()``, profiled: each replay's marks are ``start``
    and then the seven of each frame in order, and each stage's ms a frame
    from the trace's marks beside the accumulators' (``stage_times``) over
    the same frames; (c) a span site's host cost with no profiler and
    under one."""
    from torch.profiler import ProfilerActivity, profile

    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.io import fixtures
    from cv_monoslam_tpu_torch.ops import control, vision
    from cv_monoslam_tpu_torch.utils import profiling

    out = {}
    normal = ["motion", "measure", "associate", "update", "maintain",
              "detect", "telemetry"]

    # (a) resolution and back-to-back interval
    def graph_of(stages):
        side = control.capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for st in stages:                         # builds the buffers
                vision.stage_mark(dev, st)
        torch.cuda.current_stream(dev).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            for st in stages:
                vision.stage_mark(dev, st)
        return g

    pair = graph_of(["start", "motion"])
    deltas = []
    for _ in range(400):
        vision.reset_stage_times(dev)
        pair.replay()
        deltas.append(vision.stage_times(dev)["motion"])
    d = np.asarray(deltas[16:])
    steps = np.diff(np.unique(d))
    out["pair_ns"] = dict(min=int(d.min()), median=float(np.median(d)),
                          max=int(d.max()), distinct=int(len(np.unique(d))),
                          smallest_step=int(steps.min()) if len(steps) else 0)
    chain = graph_of(["start"] + ["motion"] * 256)
    vision.reset_stage_times(dev)
    for _ in range(10):
        chain.replay()
    st = vision.stage_times(dev)
    out["chain_ns_per_mark"] = st["motion"] / (10 * 256)
    log(f"[marks] (a) %globaltimer, two back-to-back marks in a graph, 384 "
        f"replays: {out['pair_ns']} ns; 256 marks in a row: "
        f"{out['chain_ns_per_mark']:.1f} ns a mark")

    # (b) order and the accumulators against the trace
    seq, track, _, _ = fixtures.load("bench1_arc")
    cfg = SlamConfig(**CONFIG1)
    sess = SlamSession(cfg, seq, track, device=dev)
    sess.detect_host_gate = True
    sess.step_chunk(8)                                # (8, detect)
    sess._last_matched = cfg.min_num
    sess.step_chunk(8)                                # (8, tracking)
    sess._last_matched = 0
    sess.step()                                       # the step graph
    problems = []

    def chunks():
        # the tracking key twice, then the detect key twice
        for matched in (cfg.min_num, cfg.min_num, 0, 0):
            sess._last_matched = matched
            sess.step_chunk(8)

    for label, run, replays, frames_k in (
            ("run(chunk=8)", chunks, 4, 8),
            ("step()", lambda: [sess.step() for _ in range(8)], 8, 1)):
        torch.cuda.synchronize()
        before = vision.stage_times(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        after = vision.stage_times(dev)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                marks = _mark_log(json.load(f))
        seqs, cur = [], None
        for stage, a, b in marks:
            if stage == "start":
                cur = []
                seqs.append(cur)
            elif cur is not None:
                cur.append(stage)
        bad = [i for i, sq in enumerate(seqs) if sq != normal * frames_k]
        if len(seqs) != replays or bad:
            problems.append(f"{label}: {len(seqs)} replays, out of order: "
                            f"{[seqs[i] for i in bad[:2]]}")
        frames = after["frames"] - before["frames"]
        acc = {k: (after[k] - before[k]) / max(frames, 1) / 1e6
               for k in vision.STAGES}
        from_trace = {k: 0.0 for k in vision.STAGES}
        prev = None
        for stage, a, b in marks:
            if stage != "start" and prev is not None:
                from_trace[stage] += (b - prev) / 1e3
            prev = b
        n_tr = sum(1 for m in marks if m[0] == "telemetry")
        from_trace = {k: v / max(n_tr, 1) for k, v in from_trace.items()}
        out[label] = dict(replays=len(seqs), frames=frames,
                          accumulators_ms=acc, trace_marks_ms=from_trace)
        log(f"[marks] (b) config 1 {label}: {len(seqs)} replays, {frames} "
            f"frames marked, order {'ok' if not bad else 'WRONG'}; ms a "
            f"frame, accumulators / trace marks: " + ", ".join(
                f"{k} {acc[k]:.4f} / {from_trace[k]:.4f}"
                for k in vision.STAGES if k != "reset"))

    # (c) a span site's host cost
    n = 200000
    for _ in range(1000):
        with profiling.span("slam.cost"):
            pass
    t0 = time.perf_counter()
    for _ in range(n):
        with profiling.span("slam.cost"):
            pass
    off = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for _ in range(n):
        pass
    loop = (time.perf_counter() - t0) / n * 1e6
    m = 2000
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        for _ in range(m):
            with profiling.span("slam.cost"):
                pass
        on = (time.perf_counter() - t0) / m * 1e6
    out["span_us"] = dict(off=off, on=on, empty_loop=loop)
    log(f"[marks] (c) a span site on the host: {off:.3f} us with no "
        f"profiler, {on:.3f} us under one (an empty loop turn {loop:.3f} "
        f"us)")
    if problems:
        raise AssertionError("stage marks: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# the full-sigma measurement prediction (csrc/vision_kernels.cu)
# ---------------------------------------------------------------------------


def blob_lap_session(dev, rows: int, redirect_at: int = None):
    """Config 1 (``slambench/configs/turtlebot_m32.json``) on the
    benchmark's blob lap, rendered on the card from ``MEASURE_SEED`` as a
    benchmark run renders it, ``rows`` rows of odometry (a redirection
    forced at row ``redirect_at``). Returns (cfg, session)."""
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.api import SlamSession
    from cv_monoslam_tpu_torch.io.dataset import (ImageSequence,
                                                  preprocess_odometry)
    from slambench import harness
    from slambench import lap as lapmod

    cfg = SlamConfig(**harness.config("turtlebot_m32")["slam"])
    c = cfg.camera
    cam = lapmod.Camera(c.width, c.height, c.dx, c.dy, c.cx, c.cy, c.k1,
                        c.k2, c.f)
    lap = lapmod.make_lap(harness.traffic("blob_lap"), MEASURE_SEED, cam,
                          cfg.deep, rows, dev)
    track = preprocess_odometry(lap.raw, min_step_xy=cfg.min_step_xy,
                                min_step_theta=cfg.min_step_theta,
                                capacity=rows)
    if redirect_at is not None:
        track.redirect[redirect_at] = True
    return cfg, SlamSession(cfg, ImageSequence(frames=lap.frames), track,
                            device=dev)


def kept_measure_sets(sess, frames: int) -> list:
    """(state, cache, lo, hi) of every full-sigma measurement prediction in
    ``frames`` eager steps of ``sess``, cloned."""
    from cv_monoslam_tpu_torch.filter import measurement
    from cv_monoslam_tpu_torch.ops import control

    kept, real = [], measurement._full_rows

    def keep(state, cache, cfg, lo, hi):
        kept.append((control.tree_map(torch.clone, state),
                     control.tree_map(torch.clone, cache), lo, hi))
        return real(state, cache, cfg, lo, hi)

    sess._graphs = False
    with patched(measurement, "_full_rows", keep):
        for _ in range(frames):
            sess.step()
    sess._graphs = True
    torch.cuda.synchronize()
    return kept


def measure_gaps(sets: list, cfg, dtype) -> dict:
    """The kernel route (``filter/measurement._full_rows`` on the card)
    against ``full_rows_ref`` on each kept set (cast to ``dtype``): sentinel
    flips (a point (0, 0) in one and not in the other), points, visibility
    and slots' pred and si not the plain version's bits, the largest |dpix|
    of a point both see, and the relative gaps of pred and si over the slots
    both see (largest |diff| over the plain version's largest |value|)."""
    from cv_monoslam_tpu_torch.filter import measurement
    from cv_monoslam_tpu_torch.ops import control

    def cast(t):
        return t.to(dtype) if t.is_floating_point() else t

    r = dict(sets=len(sets), points=0, flips=0, pix_differ=0,
             max_dpix=0.0, visible_differ=0, pred_differ=0, si_differ=0,
             pred_rel_gap=0.0, si_rel_gap=0.0, visible_slots=0)
    for state, cache, lo, hi in sets:
        state = control.tree_map(cast, state)
        cache = control.tree_map(cast, cache)
        got = measurement._full_rows(state, cache, cfg, lo, hi)
        ref = measurement.full_rows_ref(state, cache, cfg, lo, hi)
        pix, rpix = got["sigma_pix"], ref["sigma_pix"]
        k0 = (pix == 0).all(dim=1)
        r0 = (rpix == 0).all(dim=1)
        both = ~k0 & ~r0
        r["points"] += k0.numel()
        r["flips"] += int((k0 ^ r0).sum())
        r["pix_differ"] += int((pix != rpix).any(dim=1).sum())
        if both.any():
            d = (pix - rpix).abs().amax(dim=1)[both].max()
            r["max_dpix"] = max(r["max_dpix"], float(d))
        r["visible_differ"] += int((got["visible"] != ref["visible"]).sum())
        r["pred_differ"] += int((got["pred"] != ref["pred"]).any(-1).sum())
        r["si_differ"] += int((got["si"] != ref["si"]).flatten(1).any(-1)
                              .sum())
        v = got["visible"] & ref["visible"]
        r["visible_slots"] += int(v.sum())
        for key in ("pred", "si"):
            if v.any():
                gap = ((got[key] - ref[key])[v].abs().max()
                       / ref[key][v].abs().max())
                r[f"{key}_rel_gap"] = max(r[f"{key}_rel_gap"], float(gap))
    return r


def measure_bound(m: int, ns: int, itemsize: int) -> dict:
    """The projection: bytes of the 6 m + 6 sigma rows it reads (its
    slots', the robot's four, err's two) and of the pixels it writes;
    operations ``MEASURE_OPS_PER_POINT`` a point."""
    nbytes = itemsize * ((6 * m + 6) * ns + 2 * m * ns)
    return _bound(nbytes, m * ns * MEASURE_OPS_PER_POINT)


def phase_measure(dev, smi: str) -> dict:
    """3d. The full-sigma measurement prediction's kernels
    (``vision.measure_project``, ``vision.measure_merge``, around the plain
    version's two reductions) on config 1 on the benchmark's blob lap: (a)
    the kernel route (``filter/measurement._full_rows``) against
    ``full_rows_ref`` on the sigma sets of ``MEASURE_SETS`` tracked frames
    kept from eager steps, float32 and (b) the same sets in float64:
    sentinel flips, points, visibility, pred and si not the plain version's
    bits (all must be 0), the largest |dpix|; (c) each kernel's time (CUDA
    events, kept sets in turn) beside the launch floor and the projection's
    bound, and the device and host time of the kernel route and of the
    plain chain; (d) two sessions by chunk graphs of 32, one through the
    plain chain (``_full_rows`` replaced by ``full_rows_ref`` while it
    captures) and one through the kernels: their launches (each tracked
    frame, 0 on the plain session and on a forced redirect frame),
    synchronizing calls of a dispatch (``dispatch_census``), device
    operations a frame (a profiled chunk of each), the ``measure`` stage's
    ms a frame (stage marks) and frames/s in turns (plain, kernel, kernel,
    plain)."""
    from cv_monoslam_tpu_torch.filter import measurement
    from cv_monoslam_tpu_torch.ops import vision

    out, problems = {}, []
    chunk, warm, turn = 32, 4, 8
    # warm-up, two turns, the census and the profiled chunk, then a stretch
    # of two chunks with a redirection forced on its 17th frame
    stretch = chunk * (warm + 2 * turn + 2)
    rows = stretch + 2 * chunk + 2
    cfg, sess = blob_lap_session(dev, MEASURE_SETS + 2)
    sets = kept_measure_sets(sess, MEASURE_SETS)
    del sess
    for dt, tag in ((torch.float32, "(a) float32"),
                    (torch.float64, "(b) float64")):
        g = measure_gaps(sets, cfg, dt)
        out[str(dt).split(".")[-1]] = g
        log(f"[measure] {tag}, {g['sets']} sigma sets of the blob lap "
            f"({g['points']} points, {g['visible_slots']} visible slots), "
            f"kernel route against the plain version: {g['flips']} sentinel "
            f"flips, {g['pix_differ']} pixels not its bits (max |dpix| "
            f"{g['max_dpix']:.3g}), slots differing in visible "
            f"{g['visible_differ']}, pred {g['pred_differ']} (rel gap "
            f"{g['pred_rel_gap']:.3g}), si {g['si_differ']} (rel gap "
            f"{g['si_rel_gap']:.3g})")
        if any(g[k] for k in ("flips", "pix_differ", "visible_differ",
                              "pred_differ", "si_differ")):
            problems.append(f"{tag}: {g}")

    # (c) time
    m = cfg.max_landmarks
    floor, _ = time_ms(lambda: vision.empty_launch(dev), [()])
    sets = sets[:N_TIMED]
    tails = []
    for st, ca, lo, hi in sets:
        pix = measurement.project_all(ca.sigma, cfg, lo, hi)
        mean, gram = measurement._pixel_moments(pix, cfg)
        lm = st.lm
        tails.append((mean, gram, lm.active[lo:hi], lm.pred[lo:hi],
                      lm.si[lo:hi]))
    p_ms, p_host = time_ms(lambda st, ca, lo, hi: vision.measure_project(
        ca.sigma, lo=lo, m=hi - lo, state_dim=cfg.state_dim, cam=cfg.camera),
        sets)
    g_ms, g_host = time_ms(lambda *a: vision.measure_merge(
        *a, sigma_measure=cfg.sigma_measure), tails)
    r_ms, r_host = time_ms(lambda st, ca, lo, hi: measurement._full_rows(
        st, ca, cfg, lo, hi), sets)
    c_ms, c_host = time_ms(lambda st, ca, lo, hi: measurement.full_rows_ref(
        st, ca, cfg, lo, hi), sets)
    ns = sets[0][1].sigma.shape[1]
    bound = measure_bound(m, ns, 4)
    out["time"] = dict(project_ms=p_ms, project_host_ms=p_host,
                       merge_ms=g_ms, merge_host_ms=g_host, route_ms=r_ms,
                       route_host_ms=r_host, plain_ms=c_ms,
                       plain_host_ms=c_host, launch_floor_ms=floor, m=m,
                       ns=ns, **bound)
    log(f"[measure] (c) [{smi}] M={m} ns={ns}: measure_project {p_ms:.4f} ms "
        f"({p_ms / floor:.2f} x the launch floor {floor:.4f} ms; bound "
        f"{bound['bound_ms'] * 1e3:.3f} us by {bound['bound_by']}: "
        f"{bound['bytes']} B, {bound['flops']} operations), host "
        f"{p_host:.4f} ms; measure_merge {g_ms:.4f} ms, host {g_host:.4f} "
        f"ms; the kernel route (both and the two reductions) {r_ms:.4f} ms "
        f"device, {r_host:.4f} ms host; the plain chain {c_ms:.4f} ms "
        f"device, {c_host:.4f} ms host")
    del sets, tails

    # (d) the two routes by chunk graphs
    sessions = {}
    for kind in ("plain", "kernel"):
        ctx = (patched(measurement, "_full_rows", measurement.full_rows_ref)
               if kind == "plain" else contextlib.nullcontext())
        with ctx:
            _, s = blob_lap_session(dev, rows, redirect_at=(
                stretch + 17 if kind == "kernel" else None))
            s.run(n_frames=warm * chunk, chunk=chunk)
        sessions[kind] = s
    torch.cuda.synchronize()
    fps = {"plain": [], "kernel": []}
    stage = {"plain": [], "kernel": []}
    launched = {"plain": [], "kernel": []}
    for kind in ("plain", "kernel", "kernel", "plain"):
        s = sessions[kind]
        keys = len(s.capture_s)
        reset_counters(dev)
        before = vision.stage_times(dev)
        n0 = len(s.records)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run(n_frames=turn * chunk, chunk=chunk)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = vision.stage_times(dev)
        n = len(s.records) - n0
        fps[kind].append(n / dt)
        frames = max(after["frames"] - before["frames"], 1)
        stage[kind].append({k: (after[k] - before[k]) / frames / 1e6
                            for k in ("motion", "measure")})
        counts = read_counters(dev)
        launched[kind].append(([counts[k] for k in MEASURE_KERNELS], n))
        if len(s.capture_s) != keys:
            problems.append(f"{kind}: a capture inside a timed turn")
    census = {}
    for kind, s in sessions.items():
        census[kind] = dict(
            syncs=dispatch_census(s, chunk),
            profile=profile_chunk(s, chunk, f"measure {kind}"))
    # a stretch over the kernel session's forced redirect frame
    s = sessions["kernel"]
    reset_counters(dev)
    n0 = len(s.records)
    s.run(n_frames=2 * chunk, chunk=chunk)
    torch.cuda.synchronize()
    recs = s.records[n0:]
    tracked = sum(not r.redirected for r in recs)
    counts = read_counters(dev)
    redirect = dict(frames=len(recs),
                    redirected=sum(r.redirected for r in recs),
                    tracked=tracked,
                    launches=[counts[k] for k in MEASURE_KERNELS])
    problems += launch_problems(counts, tracked, "the redirect stretch",
                                measure=tracked)
    if not redirect["redirected"]:
        problems.append("no redirect frame in the redirect stretch")
    for kind, runs in launched.items():
        for got, n in runs:
            if got != [n if kind == "kernel" else 0] * 2:
                problems.append(f"{kind} route: {got} launches of "
                                f"{MEASURE_KERNELS} in {n} frames")
    out["routes"] = dict(fps=fps, stage_ms=stage, launches=launched,
                         redirect=redirect, census={
                             k: dict(syncs=c["syncs"],
                                     device_ops_per_frame=c["profile"][
                                         "device_ops_per_frame"],
                                     busy_ms_per_frame=c["profile"][
                                         "busy_ms_per_frame"])
                             for k, c in census.items()})
    for kind in ("plain", "kernel"):
        c = census[kind]
        stages = [{k: round(v, 4) for k, v in st.items()}
                  for st in stage[kind]]
        log(f"[measure] (d) [{smi}] {kind} route, chunk graphs of {chunk}: "
            f"frames/s {[round(f, 2) for f in fps[kind]]}; stage ms a frame "
            f"{stages}; {MEASURE_KERNELS} launches / frames {launched[kind]}; "
            f"synchronizing "
            f"calls dispatch / finish {c['syncs']}; profiled: "
            f"{c['profile']['device_ops_per_frame']:.1f} device ops a frame")
    log(f"[measure] (d) redirect stretch: {redirect}")
    for c in census.values():
        if c["syncs"][0]:
            problems.append(f"{c['syncs'][0]} synchronizing calls in a "
                            f"dispatch")
    if problems:
        raise AssertionError("measure checks failed: " + "; ".join(problems))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="after the smoke, profile a chunk")
    ap.add_argument("--config", type=int, choices=(1, 3, 4), default=1,
                    help="the configuration --profile looks at")
    ap.add_argument("--baseline", metavar="DIR",
                    help="another checkout of the port (e.g. the parent "
                         "commit's): phases 3b and 3c time its four "
                         "recurrence kernels and this tree's in turns on "
                         "the same inputs")
    ap.add_argument("--marks", action="store_true",
                    help="instead of the smoke, the build and the stage "
                         "marks' phase alone")
    ap.add_argument("--measure", action="store_true",
                    help="instead of the smoke, the build and the "
                         "measurement prediction's phase (3d) alone")
    ap.add_argument("--ranks", type=int, choices=(1, 4),
                    help="instead of the smoke, the multi-device paths on "
                         "this many NCCL ranks, a card each (fails on a "
                         "machine with fewer cards; 1 rehearses the four-"
                         "card run on one card)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import cv_monoslam_tpu_torch  # noqa: F401  (fails outside the repo)

    if args.ranks:
        return main_ranks(args.ranks, args.profile)

    dev = torch.device("cuda:0")
    info = card_info()
    log(f"[card] {info['kind']} x{info['count']}; nvidia-smi: {info['smi']}")
    log(f"[card] python {sys.version.split()[0]}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on: covariance math needs FP32")
    def run(phase, *a):
        t0 = time.perf_counter()
        out = phase(*a)
        log(f"[phase] {phase.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    run(phase_build)
    if args.measure:
        log(json.dumps({"measure": run(phase_measure, dev, info["smi"])}))
        return 0
    marks = run(phase_marks, dev)
    if args.marks:
        log(json.dumps({"marks": marks}))
        return 0
    errs = run(phase_kernel_checks, dev)
    times = run(phase_kernel_times, dev)
    meas = run(phase_measure, dev, info["smi"])
    baseline = load_baseline(args.baseline) if args.baseline else None
    gr = run(phase_chunk_graphs, dev, errs, times["launch_floor_ms"],
             baseline)
    sg = run(phase_step_graphs, dev, errs, times["launch_floor_ms"],
             baseline)
    sl = run(phase_slice, dev, errs)
    c3 = run(phase_config3, dev, errs)
    rd = run(phase_redirect, dev)
    run(phase_checkpoint, dev)
    c4 = run(phase_config4, dev, errs, info["smi"])
    run(phase_cli, info)
    ref = run(phase_reference, dev, info["smi"], baseline)
    md = run(phase_multidevice, dev, errs, c3, info["smi"])
    if args.profile:
        run(phase_profile, dev, args.config)

    meta = {
        "warp_ncc_score_map": dict(
            source="cv_monoslam_tpu_torch/ops/csrc/vision_kernels.cu",
            replaces="cv_monoslam_tpu/ops/pallas_vision.py:92 + "
                     "cv_monoslam_tpu/ops/pallas_vision.py:178 + "
                     "cv_monoslam_tpu/frontend/matching.py:151-153"),
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
                 launches_config3_dist_chol=md["b"]["launches"][name],
                 launches_landmark_step=md["d"]["launches"][name],
                 launches_four_ranks=[r[name] for r in
                                      md["e"]["launches_per_rank"]],
                 launches_reference=ref["launches"][name],
                 launches_step_graphs=sg["b"]["launches"][name],
                 launches_shard_sqrt=md["f"]["launches"][name],
                 launches_shard_sqrt_four_ranks=[
                     r[name] for r in md["f4"]["launches_per_rank"]],
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
        if name == "warp_ncc_score_map":
            k.update(max_abs_err_warped=errs["warp_ncc_warped"],
                     max_abs_err_p_hat=errs["warp_ncc_p_hat"],
                     max_abs_err_on_own_p_hat=errs["warp_ncc_core"],
                     max_abs_diff_chain=errs["warp_ncc_chain"])
            for sfx, t in (("", t32), ("_m576", t576), ("_m16", t16)):
                k.update({f"{key}{sfx}": t[key] for key in (
                    "chain_ms", "chain_host_ms", "kernel_only_l2_ms")})
        if "kernel_only_ms" in t32:
            k["kernel_only_ms"] = t32["kernel_only_ms"]
            k["kernel_only_ms_m576"] = t576["kernel_only_ms"]
            k["kernel_only_ms_m16"] = t16["kernel_only_ms"]
        if "grid_sample_ms" in t32:
            k["grid_sample_ms"] = t32["grid_sample_ms"]
            k["grid_sample_ms_m576"] = t576["grid_sample_ms"]
        kernels.append(k)
    scan_meta = {
        "store_slots": dict(
            replaces="cv_monoslam_tpu/filter/lifecycle.py:136-165 (a "
                     "lax.scan of lax.cond, no Pallas kernel)",
            times=gr["scan_times"]["store_slots"], suffix="heavy"),
        "gftt_greedy_nms": dict(
            replaces="cv_monoslam_tpu/frontend/detect.py:91-128 (a "
                     "blocked lax.scan, no Pallas kernel)",
            times=gr["scan_times"]["gftt_greedy_nms_k768"], suffix="k48"),
    }
    for name, mt in scan_meta.items():
        t = mt["times"]
        k = dict(name=name, route="cuda",
                 source="cv_monoslam_tpu_torch/ops/csrc/scan_kernels.cu",
                 replaces=mt["replaces"], launches=sl["launches"][name],
                 launches_config3=c3["launches"][name],
                 launches_redirect=rd["launches"][name],
                 launches_config4=c4["launches"][name],
                 launches_reference=ref["launches"][name],
                 launches_step_graphs=sg["b"]["launches"][name],
                 max_abs_err=errs[name], ms=t["ms"], plain_ms=t["plain_ms"],
                 bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                 library_ms=None, host_ms=t["host_ms"], shape=t["shape"],
                 launch_floor_ms=times["launch_floor_ms"],
                 steps=t["steps"], us_per_step=t["us_per_step"],
                 ms_runs=t["ms_runs"], baseline_ms=t["baseline_ms"],
                 alt_ms=t["alt_ms"])
        other = ("store_slots_heavy" if name == "store_slots"
                 else "gftt_greedy_nms_k48")
        to, sfx = gr["scan_times"][other], mt["suffix"]
        k.update({f"{key}_{sfx}": to[key] for key in (
            "ms", "plain_ms", "bound_ms", "shape", "steps", "us_per_step",
            "ms_runs", "baseline_ms", "alt_ms")})
        kernels.append(k)
    linalg_meta = {
        "rank_rotate": dict(
            replaces="cv_monoslam_tpu/ops/linalg.py:191-271 (_rank1_rotate "
                     "scanned over U's rows by chol_update / chol_downdate; "
                     "lax.scan, no Pallas kernel)",
            main="rank_rotate_n196_float32", mode="sequential"),
        "gmw_chol": dict(
            replaces="cv_monoslam_tpu/ops/linalg.py:148-188 (lax.scan, no "
                     "Pallas kernel)",
            main="gmw_chol_n196_float32", mode="sequential_gmw"),
    }
    for name, mt in linalg_meta.items():
        t = sg["times"][mt["main"]]
        k = dict(name=name, route="cuda",
                 source="cv_monoslam_tpu_torch/ops/csrc/linalg_kernels.cu",
                 replaces=mt["replaces"],
                 launches=sg["d"][mt["mode"]]["launches"][name],
                 launches_modes={m: sg["d"][m]["launches"][name]
                                 for m, _, _ in MODES},
                 launches_faithful=ref["launches_faithful"][name],
                 launches_config1=sl["launches"][name],
                 launches_config3=c3["launches"][name],
                 launches_config4=c4["launches"][name],
                 max_abs_err=errs[name], ms=t["ms"], plain_ms=t["plain_ms"],
                 bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                 library_ms=t["library_ms"], host_ms=t["host_ms"],
                 shape=t["shape"], steps=t["steps"],
                 us_per_step=t["us_per_step"], latency_ms=t["latency_ms"],
                 ms_runs=t["ms_runs"], baseline_ms=t["baseline_ms"],
                 launch_floor_ms=times["launch_floor_ms"])
        extra = ("ms_spd", "library_rel_diff") if name == "gmw_chol" \
            else ("chol_gram_ms",)
        k.update({f: t[f] for f in extra})
        for key, tk in sg["times"].items():
            if key.startswith(name) and key != mt["main"]:
                sfx = key[len(name) + 1:]
                k.update({f"{f}_{sfx}": tk[f] for f in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "steps",
                    "us_per_step", "library_ms", "latency_ms", "ms_runs",
                    "baseline_ms") + extra})
        kernels.append(k)
    t = meas["time"]
    for name in MEASURE_KERNELS:
        kernels.append(dict(
            name=name, route="cuda",
            source="cv_monoslam_tpu_torch/ops/csrc/vision_kernels.cu",
            replaces="cv_monoslam_tpu_torch/filter/measurement.py::"
                     "full_rows_ref but its two reductions "
                     "(cv_monoslam_tpu/filter/measurement.py:41-62 + "
                     "178-198, sigma_mode='full'; no Pallas kernel)",
            launches=sl["launches"][name],
            launches_config3=c3["launches"][name],
            launches_redirect=rd["launches"][name],
            launches_config4=c4["launches"][name],
            **{f"{k}_{dt}": meas[dt][k] for dt in ("float32", "float64")
               for k in ("flips", "pix_differ", "pred_differ",
                         "si_differ")},
            ms=t[f"{name[8:]}_ms"], host_ms=t[f"{name[8:]}_host_ms"],
            route_ms=t["route_ms"], plain_ms=t["plain_ms"],
            plain_host_ms=t["plain_host_ms"],
            bound_ms=t["bound_ms"] if name == "measure_project" else None,
            bound_by=t["bound_by"] if name == "measure_project" else None,
            library_ms=None, launch_floor_ms=t["launch_floor_ms"],
            device_ops_per_frame={k: c["device_ops_per_frame"] for k, c in
                                  meas["routes"]["census"].items()}))
    for name in ("config1", "config3", "config4"):
        g = gr[name]
        log(f"[graphs] {name} [{info['smi']}]: frames/s graph "
            f"{g['fps']['graph']} eager {g['fps']['eager']}; capture "
            f"{g['capture_s']} s; dispatch syncs/frame "
            f"{g['dispatch_syncs_per_frame']}")
    log(f"[slice] config 1, bench1_arc, float32: {sl['fps']:.2f} frames/s "
        f"over {sl['timed_frames']} frames; ATE {sl['ate_m']:.5f} m "
        f"(64 frames: {sl['ate64_m']:.5f} m)")
    log(f"[config3] M=576 D=3460, bench3_grid, float32: {c3['fps']:.2f} "
        f"frames/s over {c3['frames']} frames; ATE {c3['ate_m']:.5f} m; peak "
        f"matched {c3['peak_matched']}")
    bg = c4["backend_graphs"]["ms"]
    log(f"[config4] backend: refine_window median "
        f"{bg['graph']['refine_window']['median']:.3f} ms by the graph "
        f"route, {bg['eager']['refine_window']['median']:.3f} ms eager; "
        f"graph == eager {c4['backend_graphs']['equal']}")
    log(f"[config4] M=16, bench4_lap, float32: {c4['fps_capture']:.2f} "
        f"frames/s with capture, {c4['fps_live']:.2f} with the live backend; "
        f"ATE filter {c4['ate_filter']:.4f} m -> refined "
        f"{c4['ate_refined']:.4f} m; {c4['summary']['keyframes']} keyframes, "
        f"{c4['summary']['loop_edges']} loop edges")
    log(f"[multidevice] config 3 through dist_chol: {md['b']['fps']:.2f} "
        f"frames/s by the graph route; same windows graph "
        f"{md['b']['routes']['graph']} / eager {md['b']['routes']['eager']} "
        f"frames/s; dist_chol as a graph {md['a']['ms']:.3f} ms wall "
        f"({md['a']['device_busy_ms']:.3f} device-busy), eager "
        f"{md['a']['eager_ms']:.3f} ms, vs cholesky_ex "
        f"{md['a']['library_ms']:.3f} ms at n={md['a']['n']}; BA config 5 "
        f"{md['c']['ms_per_iter_sharded']:.3f} ms/iteration sharded "
        f"(captured), {md['c']['ms_per_iter_single_graph']:.3f} single by "
        f"a graph, {md['c']['ms_per_iter_single']:.3f} single eager")
    log(f"[reference] (R2) ATE {ref['ate_port']:.6f} m vs oracle "
        f"{ref['ate_oracle']:.6f} m; (R3) {ref['identical']}/50 identical, "
        f"Jaccard {ref['jaccard']:.3f}; faithful mode frames/s by step "
        f"graphs {ref['r3_fps_graph']:.2f}, eager {ref['r3_fps_eager']:.2f}")
    b = sg["b"]
    log(f"[steps] [{info['smi']}] config 1 run(chunk=1) frames/s graph "
        f"{b['fps']['graph']} eager {b['fps']['eager']}; capture "
        f"{b['capture_s']} s; modes (window of 8, graph == eager): " +
        ", ".join(f"{m} capture {sg['d'][m]['capture_s']} s" for m, _, _
                  in MODES))
    log(info["smi"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": info["kind"],
                                           "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
