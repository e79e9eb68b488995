"""One run of one cell: set-up, the measured window, the traced stretch,
the check, and the result line's contents."""

from __future__ import annotations

import gc
import subprocess
import time
from typing import Callable, Optional

import numpy as np
import torch

from slambench import check, driving, harness, lap as lapmod, trace

#: odometry rows the run gets for each second of window: above any rate the
#: port reaches on one card (config 1 by chunks: 434-524 frames/s)
ROWS_PER_S = 1000
ROWS_SPARE = 3000


def card_line(device) -> str:
    """The card's name, power limit, SM clock (now and its maximum), power
    draw and temperature, as ``nvidia-smi`` reads them."""
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,power.draw,temperature.gpu",
             "--format=csv,noheader", "-i", str(torch.device(device).index
                                                or 0)],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def run(bench: dict, cell: dict, seed: int, seconds: float, traced: bool,
        device, t_start: Optional[float] = None,
        log: Callable[..., None] = print, overrides: Optional[dict] = None,
        base: str = harness.HERE, tf32: bool = False,
        traffic_overrides: Optional[dict] = None, judge: bool = True):
    """Run ``cell`` once; returns (the result line as a dict, the compared
    numbers as ``(name, value, limit)`` rows). ``overrides`` and
    ``traffic_overrides`` change configuration fields (``session`` the
    session's attributes) and traffic entries (the CPU tests' tiny sizes); ``tf32`` runs the program with TF32
    matmuls (the control, never a benchmark run); ``judge=False`` skips
    the reference (the ranks of a mesh other than rank 0)."""
    t_start = time.perf_counter() if t_start is None else t_start
    split = {}
    mark = [t_start]

    def lap_time(name):
        now = time.perf_counter()
        split[name] = now - mark[0]
        mark[0] = now

    lap_time("python_and_torch_import")
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.io.dataset import (ImageSequence,
                                                  preprocess_odometry)

    lap_time("program_import")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
    lap_time("cuda_init")
    if dev.type == "cuda":
        from cv_monoslam_tpu_torch.ops import _build

        _build.build()
    lap_time("kernel_build_or_load")

    cdoc = harness.config(cell["config"], base)
    tdoc = {**harness.traffic(cell["traffic"], base),
            **(traffic_overrides or {})}
    overrides = dict(overrides or {})
    session = {**cdoc.get("session", {}), **overrides.pop("session", {})}
    fields = {**cdoc["slam"], **overrides}
    cfg = SlamConfig(**fields)
    c = cfg.camera
    cam = lapmod.Camera(c.width, c.height, c.dx, c.dy, c.cx, c.cy, c.k1,
                        c.k2, c.f)
    count = int(ROWS_PER_S * seconds) + ROWS_SPARE
    lap = lapmod.make_lap(tdoc, seed, cam, cfg.deep, count, dev)
    seq = ImageSequence(frames=lap.frames)
    track = preprocess_odometry(lap.raw, min_step_xy=cfg.min_step_xy,
                                min_step_theta=cfg.min_step_theta,
                                capacity=count)
    if len(track) < count or track.redirect.any():
        raise RuntimeError("the lap's odometry lost rows or turned by more "
                           "than the redirection threshold")
    lap_time("lap_render")

    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    ctx = driving.Ctx(cfg=cfg, session=session, traffic=tdoc,
                      seq=seq, track=track, frames=lap.frames, device=dev)
    route = harness.route(tdoc["route"], base).Route(ctx)
    start = (driving.to_host(route.sess.state),
             lap.frames[int(track.frame_id[0])], float(track.theta[0]))
    lap_time("session_init")
    route.warm()
    captured = sum(route.sess.capture_s.values())
    lap_time("capture_and_warm_up")
    split["graph_capture"] = captured
    split["warm_up"] = split.pop("capture_and_warm_up") - captured
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    win = route.window(seconds, driving.Plan(tdoc, seed, seconds))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    t = None
    if traced:
        # the same frames from the same state twice: unprofiled for the
        # wall time a frame, then profiled for the device's share of it
        at = driving.mark(route.sess)
        driving.sync(dev)
        t0 = driving.clock()
        n_plain = route.stretch()
        driving.sync(dev)
        plain_us = (driving.clock() - t0) / n_plain * 1e6
        driving.rewind(route.sess, at)
        del at
        frames, wall, doc = trace.record(
            route.stretch, lambda: driving.sync(dev), driving.clock)
        t = trace.parse(doc, frames, wall, plain_us, cfg.max_landmarks)
        del doc
    recs = route.sess.records
    window_recs = [r for r in recs if r.frame >= win.first_frame][
        :win.frames]
    ate = driving.ate(window_recs, track, lap.gt_xy)
    stretch_detect = getattr(route, "stretch_detect", None)
    card = card_line(dev)
    route.release()
    del route
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log(f"[card] {card}")
    log("[setup] " + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
        + f"; setup_s {setup_s:.3f}; lap {len(lap.frames)} frames rendered "
        f"in {lap.render_s:.3f} s")
    h = win.health
    log(f"[window] {win.frames} frames recorded of {win.attempted} handed "
        f"over in {win.wall_s:.3f} s; failed {win.failed}; escalated "
        f"repairs {h['escalations']}, skipped updates {h['skipped']}; peak "
        f"matched {h['peak_matched']}, mean matched {h['mean_matched']:.1f}; "
        f"ATE {ate:.5f} m over the window; memory peak {peak} bytes; "
        f"detect chunks {h.get('detect_chunks')}")
    if win.latencies_s:
        lat = np.asarray(win.latencies_s) * 1e3
        log(f"[window] {len(lat)} frame latencies: median "
            f"{np.median(lat):.4f} ms, p95 {np.percentile(lat, 95):.4f} ms, "
            f"max {lat.max():.4f} ms")

    t0 = time.perf_counter()
    numbers = check.judge(win.samples if judge else [], fields, lap.raw, dev,
                          log=log, start=start if judge else None,
                          chained=int(tdoc["check"].get("chained", 0)))
    lim = harness.limits(cell["name"], base)
    correct, rows = check.verdict(numbers, lim)
    log(f"[check] {numbers['samples']} samples, {numbers['frames']} frames "
        f"judged in {time.perf_counter() - t0:.3f} s; taken over at knife "
        f"edges: {numbers.get('taken', {})}; adopted on a chunk's later "
        f"frames: {numbers.get('adopted', {})}"
        + (" (TF32 on: the control)" if tf32 else ""))

    metrics = {}
    section = "per_layer" if traced else "end_to_end"
    for m in harness.cell_metrics(bench, cell["name"], section):
        mod = harness.metric(m["name"], base)
        value = (mod.read(t, cell) if traced else
                 mod.read(win, setup_s))
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"),
               "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(win.attempted),
              "failed": int(win.failed), "metrics": metrics,
              "device": devinfo}
    if traced:
        devinfo["busy_s"] = t.busy_us() * 1e-6
        devinfo["window_s"] = t.window_us * 1e-6
        log(f"[trace] {t.frames} frames in {t.window_us / 1e3:.3f} ms "
            f"profiled ({t.window_us / t.frames / 1e3:.4f} ms a frame; the "
            f"same frames unprofiled {t.wall_us_per_frame / 1e3:.4f}; the "
            f"window {win.wall_s / max(win.frames, 1) * 1e3:.4f}); busy "
            f"{t.busy_us() / 1e3:.3f} ms; {len(t.device)} device ops; "
            f"detect chunks {stretch_detect}")
        result["breakdown"] = trace.breakdown(t)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in rows}
    return result, rows


def rank_main(dev, bench: dict, cell: dict, seed: int, seconds: float,
              traced: bool, t_start: float, overrides=None,
              traffic_overrides=None, base: str = harness.HERE):
    """One rank of a cell on several cards (``parallel.launch.spawn``):
    the whole run, the reference on rank 0 only."""
    import sys

    import torch.distributed as dist

    rank = dist.get_rank()

    def log(*a):
        print(f"[rank {rank}]", *a, file=sys.stderr, flush=True)

    return run(bench, cell, seed, seconds, traced, dev, t_start=t_start,
               log=log, overrides=overrides,
               traffic_overrides=traffic_overrides, base=base,
               judge=rank == 0)


def merge(outs: list) -> tuple:
    """Rank 0's line, with the fullest card's memory peak and, traced, the
    ranks' device-busy time averaged."""
    result, rows = outs[0]
    dev = result["device"]
    dev["memory_peak_bytes"] = int(max(
        o[0]["device"]["memory_peak_bytes"] for o in outs))
    if "busy_s" in dev:
        dev["busy_s"] = float(np.mean([o[0]["device"]["busy_s"]
                                       for o in outs]))
    result["checks"] = result.pop("checks")
    return result, [tuple(r) for r in rows]
