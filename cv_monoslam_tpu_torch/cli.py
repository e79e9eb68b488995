"""Command-line front end — the engine's replacement for the reference's GUI
shell (C19 CMonoSLAMView STEP/AUTO buttons, MonoSLAMView.cpp:499-572; C20
CSetParameters dialog, SetParameters.cpp:22-248).

Subcommands:
  run    — SLAM over an image directory + odometry text file (the
           reference's release-model file pickers) or a synthetic sequence
           (the debug-model hard-coded dataset, SLAM.cpp:205-213).
  synth  — generate + cache a synthetic ceiling sequence.
  info   — torch / device report.

Every CSetParameters knob is reachable via --config (JSON file with
SlamConfig fields) or --set key=value overrides. Everything runs on the CUDA
device unless ``--device`` names another (``--device cpu`` must be asked
for).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np


def _load_config(args) -> "SlamConfig":
    from .config import CameraConfig, SlamConfig

    if args.config:
        with open(args.config) as f:
            cfg = SlamConfig.from_json(f.read())
    else:
        cfg = SlamConfig()
    overrides = {}
    cam_overrides = {}
    for kv in args.set or []:
        key, _, val = kv.partition("=")
        try:
            val = json.loads(val)
        except json.JSONDecodeError:
            pass
        if key.startswith("camera."):
            cam_overrides[key[len("camera."):]] = val
        else:
            overrides[key] = val
    if cam_overrides:
        overrides["camera"] = dataclasses.replace(cfg.camera, **cam_overrides)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def _make_recorder(args, out_dir):
    from .io.recording import RunRecorder

    if not args.record:
        return None
    return RunRecorder(
        robot_path=os.path.join(out_dir, "RobotPath.txt"),
        features_path=os.path.join(out_dir, "FeaturesInfo.txt"),
        metrics_path=os.path.join(out_dir, "metrics.jsonl"),
    )


def cmd_run(args) -> int:
    from .api import SlamSession
    from .io.dataset import ImageSequence, load_odometry_file
    from .utils.watchdog import Watchdog

    cfg = _load_config(args)
    out_dir = args.out or "slam_out"
    os.makedirs(out_dir, exist_ok=True)

    if (args.images or args.video) and args.odometry:
        track = load_odometry_file(
            args.odometry, min_step_xy=cfg.min_step_xy,
            min_step_theta=cfg.min_step_theta, capacity=cfg.capacity)
        if args.video:
            # reference m_playType video mode (SLAM.cpp:288-309)
            from .io.video import VideoSequence

            images = VideoSequence(args.video)
        else:
            images = ImageSequence(pattern=args.images)
        gt_xy = None
    else:
        # synthetic debug-model run (reference debug paths, SLAM.cpp:205-213)
        from .io.synthetic import get_sequence

        images, track, gt_xy, _ = get_sequence(args.traj, args.frames,
                                               args.seed)

    wd = Watchdog(cfg) if args.watchdog else None
    backend = None
    if args.backend:
        from .backend.session import BackendSession

        backend = BackendSession(cfg, device=args.device)
    kw = dict(recorder=_make_recorder(args, out_dir),
              checkpoint_dir=(os.path.join(out_dir, "ckpt")
                              if args.checkpoint else None),
              checkpoint_every=args.checkpoint_every,
              watchdog=wd, backend=backend, device=args.device)
    if args.resume:
        sess = SlamSession.resume(args.resume, images, track, **kw)
    else:
        sess = SlamSession(cfg, images, track, **kw)

    n = args.frames if (args.images or args.video) else None
    if args.trace:
        from .utils.profiling import trace

        with trace(args.trace):
            sess.run(n, chunk=args.chunk)
        print(f"trace -> {os.path.join(args.trace, 'trace.json')}")
    else:
        sess.run(n, chunk=args.chunk)
    traj = sess.trajectory
    np.savez(os.path.join(out_dir, "trajectory.npz"),
             poses=traj,
             frames=np.array([r.frame for r in sess.records]),
             wall_times=np.array([r.wall_time for r in sess.records]))
    from .ops.vision import stage_times
    from .utils.profiling import report

    wall = sum(r.wall_time for r in sess.records)
    print(f"frames: {len(sess.records)}  wall: {wall:.3f} s "
          f"({wall * 1e3 / max(len(sess.records), 1):.2f} ms a frame)")
    print(report(stage_times(sess.device)))
    if gt_xy is not None and len(sess.records):
        print(f"ATE: {sess.ate(gt_xy):.4f} m")
    if backend is not None and backend.keyframes:
        gout = backend.optimize_graph()
        kf_poses = np.stack([k.pose for k in backend.keyframes])
        np.savez(os.path.join(out_dir, "keyframes.npz"),
                 poses=kf_poses,
                 frames=np.array([k.frame for k in backend.keyframes]))
        n_ref = len(sess.refinements)
        last = sess.refinements[-1] if n_ref else None
        print(f"backend: {len(backend.keyframes)} keyframes, {n_ref} BA "
              f"solves"
              + (f", last rmse {last['rmse_before']:.2f}->"
                 f"{last['rmse_after']:.2f} px" if last else "")
              + (f", {gout['n_loop_edges']} loop edges" if gout else ""))
    if args.viz and len(sess.records):
        from . import viz

        odo = np.stack([track.xy[r.frame] for r in sess.records])
        covs = np.stack([np.diag(r.pose_sqrt_cov[:2] ** 2)
                         for r in sess.records])
        viz.plot_trajectory(
            traj[:, :2], odo, pose_covs=covs,
            gt_xy=gt_xy[[r.frame for r in sess.records]]
            if gt_xy is not None else None,
            landmarks=sess.state.lm.xyz[sess.state.lm.active].cpu().numpy(),
            path=os.path.join(out_dir, "trajectory.png"))
        viz.plot_map3d(sess.state, cfg, est_path=traj[:, :2],
                       path=os.path.join(out_dir, "map3d.png"))
        img = images.get(int(track.frame_id[sess.counter - 1]))
        viz.draw_overlay(img, sess.state, cfg,
                         path=os.path.join(out_dir, "overlay.png"),
                         frame=sess.counter - 1)
        print(f"viz -> {out_dir}/trajectory.png, map3d.png, overlay.png")
    if sess.recorder is not None:
        sess.recorder.close()
        print(f"records -> {out_dir}/RobotPath.txt, FeaturesInfo.txt, "
              f"metrics.jsonl")
    return 0


def cmd_synth(args) -> int:
    from .io.synthetic import get_sequence

    images, track, gt_xy, gt_th = get_sequence(args.traj, args.frames,
                                               args.seed)
    print(f"sequence '{args.traj}' n={args.frames} seed={args.seed}: "
          f"{len(track)} kept frames (cached)")
    return 0


def cmd_info(args) -> int:
    import torch

    from .config import SlamConfig
    from .filter.state import resolve_device

    dev = resolve_device(args.device)
    print("torch:", torch.__version__)
    print("device:", dev,
          f"({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
          else "")

    print("default config:")
    print(SlamConfig().to_json())
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cv-monoslam-tpu-torch",
        description="monocular ceiling-vision SRUKF SLAM on PyTorch/CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run SLAM (AUTO mode)")
    pr.add_argument("--images", help="printf pattern, e.g. data/%%04d.jpg")
    pr.add_argument("--video", help=".avi video file (reference video play mode)")
    pr.add_argument("--odometry", help="reference-format odometry text file")
    pr.add_argument("--traj", default="arc",
                    help="synthetic trajectory if no dataset given")
    pr.add_argument("--frames", type=int, default=30)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--config", help="SlamConfig JSON file")
    pr.add_argument("--set", action="append", metavar="KEY=VAL",
                    help="config override (repeatable)")
    pr.add_argument("--out", help="output directory")
    pr.add_argument("--record", action="store_true",
                    help="write RobotPath.txt / FeaturesInfo.txt / metrics")
    pr.add_argument("--viz", action="store_true",
                    help="write trajectory/map/overlay PNGs")
    pr.add_argument("--checkpoint", action="store_true")
    pr.add_argument("--checkpoint-every", type=int, default=50,
                    metavar="N", help="with --checkpoint: save every N "
                                      "frames (default 50)")
    pr.add_argument("--resume", help="checkpoint file to resume from")
    pr.add_argument("--chunk", type=int, default=1,
                    help="frames per image upload and telemetry fetch; >1 "
                         "is fastest, telemetry at chunk granularity")
    pr.add_argument("--watchdog", action="store_true",
                    help="enable divergence watchdog")
    pr.add_argument("--backend", action="store_true",
                    help="keyframe backend: sliding-window BA + pose graph")
    pr.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu must be asked "
                         "for)")
    pr.add_argument("--trace", metavar="DIR",
                    help="profile the run: DIR/trace.json (Chrome trace) "
                         "with the host spans and the device's stage marks")
    pr.set_defaults(fn=cmd_run)

    ps = sub.add_parser("synth", help="generate/cache a synthetic sequence")
    ps.add_argument("--traj", default="arc")
    ps.add_argument("--frames", type=int, default=30)
    ps.add_argument("--seed", type=int, default=0)
    ps.set_defaults(fn=cmd_synth)

    pi = sub.add_parser("info", help="torch / device / config report")
    pi.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    pi.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
