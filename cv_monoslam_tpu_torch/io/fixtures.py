"""Frozen benchmark fixtures — the committed regression dataset.

The committed regression dataset lives in ``fixtures/<name>.npz`` (uint8
frames + raw odometry + ground truth) with its sha256 in
``fixtures/MANIFEST.json``. ``load()`` verifies the file hash against the
manifest and refuses to run on mismatched bytes: at the reference's
tiny-map defaults GFTT corner selection is a knife edge, so a silently
different input would read as a behaviour change. ``build()`` renders a
fixture from its spec with this package's ``io/synthetic.py`` and
(re-)anchors its manifest entry; it writes into ``FIXTURES_DIR``, so point
that elsewhere to render without touching the committed files. ``SPECS``,
``RENDERER_VERSION`` and the rendering are those of
``cv_monoslam_tpu/io/fixtures.py``, and give the committed bytes.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np

from ..config import SlamConfig
from .dataset import ImageSequence, preprocess_odometry
from .synthetic import (make_sequence, make_trajectory, make_world,
                        make_world_periodic, noisy_odometry)

FIXTURES_DIR = os.path.join(os.path.dirname(__file__), "..", "..",
                            "fixtures")
MANIFEST = os.path.join(FIXTURES_DIR, "MANIFEST.json")

#: renderer tag the committed fixtures must carry; bump it with an
#: intentional change of the renderer's math, so load() demands rebuilt
#: fixtures instead of comparing new code against old bytes
RENDERER_VERSION = "v5"

# Generation specs. "traj" fixtures follow io/synthetic.get_sequence
# semantics (random-blob world + control-space odometry noise); "dense"
# follows scripts/bench_large.dense_sequence (grid world, clean odometry).
SPECS = {
    # config 1: the standard-engine headline scenario
    "bench1_arc": dict(kind="traj", traj="arc", n=105, seed=0, noise=0.0,
                       step=0.03),
    # config 4: loop-closure drift regime (1.25 laps, heading noise)
    "bench4_lap": dict(kind="traj", traj="lap", n=120, seed=0, noise=0.04,
                       step=0.12),
    # config 3: large-state capacity scenario (grid ceiling, slow arc);
    # spacing 0.06 m = ~15.4 px pitch: outside the +-10 px NCC search
    # window and the 10 px min-dist, dense enough that GFTT's supply
    # exceeds 500
    "bench3_grid": dict(kind="dense", n=84, seed=0, spacing=0.06,
                        jitter=0.012, step=0.008),
    # parity scenario (config1_parity "loop@0.06")
    "parity_loop": dict(kind="traj", traj="loop", n=105, seed=0, noise=0.0,
                        step=0.06),
}


def _generate(name: str) -> dict:
    spec = SPECS[name]
    cfg = SlamConfig()
    if spec["kind"] == "traj":
        world = make_world(seed=spec["seed"], cfg=cfg)
        xy, th = make_trajectory(spec["traj"], n=spec["n"],
                                 step=spec["step"])
        seq, _, gt_xy, gt_th = make_sequence(world, xy, th, cfg=cfg)
        odo_xy, odo_th = noisy_odometry(
            xy, th, np.random.default_rng(spec["seed"] + 1),
            sigma_rot=spec["noise"])
        raw = np.concatenate([
            np.arange(spec["n"], dtype=np.float64)[:, None], odo_xy,
            odo_th[:, None]], axis=1)
    else:
        world = make_world_periodic(seed=spec["seed"],
                                    spacing=spec["spacing"],
                                    jitter=spec["jitter"], cfg=cfg)
        xy, th = make_trajectory("arc", n=spec["n"], step=spec["step"])
        seq, _, gt_xy, gt_th = make_sequence(world, xy, th, cfg=cfg)
        raw = np.concatenate([
            np.arange(spec["n"], dtype=np.float64)[:, None], xy,
            th[:, None]], axis=1)
    # uint8 quantization is part of the fixture definition: the committed
    # bytes are the dataset
    frames = np.round(np.asarray(seq._frames)).astype(np.uint8)
    return dict(frames=frames, raw=raw, gt_xy=gt_xy, gt_th=gt_th)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _read_manifest() -> dict:
    if not os.path.exists(MANIFEST):
        return {"renderer": None, "files": {}}
    with open(MANIFEST) as f:
        return json.load(f)


def build(name: str, force: bool = False) -> str:
    """Render fixture ``name`` into ``FIXTURES_DIR`` and (re-)anchor its
    manifest entry; returns the file's path. An anchored file is kept
    unless ``force``."""
    os.makedirs(FIXTURES_DIR, exist_ok=True)
    path = os.path.join(FIXTURES_DIR, name + ".npz")
    man = _read_manifest()
    if os.path.exists(path) and not force and name in man["files"]:
        return path
    arrays = _generate(name)
    np.savez_compressed(path, **arrays)
    man["renderer"] = RENDERER_VERSION
    man["files"][name] = dict(sha256=_sha256(path), spec=SPECS[name],
                              shape=list(arrays["frames"].shape))
    with open(MANIFEST, "w") as f:
        json.dump(man, f, indent=1, sort_keys=True)
    return path


def load(name: str, min_step_xy: Optional[float] = None,
         min_step_theta: Optional[float] = None):
    """Load a committed fixture, verifying its bytes against the manifest.

    Returns ``(ImageSequence, OdometryTrack, gt_xy, gt_th)``. Raises if
    the file is missing, its hash mismatches the manifest, or the
    manifest's renderer tag is stale.
    """
    path = os.path.join(FIXTURES_DIR, name + ".npz")
    man = _read_manifest()
    if name not in man["files"]:
        raise FileNotFoundError(f"fixture {name!r} not in manifest")
    if man.get("renderer") != RENDERER_VERSION:
        raise RuntimeError(
            f"fixture manifest renderer {man.get('renderer')!r} != "
            f"{RENDERER_VERSION!r}")
    got = _sha256(path)
    want = man["files"][name]["sha256"]
    if got != want:
        raise RuntimeError(
            f"fixture {name} bytes changed (sha256 {got[:12]} != manifest "
            f"{want[:12]})")
    cfg = SlamConfig()
    d = np.load(path)
    track = preprocess_odometry(
        d["raw"],
        min_step_xy=cfg.min_step_xy if min_step_xy is None else min_step_xy,
        min_step_theta=(cfg.min_step_theta if min_step_theta is None
                        else min_step_theta))
    return (ImageSequence(frames=d["frames"]), track, d["gt_xy"],
            d["gt_th"])
