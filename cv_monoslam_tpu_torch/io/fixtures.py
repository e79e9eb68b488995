"""Frozen benchmark fixtures — load only.

The committed regression dataset lives in ``fixtures/<name>.npz`` (uint8
frames + raw odometry + ground truth) with its sha256 in
``fixtures/MANIFEST.json``. ``load()`` verifies the file hash against the
manifest and refuses to run on mismatched bytes: at the reference's
tiny-map defaults GFTT corner selection is a knife edge, so a silently
different input would read as a behaviour change. This package never
regenerates fixtures; they are rendered and re-anchored by
``scripts/make_fixtures.py`` with the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np

from ..config import SlamConfig
from .dataset import ImageSequence, preprocess_odometry

FIXTURES_DIR = os.path.join(os.path.dirname(__file__), "..", "..",
                            "fixtures")
MANIFEST = os.path.join(FIXTURES_DIR, "MANIFEST.json")

#: renderer tag the committed fixtures must carry
RENDERER_VERSION = "v5"


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
