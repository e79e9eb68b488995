"""The benchmark's renderer on the device path (here the CPU) against the
port's NumPy renderer: every pixel within one uint8 step."""

import numpy as np
import pytest
import torch

from slambench import harness, lap


@pytest.mark.parametrize("mix", ["blob_lap", "grid_lap"])
def test_torch_render_matches_numpy(mix):
    from cv_monoslam_tpu_torch import SlamConfig
    from cv_monoslam_tpu_torch.io.synthetic import SyntheticWorld

    cfg = SlamConfig()
    c = cfg.camera
    cam = lap.Camera(c.width, c.height, c.dx, c.dy, c.cx, c.cy, c.k1, c.k2,
                     c.f)
    t = harness.traffic(mix)
    blobs = lap.make_blobs(int(t["world"]["seed"]), t["world"])
    world = SyntheticWorld(cam=c, deep=cfg.deep, blobs=blobs)
    n = int(t["lap"]["frames"])
    _, xy, th = lap.lap_poses(n, float(t["lap"]["step_m"]), n)
    pick = [0, n // 3, n - 1]
    got = lap.render(blobs, cam, cfg.deep, xy[pick], th[pick], "cpu")
    got = torch.round(got.to(torch.float32)).to(torch.uint8).numpy()
    for j, i in enumerate(pick):
        want = np.round(world.render(xy[i], th[i])).astype(np.uint8)
        diff = np.abs(got[j].astype(int) - want.astype(int))
        assert diff.max() <= 1, (mix, i, diff.max())
