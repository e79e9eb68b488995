"""The ``ranks`` route rehearsed on the CPU: a throwaway cell of four
``gloo`` ranks at a tiny size, config 3's modes through ``dist_chol`` in
both layouts, driven as ``run.py`` drives a cell of more than one chip.
Unproven on the card: no cell of ``BENCHMARK.json`` takes this route."""

import json
import os
import shutil
import time

import pytest

from slambench import cells, harness
from slambench.tests import tiny


def _rehearse(tmp_path, shard_sqrt):
    """A throwaway four-rank cell run as ``run.py`` runs one: the merged
    line and each rank's."""
    from cv_monoslam_tpu_torch.parallel import launch

    base = str(tmp_path)
    for kind in ("routes", "metrics"):
        shutil.copytree(os.path.join(harness.HERE, kind),
                        os.path.join(base, kind))
    for kind in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(base, kind))
    cfg = harness.config("grid_m576")
    cfg["slam"]["dist_chol_panel"] = 8
    cfg["session"]["shard_sqrt"] = shard_sqrt
    with open(os.path.join(base, "configs", "grid_m576_dist4.json"),
              "w") as f:
        json.dump(cfg, f)
    t = harness.traffic("grid_lap")
    t["route"] = "ranks"
    with open(os.path.join(base, "traffic", "grid_lap_ranks.json"),
              "w") as f:
        json.dump(t, f)
    shutil.copy(os.path.join(harness.HERE, "limits", "m576_replay.json"),
                os.path.join(base, "limits", "m576_dist4.json"))
    cell = dict(name="m576_dist4", config="grid_m576_dist4",
                traffic="grid_lap_ranks", chips=4, why="rehearsal")
    bench = {**harness.benchmark(), "workloads": [cell]}
    outs = launch.spawn(
        cells.rank_main, 4, "cpu", bench, cell, 2147483777, 12.0, False,
        time.perf_counter(), {**tiny.CONFIG["grid_m576"],
                              "max_landmarks": 24},
        {**tiny.TRAFFIC["grid_lap"], "check": {"samples": 24, "chained": 1}},
        base, backend="gloo", timeout_s=600.0)
    return cells.merge(outs), outs


@pytest.mark.parametrize("shard_sqrt", [False, True])
def test_four_gloo_ranks(tmp_path, shard_sqrt):
    """The route: every rank runs the window rank 0's clock sets, rank 0
    judges, and the merged line keeps the contract."""
    (res, rows), outs = _rehearse(tmp_path, shard_sqrt)
    assert res["device"]["count"] == 4 and res["failed"] == 0
    assert all(o[0]["attempted"] == res["attempted"] for o in outs)
    assert list(res)[-1] == "checks"
    checks = res["checks"]
    assert checks["samples"]["value"] >= 1
    assert checks["decisions_off"]["value"] == 0
    assert checks["frame_count"]["value"] == 0


@pytest.mark.parametrize("shard_sqrt", [False, True])
def test_four_gloo_ranks_correct(tmp_path, shard_sqrt):
    """The mesh path against the reference, at the one-card cell's limits.
    It fails here: on the second frame of a detect chunk the pose's
    covariance departs by 0.83-1.20 of the reference's, and by up to 1.02
    on a first frame without ``shard_sqrt`` (PERF.md, Open questions),
    where the one-card path at the same size reads 0."""
    (res, rows), _ = _rehearse(tmp_path, shard_sqrt)
    assert res["correct"], rows
