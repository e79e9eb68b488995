"""Tiny sizes of the benchmark's cells for the CPU, and a runner."""

from __future__ import annotations

import time

import torch

from slambench import cells, harness

#: the cells at a size a CPU test holds: the same modes, fewer slots, a
#: short lap (16 frames a lap turns 22.5 degrees a frame, under the
#: redirection threshold), one chunk a block, two kept frames
CONFIG = {
    "grid_m576": dict(max_landmarks=24, max_new_per_frame=8,
                      max_detections=48, min_num=16, n_initial_raws=48,
                      n_process_raws=48, session=dict(block_chunks=1)),
    "turtlebot_m32": dict(max_landmarks=16, max_new_per_frame=4,
                          max_detections=32,
                          session=dict(chunk=4, block_chunks=1)),
}
TRAFFIC = {
    "grid_lap": dict(lap={"frames": 16, "step_m": 0.02},
                     check={"samples": 2, "chained": 1}, trace_frames=8),
    "blob_lap": dict(lap={"frames": 16, "step_m": 0.06},
                     check={"samples": 2, "chained": 1}, trace_frames=8),
    "blob_lap_live": dict(lap={"frames": 16, "step_m": 0.06},
                          check={"samples": 2},
                          trace_frames=8),
}


def run(name: str, seed: int = 2147483901, seconds: float = 2.0,
        traced: bool = False, bench=None, base: str = harness.HERE):
    bench = bench or harness.benchmark()
    cell = harness.cell(bench, name)
    torch.set_num_threads(2)
    return cells.run(bench, cell, seed, seconds, traced, "cpu",
                     t_start=time.perf_counter(), log=lambda *a: None,
                     overrides=CONFIG.get(cell["config"]),
                     traffic_overrides=TRAFFIC.get(cell["traffic"]),
                     base=base)
