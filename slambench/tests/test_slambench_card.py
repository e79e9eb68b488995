"""The control on the card: the program with TF32 matmuls (the precision
below the configuration's float32 with TF32 off) at each cell's own size
comes out not correct on three seeds, and the program as configured
correct on the same seeds. Run on the card:
``python -m pytest slambench/tests -m card``."""

import time

import pytest
import torch

from slambench import cells, harness

SEEDS = (2147483801, 2147483802, 2147483803)


@pytest.mark.card
@pytest.mark.parametrize("name", ["m576_replay", "m32_replay", "m32_live"])
def test_control_fails_and_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = harness.benchmark()
    cell = harness.cell(bench, name)
    torch.set_num_threads(1)
    for seed in SEEDS:
        for tf32 in (True, False):
            res, rows = cells.run(bench, cell, seed, 6.0, False,
                                  torch.device("cuda:0"),
                                  t_start=time.perf_counter(),
                                  log=lambda *a: None, tf32=tf32)
            assert res["correct"] is (not tf32), (name, seed, tf32, rows)
