"""Readings for the limits of ``correct``: one cell run on many seeds in one
process, the program as the configuration states it and the control (the
program with TF32 matmuls, the precision below float32 with TF32 off),
each run's compared numbers printed as one JSON line.

    python3 slambench/readings.py --workload <name> --seeds 1,2,3 \
        --seconds 6 [--control-seeds 4,5,6] [--chained N]

``--chained`` judges N frames of each kept chunk after its first (the
traffic file's ``check.chained`` otherwise); every judged frame's gaps are
printed on standard error.

Not a benchmark run: the benchmark never runs the control. ``limits/``
holds what these readings gave and the limits set from them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--chained", type=int, default=None)
    args = ap.parse_args(argv)
    import torch

    from slambench import cells, harness

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    from slambench import driving

    driving.steady_host()
    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    dev = torch.device("cuda:0")
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + \
        [(int(s), True) for s in args.control_seeds.split(",") if s]

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    traffic = None
    if args.chained is not None:
        check = {**harness.traffic(cell["traffic"])["check"],
                 "chained": args.chained}
        traffic = {"check": check}

    for seed, control in runs:
        try:
            res, rows = cells.run(bench, cell, seed, args.seconds, False,
                                  dev, log=log, tf32=control,
                                  traffic_overrides=traffic)
            line = dict(workload=args.workload, seed=seed, control=control,
                        correct=res["correct"], metrics=res["metrics"],
                        failed=res["failed"],
                        numbers={n: v for n, v, _ in rows})
        except Exception as e:          # a control that crashes has failed
            line = dict(workload=args.workload, seed=seed, control=control,
                        error=f"{type(e).__name__}: {e}")
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
