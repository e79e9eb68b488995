"""Run one cell of the port's benchmark once.

    python3 slambench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks for.
The run renders the seed's lap on the card, builds the session and
captures only this cell's graph keys, warms up, offers frames for
``--seconds`` (``--trace 1``: then profiles a steady stretch), judges the
frames it kept against the plain reference, and prints one JSON line last
on standard output. Without enough cards it exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from slambench import cells, harness

    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        log("slambench: no CUDA device")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"slambench: the cell needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} found")
        return 2
    from slambench import driving

    driving.steady_host()
    chips = int(cell["chips"])
    if chips > 1:
        from cv_monoslam_tpu_torch.parallel import launch

        result, checks = cells.merge(launch.spawn(
            cells.rank_main, chips, "cuda", bench, cell, args.seed,
            args.seconds, bool(args.trace), T_START, timeout_s=340.0))
    else:
        result, checks = cells.run(bench, cell, args.seed, args.seconds,
                                   bool(args.trace), torch.device("cuda:0"),
                                   t_start=T_START, log=log)
    found = harness.forbidden_modules()
    if found:
        log(f"slambench: loaded the forbidden modules {found}")
        return 3
    for name, value, limit in checks:
        log(f"[check] {name} {value!r} limit {limit!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
