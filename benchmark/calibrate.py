#!/usr/bin/env python3
"""Read the numbers a cell's comparison is held to, for its limits.

    python3 benchmark/calibrate.py --workload <cell> --mode <mode> \
        --seeds 1,2,3 [--seconds 0.5]

``--mode program`` runs the cell as ``run.py`` does, with a short window,
on each seed in one process, and prints its compared numbers: the lower
readings.  ``--mode sweep --rates a,b,c`` (a serving cell) builds the
daemon once and offers it a window of ``--seconds`` at each rate in turn:
the sweep that finds the knee.  ``--mode control`` runs the cell's control (the driver's
``CONTROL``: the program's own lower-precision path where it has one), and
any of the driver's ``FAULTS`` plants that fault in the reference put in
the program's place: the upper readings.  One JSON line per seed.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.lib import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--device", default="cuda")
    p.add_argument("--rates", default="")
    args = p.parse_args(argv)
    workload = harness.load_json(harness.HERE / "workloads"
                                 / f"{args.workload}.json")
    config = harness.load_json(harness.HERE / "configs"
                               / f"{workload['config']}.json")
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    driver = harness.load_module("drivers", workload["driver"])
    if args.mode == "sweep":
        seed = int(args.seeds.split(",")[0])
        ctx = harness.Context(time.perf_counter(), args.workload, workload,
                              config, seed, args.seconds, False,
                              device=args.device)
        for row in driver.sweep(ctx, [int(r) for r in
                                      args.rates.split(",")]):
            print(json.dumps({"workload": args.workload, "mode": "sweep",
                              "seed": seed, **row}), flush=True)
        return 0
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Context(time.perf_counter(), args.workload, workload,
                              config, seed, args.seconds, False,
                              device=args.device)
        values = driver.readings(ctx, args.mode)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "numbers": values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
