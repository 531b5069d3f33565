"""Where a fold-in batch's host time goes, in two checkouts of this
repository on one card, in turns in the order A B B A: ``chip_smoke.py``
phase 11 (b)'s fold-in batch (1,000,000 items, F=64, 512 users x 32
ratings, 100 iterations) over 1, 2 and 4 item shards, stage by stage.

    python -m cu2rec_torch.experiments.foldin_stages A_DIR B_DIR [--out FILE]

Each run is a process of its own in its checkout (``common.checkout_run``):
it imports that checkout's ``cu2rec_torch`` and builds its kernels, and
times its engine with the stage timers of this tree's ``chip_smoke.py``
(``_fold_stages``), which wrap the methods an engine of either tree has.
Each prints one JSON record, by shard count: the engine's first batch's
host ms (cold) and the next batches' (to the rows on the host), each
stage's median host ms (pack, copy in, init, assemble, launch, copy out)
and the device's busy ms under the profiler;
the last line holds each checkout's medians.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from cu2rec_torch.experiments.common import abba, checkout_run, medians

SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"

RUN = r"""
import importlib.util, json, sys
import torch
spec = importlib.util.spec_from_file_location("stage_smoke", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
print(json.dumps({"card": torch.cuda.get_device_name(0),
                  "shards": smoke._probe_fold_stages(torch, 0)}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--out", help="append the records here as JSON lines")
    args = ap.parse_args(argv)
    runs = abba(args.a, args.b,
                lambda root: checkout_run(root, RUN, str(SMOKE)))
    summary = {"median": medians(runs, ("shards",))}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            for r in runs + [summary]:
                fh.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
