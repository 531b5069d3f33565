"""``chip_smoke.py``'s phase 6 (the ``serve`` CLI's recommend, explicit
fold-in and implicit fold-in waves at ML-20M scale) in two checkouts of
this repository on one card, in turn in the order A B B A, so that their
wave latencies can be compared within one call.

    python -m cu2rec_torch.experiments.serve_ab A_DIR B_DIR

Each run is a process of its own in its checkout, which imports that
checkout's ``cu2rec_torch`` and ``chip_smoke.py`` and builds its own
kernels.  Each prints one JSON record (the checkout, each wave's latency
in ms, requests/s, the phase's ``[serve]`` and ``[profile]`` lines); the
last line holds each checkout's medians.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from cu2rec_torch.experiments.common import abba, checkout_run, medians

RUN = r"""
import importlib.util, json, sys
import torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
lines = []
smoke.log = lambda *a: lines.append(" ".join(map(str, a)))
_, _, smi = smoke.phase_device(torch)
_, ctx = smoke.phase_serve(torch, 0, smi)
print(json.dumps({"lat_ms": [t * 1e3 for t in ctx["lat"]], "rps": ctx["rps"],
                  "card": smi, "log": [ln[:400] for ln in lines if
                                       ln.startswith(("[serve]",
                                                      "[profile]"))]}))
"""


def _run(root: Path) -> dict:
    return checkout_run(root, RUN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    args = ap.parse_args(argv)
    runs = abba(args.a, args.b, _run)
    print(json.dumps({"median": medians(runs, ("lat_ms", "rps"))}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
