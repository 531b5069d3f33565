"""The ``mean``/``sum`` steps of K0a in each of several checkouts of this
repository on one card: each step's time with the stream held (the card's
time alone), in float32 and bf16, on uniform and on power-law items
(``chip_smoke.py``'s headline ratings and its skewed ones), and the
registers and spills of the collision kernels at W = 128.

    python -m cu2rec_torch.experiments.collide_times DIR [DIR ...]

Each checkout runs in a process of its own, which imports its own
``cu2rec_torch`` and ``chip_smoke.py`` and builds its own kernels; the
script prints one JSON line a checkout.  Comparing variants of
``csrc/sgd_step.cu`` is then a matter of unpacking each into a git-ignored
directory and naming them all in one call.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = r"""
import importlib.util, inspect, json, sys
import torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from cu2rec_torch.csrc.build import build, build_log
from cu2rec_torch.data.csr import to_device
from cu2rec_torch.experiments.common import time_ms
from cu2rec_torch.ops.packed import PackedModel, packed_step
from cu2rec_torch.ops.sgd import prng_key

build(("sgd_step",))
rec = {"registers": {fn: [regs, spill] for fn, regs, spill, _ in
                     smoke._ptxas_report(build_log("sgd_step"))
                     if "<128," in fn and "collide" in fn}}
dev = torch.device("cuda")
pm = smoke._packed_tables(torch, smoke.U, smoke.I, smoke.F, 0, dev)
pm16 = PackedModel(T_u=pm.T_u.bfloat16(), T_i=pm.T_i.bfloat16(),
                   global_bias=pm.global_bias, n_factors=smoke.F)
kw = {}
if "counts" in inspect.signature(packed_step).parameters:
    kw["counts"] = torch.zeros(smoke.I, dtype=torch.int32, device=dev)
for items, power in (("uniform", None), ("skewed", smoke.SKEW_POWER)):
    dr = to_device(smoke._headline_csr(0, item_power=power), dev)
    torch.cuda.synchronize()
    for dtype, tables in (("float32", pm), ("bfloat16", pm16)):
        for collision in ("mean", "sum"):
            rec[f"{items}/{dtype}/{collision}"] = time_ms(
                lambda: packed_step(tables, dr, smoke._hp(), prng_key(1), 7,
                                    collision=collision, mu=3.5, **kw),
                [()], reps=30, hold=True)
    del dr
print(json.dumps(rec))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", type=Path, nargs="+")
    args = ap.parse_args(argv)
    for root in args.dirs:
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=root,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"collide_times: the run in {root} failed "
                             f"(rc {proc.returncode}):\n{proc.stderr[-4000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"checkout": str(root), **rec}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
