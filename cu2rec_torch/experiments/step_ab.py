"""The SGD step and eval of two checkouts of this repository on one card,
run in turn in the order A B B A, at ``bench.py``'s headline shape
(U=138,000, I=27,000, F=100, 20,000,000 ratings): the float32 first_wins
and twin steps as the trainer's loop runs them (``packed_run_steps``: CUDA
events, the host's enqueue time) and with the stream held (the card's time
alone); the ``mean`` and ``sum`` steps in float32 and bf16 with the stream
held, and float32 ``mean`` and bf16 ``sum`` on power-law items
(``chip_smoke.py``'s skewed ratings); kernel K0b over all ratings; and
K0a's sharded mode on a grid of one (``sgd_step_sharded_cuda``, every
policy in float32 and bf16, and bf16 ``mean`` and ``sum`` at F = 300,
rows of 384 columns; the stream held).  Each run also records a digest of
each mean/sum variant's tables and of each sharded variant's after 3
steps from the same start, and the registers and spills of every
function of ``csrc/sgd_step.cu`` and ``csrc/sgd_sharded.cu`` from their
``-Xptxas -v`` build reports;
the summary says whether each variant's tables are the same bits in both
checkouts.

    python -m cu2rec_torch.experiments.step_ab A_DIR B_DIR [--reps 5]
        [--out FILE]

Each run is a process of its own that imports the ``cu2rec_torch`` and
the ``chip_smoke.py`` helpers of its checkout and builds that checkout's
kernels.  A run prints one JSON record; the script prints each run's and,
last, the median of each time over the runs of each checkout and the
comparison of the digests.  The loop
is host-paced where the enqueue time reaches the event time, so its
times spread more than the held ones: each run repeats it ``--reps``
times and keeps the median.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from cu2rec_torch.experiments.common import abba, checkout_run, medians

# What each run executes, from the root of its checkout.
RUN = r"""
import hashlib, importlib.util, inspect, json, statistics, sys
import torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from cu2rec_torch.csrc.build import build, build_log
from cu2rec_torch.data.csr import to_device
from cu2rec_torch.experiments.common import time_ms
from cu2rec_torch.ops import cuda_loss
from cu2rec_torch.ops.packed import PackedModel, packed_run_steps, packed_step
from cu2rec_torch.ops.sgd import INT32_MAX, prng_key

reps = int(sys.argv[1])
WIDE_F = 300  # rows of 384 columns
build(("sgd_step", "sgd_sharded", "eval_error"))
dev = torch.device("cuda")
csr = smoke._headline_csr(0)
pm = smoke._packed_tables(torch, smoke.U, smoke.I, smoke.F, 0, dev)
rec = {"registers": {fn: [regs, spill] for fn, regs, spill, _ in
                     smoke._ptxas_report(build_log("sgd_step"))}}
for collision in ("first_wins", "twin"):
    dr = to_device(csr, dev, item_major=collision == "twin")
    torch.cuda.synchronize()
    runs = [smoke._time_steps(torch, pm, dr, collision) for _ in range(reps)]
    best = torch.full((smoke.I,), INT32_MAX, dtype=torch.int32, device=dev)
    mu = float(pm.global_bias)
    held = time_ms(lambda: packed_step(
        pm, dr, smoke._hp(), prng_key(1), 7, collision=collision,
        best=best if collision == "first_wins" else None, mu=mu), [()],
        reps=50, hold=True)
    rec[collision] = {
        "loop_ms": statistics.median(r[0] for r in runs),
        "enqueue_ms": statistics.median(r[2] for r in runs),
        "held_ms": held}
    del dr
def held(pm, dr, collision):
    mu = float(pm.global_bias)
    kw = {}
    if "counts" in inspect.signature(packed_step).parameters:
        kw["counts"] = torch.zeros(smoke.I, dtype=torch.int32, device=dev)
    return time_ms(lambda: packed_step(pm, dr, smoke._hp(), prng_key(1), 7,
                                       collision=collision, mu=mu, **kw),
                   [()], reps=50, hold=True)

def digest(pm, dr, collision):
    out = packed_run_steps(pm, dr, smoke._hp(), prng_key(1), 0, 3, True,
                           collision)
    h = hashlib.sha256()
    for t in (out.T_u, out.T_i):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]

dr = to_device(csr, dev)
pm16 = PackedModel(T_u=pm.T_u.bfloat16(), T_i=pm.T_i.bfloat16(),
                   global_bias=pm.global_bias, n_factors=smoke.F)
rec["digests"] = {}
for dtype, tables in (("float32", pm), ("bfloat16", pm16)):
    for collision in ("mean", "sum"):
        name = f"{dtype}/{collision}"
        rec[name] = {"held_ms": held(tables, dr, collision)}
        rec["digests"][name] = digest(tables, dr, collision)
skew = to_device(smoke._headline_csr(0, item_power=smoke.SKEW_POWER), dev)
for name, tables, collision in (("float32/mean/skewed", pm, "mean"),
                                ("bfloat16/sum/skewed", pm16, "sum")):
    rec[name] = {"held_ms": held(tables, skew, collision)}
    rec["digests"][name] = digest(tables, skew, collision)
del skew
from cu2rec_torch.ops import cuda_sgd
from cu2rec_torch.parallel.sharded import make_mesh
rec["registers_sharded"] = {fn: [regs, spill] for fn, regs, spill, _ in
                            smoke._ptxas_report(build_log("sgd_sharded"))}
mesh = make_mesh(1, 1, dev)
drt = to_device(csr, dev, item_major=True)
torch.cuda.synchronize()
def sharded(name, T_u, T_i, n_factors, collision):
    kw = dict(n_factors=n_factors, mesh=mesh, n_users_global=smoke.U,
              collision=collision)
    step = lambda: cuda_sgd.sgd_step_sharded_cuda(
        T_u, T_i, 3.5, drt, smoke._hp(), prng_key(1), 7, **kw)
    rec[name] = {"held_ms": time_ms(step, [()], reps=50, hold=True)}
    out = cuda_sgd.sharded_run_steps(T_u, T_i, 3.5, drt, smoke._hp(),
                                     prng_key(1), 0, 3, **kw)
    h = hashlib.sha256()
    for t in out:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    rec["digests"][name] = h.hexdigest()[:16]
for dtype, tables in (("float32", pm), ("bfloat16", pm16)):
    for collision in ("first_wins", "twin", "mean", "sum"):
        sharded(f"sharded/{dtype}/{collision}", tables.T_u, tables.T_i,
                smoke.F, collision)
del pm16
wide = smoke._packed_tables(torch, smoke.U, smoke.I, WIDE_F, 0, dev)
wide = (wide.T_u.bfloat16(), wide.T_i.bfloat16())
for collision in ("mean", "sum"):
    sharded(f"sharded/bfloat16/{collision}/W384", *wide, WIDE_F, collision)
del drt, wide
args = (pm.T_u, pm.T_i, 3.5, dr.row_ids, dr.indices, dr.data, smoke.F)
rec["eval_error"] = {"held_ms": time_ms(cuda_loss.packed_error_sums_cuda,
                                        [args], reps=20)}
print(json.dumps(rec), flush=True)
"""


# The timed records of a run, each a dict of times.
TIMED = ("first_wins", "twin", "float32/mean", "float32/sum",
         "bfloat16/mean", "bfloat16/sum", "float32/mean/skewed",
         "bfloat16/sum/skewed", "eval_error") + tuple(
             f"sharded/{dtype}/{collision}"
             for dtype in ("float32", "bfloat16")
             for collision in ("first_wins", "twin", "mean", "sum")) + (
                 "sharded/bfloat16/mean/W384", "sharded/bfloat16/sum/W384")


def _run(root: Path, reps: int) -> dict:
    return checkout_run(root, RUN, str(reps))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    runs = abba(args.a, args.b, lambda root: _run(root, args.reps))
    summary = medians(runs, TIMED)
    digests = {label: [r.get("digests", {}) for r in runs
                       if r["checkout"] == label] for label in ("a", "b")}
    same_bits = {name: all(d.get(name) == digest
                           for d in digests["a"] + digests["b"])
                 for name, digest in digests["b"][0].items()}
    print(json.dumps({"median": summary, "same_bits": same_bits}),
          flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"runs": runs, "median": summary,
                                        "same_bits": same_bits}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
