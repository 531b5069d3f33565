"""Where K0c's time goes, in two checkouts of this repository on one card:
the explicit serving fold-in kernel (``csrc/foldin.cu``) by iterations and
by row source, in turns in the order A B B A.

    python -m cu2rec_torch.experiments.foldin_times A_DIR B_DIR \
        [--sass DIR] [--out FILE]

Each run is a process of its own in its checkout (``common.checkout_run``),
which builds that checkout's kernel.  At ``chip_smoke.py``'s probe shape
(1,000,000 items, F=64, 512 users x 32 ratings) and at its phase 6 shape
(27,000 items, F=100, 256 users x 8-64 ratings), float32, it times a
launch with the stream held (CUDA events over 40 launches) at n_steps 1,
10 and 100 for each row source: the catalog sampled directly over 8
batches (their rows exceed L2), one batch again and again, the rows
assembled as the sharded engine assembles them, one cached row for
every slot (512 slots on one L2 line), and each slot its own row, which
stays in L2 (the floor of the chain).  The slope over n_steps (10 to 100)
is one link of a slot's chain; the intercept the launch's fixed cost.
The start: 512 users x Dp ratings (Dp 32 and 100, every column valid, as
every caller in the repository sends them) at n_steps 0 and 1, so that
the two trees' difference at each Dp is what the newer one's compaction
of the mask costs.  A kernel whose source takes ``FOLDIN_MAX_LANES`` is
also built with it at 8 and 16 and timed at those lanes a row, cold and at
the floor.  Each run prints one JSON record with the ``-Xptxas -v``
registers and spills of each of its kernel's functions; the last line
holds each checkout's medians.  With ``--sass``, each checkout's
``cuobjdump -sass`` of its library is written there.

The masks are front-packed (the first len columns), so a kernel of a tree
that takes front-packed lengths instead of a mask gets their row sums.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from cu2rec_torch.experiments.common import abba, checkout_run, medians

RUN = r"""
import ctypes, inspect, json, os, re, subprocess, sys
import torch
from cu2rec_torch.csrc import build
from cu2rec_torch.experiments.common import time_ms
from cu2rec_torch.ops import cuda_foldin
from cu2rec_torch.ops.packed import packed_width
from cu2rec_torch.ops.sgd import Hyper, prng_key

sass_dir = sys.argv[1]
dev = torch.device("cuda")
hp, key = Hyper(0.05, 0.02, 0.02, 0.02, 0.02), prng_key(14)
params = inspect.signature(cuda_foldin.fold_in_cuda).parameters
takes_mask = "valid" in params


def inputs(seed, n_items, F, B, D, lo, n_sets):
    W = packed_width(F)
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.zeros((n_items, W), device=dev)
    table[:, :F + 1] = 0.1 * torch.randn((n_items, F + 1), generator=gen,
                                         device=dev)
    sets = []
    for _ in range(n_sets):
        T_u = torch.zeros((B, W), device=dev)
        T_u[:, :F + 1] = torch.randn((B, F + 1), generator=gen,
                                     device=dev) / F
        index = torch.randint(0, n_items, (B, D), generator=gen, device=dev,
                              dtype=torch.int32)
        vals = torch.randint(1, 11, (B, D), generator=gen,
                             device=dev).float() / 2
        lens = torch.randint(lo, D + 1, (B, 1), generator=gen, device=dev)
        mask = torch.arange(D, device=dev)[None, :] < lens
        sets.append((T_u, table, index, vals, mask))
    return sets


def run(F, n):
    def go(T_u, table, index, vals, mask):
        last = mask if takes_mask else mask.sum(1, dtype=torch.int32)
        return cuda_foldin.fold_in_cuda(T_u, table, index, vals, last, 3.5,
                                        hp, key, n, F)
    return go


def ptxas_report(text):
    report, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m[1], 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m[1])
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report.append([name, int(m[1]), spill])
            name = None
    return report


# The kernel at 8 and 16 lanes a row, built while the default is timed.
capped = {}
if "FOLDIN_MAX_LANES" in (build.CSRC / "foldin.cu").read_text():
    for g in (8, 16):
        so = build.BUILD_ROOT / f"foldin_max_lanes_{g}" / "libfoldin.so"
        so.parent.mkdir(parents=True, exist_ok=True)
        capped[g] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, f"-DFOLDIN_MAX_LANES={g}",
             "-o", str(so), str(build.CSRC / "foldin.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))


# Point cuda_foldin at lib (its argument types set anew).
def use_library(lib):
    build._loaded["foldin"] = lib
    cuda_foldin._lib = None
    cuda_foldin._load()


out = {"card": torch.cuda.get_device_name(0)}
default_lib = build.load("foldin")
variants = {}
for label, n_items, F, B, D, lo in (("probe", 1_000_000, 64, 512, 32, 32),
                                    ("phase 6", 27_000, 100, 256, 64, 8)):
    sets = inputs(0, n_items, F, B, D, lo, 8)
    T_u, table, index, vals, mask = sets[0]
    rows = table[index.reshape(-1).long()].contiguous()
    flat = torch.arange(index.numel(), dtype=torch.int32,
                        device=dev).reshape(index.shape)
    sources = {
        "direct, 8 batches": sets,
        "direct, 1 batch": sets[:1],
        "assembled": [(T_u, rows, flat, vals, mask)],
        "one cached row": [(T_u, table[:1].contiguous(),
                            torch.zeros_like(index), vals, mask)],
        "own row a slot": [(T_u, table, torch.arange(
            B, dtype=torch.int32, device=dev)[:, None].expand(B, D)
            .contiguous(), vals, mask)],
    }
    shape = {}
    for source, batches in sources.items():
        ms = {n: time_ms(run(F, n), batches, reps=40, hold=True)
              for n in (1, 10, 100)}
        shape[source] = {"ms": [ms[1], ms[10], ms[100]],
                         "link_us": (ms[100] - ms[10]) / 90 * 1e3}
    if capped:
        shape["lanes"] = {}
        for g, (so, proc) in capped.items():
            if g not in variants:
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc at {g} lanes a row:\n{log}")
                variants[g] = ctypes.CDLL(str(so))
                out[f"ptxas at {g} lanes"] = ptxas_report(log)
            use_library(variants[g])
            cold = {n: time_ms(run(F, n), sets, reps=40, hold=True)
                    for n in (10, 100)}
            floor = time_ms(run(F, 100), sources["own row a slot"],
                            reps=40, hold=True)
            shape["lanes"][str(g)] = {
                "ms": cold[100], "link_us": (cold[100] - cold[10]) / 90 * 1e3,
                "floor_ms": floor}
        use_library(default_lib)
    out[label] = shape
    del sets, sources, rows
    torch.cuda.empty_cache()
start = {}
for D in (32, 100):
    batch = inputs(1, 27_000, 64, 512, D, D, 1)
    start[f"Dp {D}"] = {f"n_steps {n}": time_ms(run(64, n), batch, reps=40,
                                                hold=True) for n in (0, 1)}
out["start"] = start
lib = build.build(("foldin",))["foldin"]
out["ptxas"] = ptxas_report(build.build_log("foldin"))
if sass_dir:
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    os.makedirs(sass_dir, exist_ok=True)
    path = os.path.join(sass_dir, os.path.basename(os.getcwd()) + ".sass")
    with open(path, "w") as fh:
        fh.write(sass)
    out["sass"] = path
print(json.dumps(out))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--sass", default="",
                    help="directory for each checkout's cuobjdump -sass")
    ap.add_argument("--out", help="append the records here as JSON lines")
    args = ap.parse_args(argv)
    sass = str(Path(args.sass).resolve()) if args.sass else ""
    runs = abba(args.a, args.b, lambda root: checkout_run(root, RUN, sass))
    summary = {"median": medians(runs, ("probe", "phase 6", "start"))}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            for r in runs + [summary]:
                fh.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
