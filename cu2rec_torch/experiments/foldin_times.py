"""Where K0c's time goes: the explicit serving fold-in kernel
(``csrc/foldin.cu``) at ``chip_smoke.py``'s probe shape (1,000,000 items,
F=64, 512 users x 32 ratings), by iterations and by row source.

    python -m cu2rec_torch.experiments.foldin_times [--out FILE]

For n_steps in 1, 10 and 100 and each source (the catalog sampled
directly over 8 batches, whose rows exceed L2; one batch again and again;
the rows assembled as the sharded engine assembles them; one cached row
for every slot) it prints one JSON line: the mean time of a launch with
the stream held (CUDA events over 40 launches), and the kernel's own
duration under ``torch.profiler`` (one launch, the median of 5).  The
slope over n_steps is the time of one link of a slot's chain; the
intercept is the launch's fixed cost.
"""

from __future__ import annotations

import argparse
import importlib.util
import statistics
import sys
from pathlib import Path

import torch

from cu2rec_torch.experiments.common import Records, time_ms
from cu2rec_torch.ops.cuda_foldin import fold_in_cuda
from cu2rec_torch.ops.sgd import Hyper, prng_key

ROOT = Path(__file__).resolve().parents[2]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _profiled_ms(run, args) -> float:
    """The kernel's own duration of one launch, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    times = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(*args)
            torch.cuda.synchronize()
        times += [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                  if "foldin_kernel" in e.name]
    return statistics.median(times) if times else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    smoke = _smoke()
    dev = torch.device("cuda")
    hp, key = Hyper(0.05, 0.02, 0.02, 0.02, 0.02), prng_key(14)
    sets = smoke._fold_inputs(torch, dev, 0, 1_000_000, 64, 512, 32, 32,
                              torch.float32, 8)
    T_u, table, index, vals, lens = sets[0]
    rows = table[index.reshape(-1).long()].contiguous()
    flat = torch.arange(index.numel(), dtype=torch.int32,
                        device=dev).reshape(index.shape)
    sources = {
        "direct, 8 batches": sets,
        "direct, 1 batch": sets[:1],
        "assembled": [(T_u, rows, flat, vals, lens)],
        "one cached row": [(T_u, table[:1].contiguous(),
                            torch.zeros_like(index), vals, lens)],
    }
    rec = Records(args.out)
    for source, batches in sources.items():
        for n_steps in (1, 10, 100):
            def run(*a, n=n_steps):
                return fold_in_cuda(*a, 3.5, hp, key, n, 64)

            rec.emit(source=source, n_steps=n_steps,
                     held_ms=time_ms(run, batches, reps=40, hold=True),
                     profiled_ms=_profiled_ms(run, batches[0]))
    rec.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
