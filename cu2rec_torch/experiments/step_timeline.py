"""When each kernel of one ``mean``/``sum`` step of K0a starts and ends on
the card, under ``torch.profiler``, at ``bench.py``'s headline shape, in
float32 and bf16, on uniform and on power-law items.

    python -m cu2rec_torch.experiments.step_timeline

It runs four steps in a profiled loop as the trainer runs them and prints,
for the last whole step, each kernel's start, end and span in
microseconds from the start of that step's user kernel.  A kernel launched
early (programmatic dependent launch) starts before the kernel ahead of it
ends and waits inside: its span includes the wait.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    from torch.profiler import ProfilerActivity

    from cu2rec_torch.data.csr import to_device
    from cu2rec_torch.ops.packed import PackedModel, packed_run_steps
    from cu2rec_torch.ops.sgd import prng_key

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    pm = smoke._packed_tables(torch, smoke.U, smoke.I, smoke.F, 0, dev)
    pm16 = PackedModel(T_u=pm.T_u.bfloat16(), T_i=pm.T_i.bfloat16(),
                       global_bias=pm.global_bias, n_factors=smoke.F)
    cuda = torch.autograd.DeviceType.CUDA
    for items, power in (("uniform", None), ("skewed", smoke.SKEW_POWER)):
        dr = to_device(smoke._headline_csr(0, item_power=power), dev)
        torch.cuda.synchronize()
        for dtype, tables in (("float32", pm), ("bfloat16", pm16)):
            for collision in ("mean", "sum"):
                packed_run_steps(tables, dr, smoke._hp(), prng_key(1), 0, 3,
                                 True, collision)
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=[
                        ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    packed_run_steps(tables, dr, smoke._hp(), prng_key(1), 0,
                                     4, True, collision)
                    torch.cuda.synchronize()
                spans = sorted((e.time_range.start, e.time_range.end, e.name)
                               for e in prof.events()
                               if e.device_type == cuda)
                starts = [s for s, _, n in spans if "sgd_user_kernel" in n]
                t0, t1 = starts[-2], starts[-1]
                print(f"{items} {dtype} {collision}: step {t1 - t0:.1f} us",
                      flush=True)
                for s, e, n in spans:
                    if t0 <= s < t1:
                        print(f"  {s - t0:8.1f} {e - t0:8.1f} {e - s:8.1f}  "
                              f"{smoke._short(n)[:48]}", flush=True)
        del dr
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    raise SystemExit(main())
