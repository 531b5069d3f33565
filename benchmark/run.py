#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The cell's file
``benchmark/workloads/<cell>.json`` names its configuration
(``benchmark/configs/<config>.json``), its driver
(``benchmark/drivers/<driver>.py``) and the limits of its comparison.  The
driver sets up, opens the window, measures for ``--seconds`` and closes it
at its next natural point, then compares what the timed path produced with
the plain reference.  Each metric that ``BENCHMARK.json`` gives the cell
(the end-to-end ones, or with ``--trace 1`` the per-layer ones, read from
a profile of the window) is read by ``benchmark/metrics/<metric>.py``.

The last line of standard output is the result's JSON; the last lines of
standard error give each compared number beside its limit.  The run exits
with another code than 0, and prints no result, when there is no CUDA card
or fewer than the cell asks for, when the port is missing, or when a module
of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.lib import harness  # noqa: E402


def fail(msg: str, code: int = 2) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--record", default=None,
                   help="also write the run's record (counters, spans, "
                   "trace sums, sizes) as JSON to this file")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        return fail(f"no cell {args.workload!r} in BENCHMARK.json")
    chips = cells[args.workload]["chips"]
    workload = harness.load_json(harness.HERE / "workloads"
                                 / f"{args.workload}.json")
    config = harness.load_json(harness.HERE / "configs"
                               / f"{workload['config']}.json")

    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        return fail(f"the cell asks for {chips} cards, the machine has "
                    f"{torch.cuda.device_count()}")
    if not (ROOT / "cu2rec_torch" / "__init__.py").is_file():
        return fail("the port (cu2rec_torch) is not in this checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"benchmark: {args.workload} seed {args.seed} on "
          f"{harness.power_line()}", file=sys.stderr, flush=True)

    driver = harness.load_module("drivers", workload["driver"])
    ctx = harness.Context(T_START, args.workload, workload, config,
                          args.seed, args.seconds, bool(args.trace))
    try:
        record = driver.run(ctx)
    except harness.Forbidden as e:
        return fail(str(e), 3)
    found = harness.forbidden_modules()
    if found:
        return fail("modules of JAX or of the JAX package are loaded: "
                    + ", ".join(found), 3)

    record.update(cell=args.workload, setup_s=ctx.setup_s,
                  window_s=ctx.window_s, counters=ctx.counters,
                  spans=ctx.spans.totals(), trace=ctx.trace_record)
    out, lines = report(bench, args.workload, record,
                        harness.device_info(chips))
    if args.record:
        with open(args.record, "w") as f:
            json.dump({k: v for k, v in record.items()
                       if k not in ("config", "workload")}, f)
    found = harness.forbidden_modules()
    if found:
        return fail("modules of JAX or of the JAX package are loaded: "
                    + ", ".join(found), 3)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def report(bench: dict, cell: str, record: dict, device: dict):
    """(the result's JSON object, the lines for standard error) of a run's
    record: each metric the cell reports read by its reader, the device,
    and each compared number beside its limit, last."""
    trace = record.get("trace")
    metrics = {}
    notes = []
    for m in harness.cell_metrics(bench, cell, trace is not None):
        reader = harness.load_module("metrics", m["name"])
        value = reader.read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            if hasattr(reader, "note"):
                notes.append(f"metric {m['name']}: {reader.note(record)}")
    device = dict(device, memory_peak_bytes=record["memory_peak_bytes"])
    if trace is not None:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
    checks = record["checks"]
    out = {"correct": all(c["ok"] for c in checks),
           "attempted": record["attempted"], "failed": record["failed"],
           "metrics": metrics, "device": device}
    if trace is not None:
        out["breakdown"] = harness.breakdown(trace)
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    lines = notes + ["benchmark: counters " + json.dumps(record["counters"])
                     + " spans " + json.dumps(record["spans"])]
    lines += [f"check {c['name']} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}" for c in checks]
    return out, lines


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
