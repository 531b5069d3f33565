"""Helpers of the benchmark's CPU tests: tiny copies of the cells, run on
the CPU through the drivers (no card, so no look for one)."""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.lib import harness  # noqa: E402

TINY_SIZES = {"n_users": 300, "n_items": 80, "n_ratings": 6000,
              "test_share": 0.1}


def tiny(cell: str, **train) -> tuple[dict, dict]:
    """(workload, config) of a cell, cut to a size the CPU runs at once."""
    workload = harness.load_json(harness.HERE / "workloads" / f"{cell}.json")
    config = copy.deepcopy(harness.load_json(
        harness.HERE / "configs" / f"{workload['config']}.json"))
    config["sizes"] = dict(TINY_SIZES)
    config["train"].update(n_factors=8, total_iterations=40, check_error=10)
    config["train"].update(train)
    if "rate" in workload["params"]:
        workload["params"]["rate"] = 200
    return workload, config


def context(cell: str, seed: int = 12345, seconds: float = 0.3,
            trace: bool = False, **train) -> harness.Context:
    workload, config = tiny(cell, **train)
    return harness.Context(time.perf_counter(), cell, workload, config,
                           seed, seconds, trace, device="cpu")


def run_cell(cell: str, **kw) -> dict:
    """A run's record, on the CPU, through the cell's driver."""
    ctx = context(cell, **kw)
    driver = harness.load_module("drivers", ctx.workload["driver"])
    record = driver.run(ctx)
    record.update(cell=cell, setup_s=ctx.setup_s, window_s=ctx.window_s,
                  counters=ctx.counters, spans=ctx.spans.totals(),
                  trace=ctx.trace_record)
    return record
