"""Driver: ``sgd_jobs`` (whole SGD training jobs back to back, as ``mf``
runs them) with the job settings of the cell's workload file.

``sgd_jobs.run`` takes its settings from the configuration's ``train`` and
reads no ``params`` of the workload file; this driver hands them to it as
``overrides`` (e.g. ``{"total_iterations": 100}``: short jobs, whose table
draw, warm-up, evals and finalize weigh as much as their steps).  The
window, the watched job and the comparison are ``sgd_jobs``'s: the first
job's start, steps 1 and 3 and its eval at iteration 1, the same numbers
for a seed whatever the jobs' length.
"""

from __future__ import annotations

from benchmark.lib import harness

sgd_jobs = harness.load_module("drivers", "sgd_jobs")
CONTROL, FAULTS = sgd_jobs.CONTROL, sgd_jobs.FAULTS


def run(ctx, overrides: dict | None = None) -> dict:
    return sgd_jobs.run(ctx, {**ctx.workload.get("params", {}),
                              **(overrides or {})})


def readings(ctx, mode: str) -> dict:
    """The compared numbers of one seed: of the program (``program``), of
    the control (``control``) or of a planted fault (one of ``FAULTS``,
    planted in the reference, which the job's length does not reach)."""
    if mode in ("program", "control"):
        rec = run(ctx, CONTROL if mode == "control" else None)
        return {c["name"]: c["value"] for c in rec["checks"]}
    return sgd_jobs.readings(ctx, mode)
