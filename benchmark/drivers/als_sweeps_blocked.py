"""Driver: ``als_sweeps`` (one ALS training call, sweep after sweep, as
``mf --algo als`` runs it) held to the blocked float64 reference,
``benchmark/reference/mf_als_blocked.py``, in the place of ``mf_als``.

``mf_als`` holds every row's Gram at once: at F = 300 on the Netflix
Prize's sizes, 348 GB on the user side.  The blocked reference solves the
same systems a block of rows at a time.  ``run`` and ``readings`` are
``als_sweeps``'s own, with its ``mf_als`` swapped for the blocked module
while they run.  A sweep here takes seconds, so the window also holds on
until sweep 3, the last that the comparison reads, however short
``--seconds`` is (sweep 1 is set-up's): it closes at the first eval after
both.

With ``--trace 1`` the driver also records the program's own spans and
counters (``benchmark/lib/program_trace.py``) over the window, split where
the window opens and closes, as ``bpr_jobs`` does, and returns their sums
in its record (``program_counters``: ``als.gram_slots`` and
``als.gram_live_slots``, which ``als.pad_pct`` reads).
"""

from __future__ import annotations

from contextlib import contextmanager

from benchmark.lib import harness
from benchmark.lib.program_trace import ProgramTrace
from benchmark.reference import mf_als_blocked

als_sweeps = harness.load_module("drivers", "als_sweeps")
FAULTS = als_sweeps.FAULTS


@contextmanager
def _as_this_cell(ctx):
    """``als_sweeps`` with the blocked reference in the place of ``mf_als``,
    and ``ctx``'s window held on until the window's second sweep."""
    expired = ctx.expired
    ctx.expired = lambda: expired() and ctx.counters.get("sweeps", 0) >= 2
    saved = als_sweeps.mf_als
    als_sweeps.mf_als = mf_als_blocked
    try:
        yield
    finally:
        als_sweeps.mf_als = saved
        ctx.expired = expired


def _split_at_the_window(ctx, program: ProgramTrace) -> None:
    """Start the program's window recording where ``ctx``'s window opens,
    and stop it where that closes."""
    open_window, close_window = ctx.open_window, ctx.close_window

    def opened():
        program.open_window()
        open_window()

    def closed():
        close_window()
        program.close_window()

    ctx.open_window, ctx.close_window = opened, closed


def run(ctx) -> dict:
    program = ProgramTrace.start() if ctx.trace else None
    if program is not None:
        _split_at_the_window(ctx, program)
    with _as_this_cell(ctx):
        record = als_sweeps.run(ctx)
    if program is not None:
        record.update(program.record(ctx.t0, ctx.t_end))
    return record


def readings(ctx, mode: str) -> dict:
    """``als_sweeps.readings`` against the blocked reference: the compared
    numbers of the program, of the control (the TF32 reference in the
    program's place) or of a planted fault (one of ``FAULTS``)."""
    with _as_this_cell(ctx):
        return als_sweeps.readings(ctx, mode)
