"""device_idle_pct.bpr: the share of the traced window in which no
operation ran on the card (the union of the profiler's device operations,
against the window's length)."""

from benchmark.lib.idle import idle_pct


def read(record):
    return idle_pct(record)
