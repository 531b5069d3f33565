"""als.pad_pct: the share of the slots K4 sums that hold no rating,
100 × (slots − live) / slots over the window, from the program's counters
``als.gram_slots`` (each chunk's padded B × D, a heavy chunk's segments ×
cap) and ``als.gram_live_slots`` (its ratings), counted by
``ops/als.py::als_half_sweep``.  K4 sums a padded slot as a zero row, so
at F = 300, where K4 is bound by its operations, this is the share of its
work spent on padding.  A program without the counters records neither:
None."""


def read(record):
    counters = record.get("program_counters") or {}
    slots = counters.get("als.gram_slots", 0)
    live = counters.get("als.gram_live_slots")
    if not slots or live is None:
        return None
    return 100.0 * (slots - live) / slots
