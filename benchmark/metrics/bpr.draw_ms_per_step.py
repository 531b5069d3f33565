"""bpr.draw_ms_per_step: the host's milliseconds a step in the BPR draws,
the program's own ``bpr.draws`` span (around each ``bpr_draws`` call, the
five streams' enqueue) over its ``bpr.steps`` counter, both over the
window.  A program without them records neither: None."""


def read(record):
    draws = (record.get("program_spans") or {}).get("bpr.draws")
    steps = (record.get("program_counters") or {}).get("bpr.steps", 0)
    if not draws or not steps:
        return None
    return draws[0] / steps * 1e3
