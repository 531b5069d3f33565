"""bpr.host_ms_per_step: the host's milliseconds a step in the BPR loop,
from the benchmark's span around each of ``train_bpr``'s
``bpr_run_steps`` calls (the loop returns once its steps are queued;
``train_bpr`` then waits for the card outside the span), over the steps
those calls ran."""


def read(record):
    run = record["spans"].get("bpr_run_steps")
    steps = record["counters"].get("steps", 0)
    if not run or not steps:
        return None
    return run[0] / steps * 1e3
