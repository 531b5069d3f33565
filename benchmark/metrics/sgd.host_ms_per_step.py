"""sgd.host_ms_per_step: the host's milliseconds a step in the SGD loop,
from the benchmark's span around each ``engine.run`` (the loop returns
once its steps are queued), over the steps those calls ran."""


def read(record):
    run = record["spans"].get("engine.run")
    steps = record["counters"].get("steps", 0)
    if not run or not steps:
        return None
    return run[0] / steps * 1e3
