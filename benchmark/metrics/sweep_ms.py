"""sweep_ms: the window's milliseconds over the ALS sweeps it completed,
each with its train and test eval."""


def read(record):
    n = record["counters"].get("sweeps", 0)
    return record["window_s"] * 1e3 / n if n else None
