"""request_p95_ms: the 95th percentile, by nearest rank, of every request
of the window, each timed from when it was due to when its answer came;
one that never answered, or answered an error, counts as missing every
limit."""


def read(record):
    v = record.get("latency_p95_s")
    return None if v is None else v * 1e3
