"""serve.mean_batch: the requests a daemon batch held over the window,
from the daemon's own ``stats`` counters (``batches``, ``mean_batch``)
read before and after it."""


def read(record):
    c = record["counters"]
    return c["batched_requests"] / c["batches"] if c.get("batches") \
        else None
