"""als.mfu_pct: the whole sweep's share of the card's peaks: the least
time of a sweep's inputs, outputs and operations
(``benchmark/lib/als_counts.py::sweep_work``), over the window's time a
sweep."""

from benchmark.lib import als_counts, roofline


def read(record):
    sweeps = record["counters"].get("sweeps", 0)
    if not sweeps:
        return None
    least, _by = roofline.bound_s(*als_counts.sweep_work(record["data"]))
    return 100.0 * least * sweeps / record["window_s"]


def note(record):
    n_bytes, n_ops = als_counts.sweep_work(record["data"])
    b, by = roofline.bound_s(n_bytes, n_ops)
    return (f"a sweep bound by {by}: {n_bytes / 1e9:.3f} GB, "
            f"{n_ops / 1e9:.1f} GFLOP, {b * 1e3:.4f} ms at "
            f"{roofline.peak_text()}")
