"""k4.roofline_pct: K4's share of its roofline, the least time of the
window's half sweeps' Grams (``benchmark/counts/k4.py`` at the peaks) over
the device time of its kernels in the trace."""

from benchmark.lib import als_counts, roofline


def read(record):
    trace = record["trace"]
    if trace is None:
        return None
    sec, _n = roofline.kernel_seconds(trace, "gather_gram")
    sweeps = record["counters"].get("sweeps", 0)
    if not sec or not sweeps:
        return None
    return 100.0 * als_counts.k4_bound_s(record["data"]) * sweeps / sec


def note(record):
    return (f"{als_counts.k4_bound_s(record['data']) * 1e3:.4f} ms a sweep"
            f" ({als_counts.bound_by(record['data'], 'k4')}) at "
            f"{roofline.peak_text()}")
