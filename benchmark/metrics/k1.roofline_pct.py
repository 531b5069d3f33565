"""k1.roofline_pct: K1's share of its roofline, the least time of the
window's half sweeps' solves (``benchmark/counts/k1.py`` at the peaks)
over the device time of its kernels in the trace."""

from benchmark.lib import als_counts, roofline


def read(record):
    trace = record["trace"]
    if trace is None:
        return None
    sec, _n = roofline.kernel_seconds(trace, "ridge_bucket_kernel",
                                      "ridge_cholesky_kernel")
    sweeps = record["counters"].get("sweeps", 0)
    if not sec or not sweeps:
        return None
    return 100.0 * als_counts.k1_bound_s(record["data"]) * sweeps / sec


def note(record):
    return (f"{als_counts.k1_bound_s(record['data']) * 1e3:.4f} ms a sweep"
            f" ({als_counts.bound_by(record['data'], 'k1')}) at "
            f"{roofline.peak_text()}")
