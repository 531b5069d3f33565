"""k0b.roofline_pct: K0b's share of its roofline, the least time of the
window's evals (``benchmark/counts/k0b.py`` at the peaks, train and test
sets counted apart) over the device time of its kernels in the trace."""

from benchmark.lib import harness, roofline


def read(record):
    trace = record["trace"]
    if trace is None:
        return None
    sec, _n = roofline.kernel_seconds(trace, "eval_partials_kernel",
                                      "eval_packed_partials_kernel",
                                      "eval_finish_kernel")
    c = record["counters"]
    if not sec:
        return None
    k0b = harness.load_module("counts", "k0b")
    d = record["data"]
    least = 0.0
    for split in ("train", "test"):
        b, _by = roofline.bound_s(
            k0b.eval_bytes(d[f"{split}_nnz"], d[f"{split}_users"],
                           d[f"{split}_items"], d["width"], d["elem"]),
            k0b.eval_ops(d[f"{split}_nnz"], d["n_factors"]))
        least += b * c.get(f"evals_{split}", 0)
    return 100.0 * least / sec if least else None


def note(record):
    d = record["data"]
    k0b = harness.load_module("counts", "k0b")
    parts = []
    for split in ("train", "test"):
        n_bytes = k0b.eval_bytes(d[f"{split}_nnz"], d[f"{split}_users"],
                                 d[f"{split}_items"], d["width"], d["elem"])
        b, by = roofline.bound_s(n_bytes, k0b.eval_ops(d[f"{split}_nnz"],
                                                       d["n_factors"]))
        parts.append(f"{split} bound by {by}: {n_bytes / 1e6:.1f} MB, "
                     f"{b * 1e3:.4f} ms")
    return "; ".join(parts) + f" at {roofline.peak_text()}"
