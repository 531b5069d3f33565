"""k0a.roofline_pct: K0a's share of its roofline, the least time of the
window's steps (``benchmark/counts/k0a.py`` at the peaks) over the device
time of its kernels in the trace."""

from benchmark.lib import harness, roofline


def read(record):
    trace = record["trace"]
    if trace is None:
        return None
    sec, _n = roofline.kernel_seconds(trace, "sgd_user_kernel",
                                      "sgd_item_kernel")
    steps = record["counters"].get("steps", 0)
    if not sec or not steps:
        return None
    k0a = harness.load_module("counts", "k0a")
    d = record["data"]
    b, _by = roofline.bound_s(
        k0a.step_bytes(d["n_users"], d["n_items"], d["width"],
                       d["train_users"], d["elem"]),
        k0a.step_ops(d["n_factors"], d["train_users"]))
    return 100.0 * b * steps / sec


def note(record):
    d = record["data"]
    k0a = harness.load_module("counts", "k0a")
    n_bytes = k0a.step_bytes(d["n_users"], d["n_items"], d["width"],
                             d["train_users"], d["elem"])
    b, by = roofline.bound_s(n_bytes, k0a.step_ops(d["n_factors"],
                                                   d["train_users"]))
    return (f"bound by {by}: {n_bytes / 1e6:.1f} MB a step, "
            f"{b * 1e3:.4f} ms at {roofline.peak_text()}")
