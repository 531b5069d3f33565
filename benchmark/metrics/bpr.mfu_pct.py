"""bpr.mfu_pct: the whole BPR run's share of the card's peaks, the least
time of every step and every eval (AUC and ranking scan) that the window
ran (``benchmark/counts/bpr.py``), over the window's length."""

from benchmark.lib import harness, roofline


def least_s(record) -> float | None:
    c, d = record["counters"], record["data"]
    if not c.get("steps"):
        return None
    bpr = harness.load_module("counts", "bpr")
    W, F, e = d["width"], d["n_factors"], d["elem"]
    step, _ = roofline.bound_s(
        bpr.step_bytes(d["n_users"], d["n_items"], W, d["train_users"],
                       d["train_items"], e),
        bpr.step_ops(F, d["train_users"], d["n_items"]))
    auc, _ = roofline.bound_s(
        bpr.auc_bytes(d["auc_pairs"], d["auc_users"], d["auc_items"], W, e),
        bpr.auc_ops(d["auc_pairs"], F))
    scan, _ = roofline.bound_s(
        bpr.scan_bytes(d["rank_users"], d["n_items"], W, d["rank_train_nnz"],
                       d["rank_test_nnz"], d["rank_k"], e),
        bpr.scan_ops(d["rank_users"], d["n_items"], F))
    return step * c["steps"] + (auc + scan) * c.get("evals", 0)


def read(record):
    least = least_s(record)
    return None if least is None else 100.0 * least / record["window_s"]


def note(record):
    d = record["data"]
    bpr = harness.load_module("counts", "bpr")
    n_bytes = bpr.step_bytes(d["n_users"], d["n_items"], d["width"],
                             d["train_users"], d["train_items"], d["elem"])
    b, by = roofline.bound_s(n_bytes, bpr.step_ops(
        d["n_factors"], d["train_users"], d["n_items"]))
    return (f"a step bound by {by}: {n_bytes / 1e6:.1f} MB, "
            f"{b * 1e3:.4f} ms at {roofline.peak_text()}")
