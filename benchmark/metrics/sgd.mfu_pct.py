"""sgd.mfu_pct: the whole job's share of the card's peaks, the least time
of every step (K0a's count) and every eval (K0b's) that the window ran,
over the window's length."""

from benchmark.lib import harness, roofline


def read(record):
    c, d = record["counters"], record["data"]
    if not c.get("steps"):
        return None
    k0a = harness.load_module("counts", "k0a")
    k0b = harness.load_module("counts", "k0b")
    step, _ = roofline.bound_s(
        k0a.step_bytes(d["n_users"], d["n_items"], d["width"],
                       d["train_users"], d["elem"]),
        k0a.step_ops(d["n_factors"], d["train_users"]))
    least = step * c["steps"]
    for split in ("train", "test"):
        b, _ = roofline.bound_s(
            k0b.eval_bytes(d[f"{split}_nnz"], d[f"{split}_users"],
                           d[f"{split}_items"], d["width"], d["elem"]),
            k0b.eval_ops(d[f"{split}_nnz"], d["n_factors"]))
        least += b * c.get(f"evals_{split}", 0)
    return 100.0 * least / record["window_s"]


def note(record):
    return f"least times at {roofline.peak_text()}"
