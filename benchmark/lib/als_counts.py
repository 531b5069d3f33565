"""The least time of an ALS sweep's parts, from the cell's data sizes and
the counts in ``benchmark/counts/``: both half sweeps of K4 and of K1, and
the sweep's two evals (K0b)."""

from __future__ import annotations

from benchmark.lib import harness, roofline


def sides(d: dict):
    """(systems, counterpart rows read) of the user and the item half
    sweep; every rating is a live slot on each side."""
    return ((d["train_users"], d["train_items"]),
            (d["train_items"], d["train_users"]))


def bound_by(d: dict, kernel: str) -> str:
    """What sets the bound of a kernel's user half sweep: "bytes" or
    "operations"."""
    mod = harness.load_module("counts", kernel)
    n = d["n_factors"] + 1
    (s, r), _ = sides(d)
    if kernel == "k4":
        args = (mod.half_sweep_bytes(n, s, d["train_nnz"], r),
                mod.half_sweep_ops(n, d["train_nnz"]))
    else:
        args = (mod.half_sweep_bytes(n, s), mod.half_sweep_ops(n, s))
    return roofline.bound_s(*args)[1]


def k4_bound_s(d: dict) -> float:
    k4 = harness.load_module("counts", "k4")
    n = d["n_factors"] + 1
    return sum(roofline.bound_s(k4.half_sweep_bytes(n, s, d["train_nnz"], r),
                                k4.half_sweep_ops(n, d["train_nnz"]))[0]
               for s, r in sides(d))


def k1_bound_s(d: dict) -> float:
    k1 = harness.load_module("counts", "k1")
    n = d["n_factors"] + 1
    return sum(roofline.bound_s(k1.half_sweep_bytes(n, s),
                                k1.half_sweep_ops(n, s))[0]
               for s, _r in sides(d))


def sweep_work(d: dict) -> tuple[int, int]:
    """(bytes, operations) of a whole sweep's inputs and outputs: each half
    sweep reads the ratings (an id and a value each) and the counterpart
    table once and writes its own table once; the two evals read what K0b
    reads; the operations are the Grams', the solves' and the evals'.  The
    Grams passed from K4 to K1 are not counted."""
    k4 = harness.load_module("counts", "k4")
    k1 = harness.load_module("counts", "k1")
    k0b = harness.load_module("counts", "k0b")
    n, W = d["n_factors"] + 1, d["width"]
    rows = d["n_users"] + d["n_items"]
    n_bytes = 2 * 8 * d["train_nnz"] + 2 * rows * W * 4
    n_ops = 0
    for s, _r in sides(d):
        n_ops += k4.half_sweep_ops(n, d["train_nnz"]) \
            + k1.half_sweep_ops(n, s)
    for split in ("train", "test"):
        n_bytes += k0b.eval_bytes(d[f"{split}_nnz"], d[f"{split}_users"],
                                  d[f"{split}_items"], W)
        n_ops += k0b.eval_ops(d[f"{split}_nnz"], d["n_factors"])
    return n_bytes, n_ops
