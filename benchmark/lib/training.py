"""What the training drivers share: the window's end at an eval point, the
copies of the watched tables, the data's sizes for the counts, and the
compared numbers.

A training cell compares the program with the plain reference over the
first three steps (SGD iterations or ALS sweeps) of what its window runs:

* ``start_gap``: the largest difference of any entry of the starting
  tables (both sides draw them from the seed: exact, limit 0);
* ``update1_gap``: by the worst leaf (P, Q, user bias, item bias), the gap
  between the norms of the change made by step 1, against the reference's
  norm of that leaf or of the median leaf, whichever is larger;
* ``change3_gap``: the same for the change after step 3;
* ``change3_max_gap``: by the worst leaf, the widest difference of one
  entry of the change after step 3, against the largest entry of the
  reference's change there;
* ``eval_gap``: the widest relative gap between the program's train and
  test RMSE at the compared eval points and the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.lib import compare

NUMBERS = ("start_gap", "update1_gap", "change3_gap", "change3_max_gap",
           "eval_gap")
# What a run reads when its window ended before the watched steps.
MISSING = 1e30


class WindowClosed(Exception):
    """Raised by a driver's logger at the first eval point after the
    window, to end the program's call there."""


def job_seed(seed: int, job: int) -> int:
    return (int(seed) + int(job) * 1_000_000_007) % (1 << 62)


def leaves(T_u: torch.Tensor, T_i: torch.Tensor, F: int) -> dict:
    """The model's four leaves of packed tables [x(F) | b | 0...]."""
    return {"P": T_u[:, :F], "ub": T_u[:, F], "Q": T_i[:, :F],
            "ib": T_i[:, F]}


def ref_leaves(tables) -> dict:
    P, Q, ub, ib = tables
    return {"P": P, "Q": Q, "ub": ub, "ib": ib}


class Snapshots:
    """Copies of the watched tables (T_u, T_i) at up to three points, in
    pinned host memory on the card, copied as they are made: the copies
    queue behind the work that made them, and nothing waits for them."""

    def __init__(self, shapes, dtype, pin: bool):
        self.bufs = [[torch.empty(s, dtype=dtype, pin_memory=pin)
                      for s in shapes] for _ in range(3)]
        self.taken = [False] * 3

    def take(self, k: int, T_u: torch.Tensor, T_i: torch.Tensor) -> None:
        for buf, t in zip(self.bufs[k], (T_u, T_i)):
            buf.copy_(t, non_blocking=True)
        self.taken[k] = True

    def tables(self, F: int) -> list:
        return [leaves(*b, F) for b, ok in zip(self.bufs, self.taken) if ok]


def data_record(train, test, W: int, F: int, elem: int) -> dict:
    """Sizes the per-layer readers count bytes and operations from."""
    def rows_with(s):
        return int(np.count_nonzero(np.diff(s.indptr)))

    def cols_with(s):
        return int(np.count_nonzero(np.bincount(s.indices,
                                                minlength=s.n_items)))

    return {"n_users": train.n_users, "n_items": train.n_items,
            "n_factors": F, "width": W, "elem": elem,
            "train_nnz": train.nnz, "test_nnz": test.nnz,
            "train_users": rows_with(train), "train_items": cols_with(train),
            "test_users": rows_with(test), "test_items": cols_with(test)}


def double_change(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` with the row that changed most changed twice as much: a
    planted fault, one answer altered where it is made."""
    u = int(torch.linalg.vector_norm((new - old).reshape(new.shape[0], -1)
                                     .to(torch.float64), dim=1).argmax())
    out = new.clone()
    out[u] = 2 * new[u] - old[u]
    return out


def half_csr(csr):
    """The first half (rounded up) of each row's ratings of an (indptr,
    indices, data) CSR: a planted fault, an eval's mean taken over half of
    its ratings."""
    indptr, indices, data = csr
    n = (indptr[1:] - indptr[:-1]).long()
    row = torch.repeat_interleave(torch.arange(n.shape[0],
                                               device=n.device), n)
    pos = torch.arange(indices.shape[0], device=n.device) \
        - indptr[:-1].long()[row]
    sel = pos < (n[row] + 1) // 2
    new_ptr = torch.zeros_like(indptr)
    new_ptr[1:] = torch.cumsum((n + 1) // 2, 0).to(indptr.dtype)
    return new_ptr, indices[sel], data[sel]


def numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers: ``prog`` and ``ref`` each hold ``tables``
    (leaf dicts at the start, after step 1 and after step 3) and
    ``evals`` ([(point, train RMSE, test RMSE)] at the compared points)."""
    p, r = prog["tables"], ref["tables"]
    pe = {e[0]: e[1:] for e in prog["evals"]}
    if len(p) < 3 or any(e[0] not in pe for e in ref["evals"]):
        return dict.fromkeys(NUMBERS, MISSING)
    dev = r[0]["P"].device

    def diff(a, b):
        return {k: a[k].to(dev, torch.float64) - b[k].to(dev, torch.float64)
                for k in b}

    d1p, d1r = diff(p[1], p[0]), diff(r[1], r[0])
    d3p, d3r = diff(p[2], p[0]), diff(r[2], r[0])
    return {
        "start_gap": compare.exact_gap(p[0], r[0]),
        "update1_gap": compare.norm_gap(d1p, d1r),
        "change3_gap": compare.norm_gap(d3p, d3r),
        "change3_max_gap": compare.max_gap(d3p, d3r),
        "eval_gap": max(abs(a - b) / b for e in ref["evals"]
                        for a, b in zip(pe[e[0]], e[1:])),
    }


def checks(values: dict, limits: dict) -> list[dict]:
    return [compare.check(k, v, limits[k]) for k, v in values.items()]


def make_logger_class(MetricsLogger, ctx, on_eval):
    """A quiet ``MetricsLogger`` whose every eval record goes to
    ``on_eval(iteration, record)``, which may raise ``WindowClosed``."""

    class Logger(MetricsLogger):
        def __init__(self):
            super().__init__(verbose=False)

        def log_eval(self, iteration, **kw):
            super().log_eval(iteration, **kw)
            on_eval(iteration, kw)

        def log_lr_decay(self, new_lr):
            super().log_lr_decay(new_lr)
            if ctx.spans.on:
                c = ctx.counters
                c["lr_decays"] = c.get("lr_decays", 0) + 1

    return Logger
