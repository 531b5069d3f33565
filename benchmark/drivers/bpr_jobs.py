"""Driver: one BPR training call, step after step, as ``mf --algo bpr``
runs it.

``train_bpr`` draws its tables (kernel K5), uploads the ratings with their
item-major arrays, runs iteration 1 and evaluates it (the sampled AUC,
then recall@k and NDCG@k from ``ranking_eval``'s catalog scan and top-k)
before the window opens: the window opens at its first
``log_eval_implicit``, seen through the benchmark's own ``MetricsLogger``,
and closes at the first eval point after ``--seconds``, where the logger
ends the call.  ``total_iterations`` outlasts any window.  Each step is
plain torch: the five draw streams, the user pass and the two item passes.

The benchmark's spans ``bpr_run_steps`` and ``bpr_eval`` wrap the
trainer's calls (its module attributes; the program's files are not
edited), so that a trace names the idle gaps under them, and count the
window's steps and evals.  With ``--trace 1`` the driver also records the
program's own spans and counters (``benchmark/lib/program_trace.py``) over
the window and returns their sums in its record.

Correctness: the benchmark wraps ``ops.bpr.bpr_step`` to copy the tables
at the start and after steps 1 and 3 into pinned host memory as they are
made; the logger keeps iteration 1's AUC.  Once the window has closed and
the program's state is freed, the plain reference
(``benchmark/reference/mf_bpr.py``) draws the same start, takes the same
three steps in float64 and computes the AUC after step 1 over the same
pairs.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from benchmark.gen.planted import planted_split
from benchmark.lib import training
from benchmark.lib.program_trace import ProgramTrace
from benchmark.lib.training import WindowClosed
from benchmark.reference import mf_als, mf_bpr, mf_sgd

TRAIN_KEYS = ("learning_rate", "P_reg", "Q_reg", "user_bias_reg",
              "item_bias_reg", "check_error", "total_iterations", "dtype")
# The control: the program's own lower-precision path (bf16 tables).
CONTROL = {"dtype": "bfloat16"}
# Faults planted in the reference put in the program's place.
FAULTS = ("unchanged", "half_users", "altered", "eval_half",
          "no_item_negative")


def make_logger_class(MetricsLogger, on_eval):
    """A quiet ``MetricsLogger`` whose every implicit eval record goes to
    ``on_eval(iteration, record)``, which may raise ``WindowClosed``."""

    class Logger(MetricsLogger):
        def __init__(self):
            super().__init__(verbose=False)

        def log_eval_implicit(self, iteration, **kw):
            super().log_eval_implicit(iteration, **kw)
            on_eval(iteration, kw)

    return Logger


def eval_sizes(train_bpr, train, test, seed: int) -> dict:
    """What the window's evals read, for the counts: the AUC's pairs and
    the rows they touch; the ranking eval's users (``train_bpr``'s default
    ``recall_users``, as ``mf`` calls it) and their train and test
    interactions."""
    defaults = inspect.signature(train_bpr).parameters
    users, pos, neg = mf_bpr.auc_pairs(test, train.n_items, seed)
    ranked = np.nonzero(np.diff(test.indptr) > 0)[0][
        :defaults["recall_users"].default]
    return {"auc_pairs": len(users),
            "auc_users": int(np.unique(users).size),
            "auc_items": int(np.unique(np.concatenate([pos, neg])).size),
            "rank_users": len(ranked),
            "rank_k": min(defaults["recall_k"].default, train.n_items),
            "rank_train_nnz": int(np.diff(train.indptr)[ranked].sum()),
            "rank_test_nnz": int(np.diff(test.indptr)[ranked].sum())}


def run(ctx, overrides: dict | None = None) -> dict:
    from cu2rec_torch.data.csr import CSRRatings
    from cu2rec_torch.ops import bpr as ops_bpr
    from cu2rec_torch.ops.packed import packed_width
    from cu2rec_torch.train import bpr as bpr_mod
    from cu2rec_torch.utils.config import Config
    from cu2rec_torch.utils.metrics import MetricsLogger

    program = ProgramTrace.start() if ctx.trace else None
    dev = ctx.device
    conf = ctx.config
    tr = {k: ctx.workload["params"][k] for k in TRAIN_KEYS}
    tr.update(overrides or {})
    F = conf["train"]["n_factors"]
    ctx.log("program imported")
    train, test = planted_split(conf, ctx.seed, dev)
    ctx.log(f"ratings drawn: {train.nnz} train, {test.nnz} test")
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    U, I = train.n_users, train.n_items
    seed = training.job_seed(ctx.seed, 0)
    cfg = Config(seed=seed, n_factors=F, algo="bpr", **tr)
    W = packed_width(F)
    dtype = torch.bfloat16 if tr["dtype"] == "bfloat16" else torch.float32
    snaps = training.Snapshots([(U, W), (I, W)], dtype, pin=dev == "cuda")
    evals = []
    last = {"point": 0}

    def count(key, n=1):
        if ctx.spans.on:
            ctx.counters[key] = ctx.counters.get(key, 0) + n

    orig = {name: getattr(mod, name) for mod, name in (
        (ops_bpr, "bpr_step"), (bpr_mod, "bpr_run_steps"),
        (bpr_mod, "auc_eval"), (bpr_mod, "ranking_eval"))}

    def bpr_step(pm, dev_r, hp, key, iteration):
        if iteration == 0 and not snaps.taken[0]:
            snaps.take(0, pm.T_u, pm.T_i)
        out = orig["bpr_step"](pm, dev_r, hp, key, iteration)
        k = {0: 1, 2: 2}.get(iteration)
        if k is not None and not snaps.taken[k]:
            snaps.take(k, out.T_u, out.T_i)
        return out

    def run_steps(pm, dev_r, hp, key, start_iter, n_steps):
        count("steps", n_steps)
        with ctx.spans.span("bpr_run_steps"):
            return orig["bpr_run_steps"](pm, dev_r, hp, key, start_iter,
                                         n_steps)

    def auc_eval(*a, **k):
        count("evals")
        with ctx.spans.span("bpr_eval"):
            return orig["auc_eval"](*a, **k)

    def ranking_eval(*a, **k):
        with ctx.spans.span("bpr_eval"):
            return orig["ranking_eval"](*a, **k)

    def on_eval(point, kw):
        if point == 1:
            evals.append((point, kw["auc"]))
        if ctx.t0 is None:
            ctx.log("first step and eval done")
            if program is not None:
                program.open_window()
            ctx.open_window()
        else:
            count("iterations", point - last["point"])
        last["point"] = point
        if ctx.expired():
            raise WindowClosed

    logger = make_logger_class(MetricsLogger, on_eval)()

    def csr(s):
        return CSRRatings(indptr=s.indptr, indices=s.indices, data=s.data,
                          n_users=s.n_users, n_items=s.n_items)

    ops_bpr.bpr_step = bpr_step
    bpr_mod.bpr_run_steps, bpr_mod.auc_eval = run_steps, auc_eval
    bpr_mod.ranking_eval = ranking_eval
    try:
        bpr_mod.train_bpr(csr(train), csr(test), cfg, logger=logger,
                          device=dev)
    except WindowClosed:
        pass
    finally:
        ops_bpr.bpr_step = orig["bpr_step"]
        for name in ("bpr_run_steps", "auc_eval", "ranking_eval"):
            setattr(bpr_mod, name, orig[name])
    ctx.close_window()
    record = {"attempted": ctx.counters.get("iterations", 0), "failed": 0,
              "memory_peak_bytes": ctx.memory_peak(),
              "data": {**training.data_record(train, test, W, F,
                                              dtype.itemsize),
                       **eval_sizes(bpr_mod.train_bpr, train, test,
                                    seed)}}
    if program is not None:
        program.close_window()
        record.update(program.record(ctx.t0, ctx.t_end))
    if dev == "cuda":
        torch.cuda.empty_cache()
    ctx.log(f"window closed after {ctx.window_s:.3f} s; reference")
    prog = {"tables": snaps.tables(F), "evals": evals}
    ref = reference_run(tr, F, train, test, seed, dev)
    record["checks"] = training.checks(training.numbers(prog, ref),
                                       ctx.workload["limits"])
    ctx.log("reference done")
    return record


def reference_run(tr: dict, F: int, train, test, seed: int, device,
                  fault: str | None = None) -> dict:
    """The reference's tables at the start, after step 1 and after step 3,
    and its AUC after step 1.  ``fault`` plants one of ``FAULTS``, for the
    readings of the limits."""
    hp = mf_sgd.Hyper(tr)
    key = mf_bpr.key_of(seed)
    csr = mf_sgd.to_csr(train, device)
    it_csr = mf_als.transpose(*csr, train.n_items)
    skip = None
    if fault == "half_users":
        skip = torch.arange(train.n_users, device=device) % 2 == 1
    t0 = mf_bpr.init_tables(train.n_users, train.n_items, F, seed)
    tabs = [tuple(t.to(device, torch.float64) for t in t0)]
    for it in range(3):
        nxt = mf_bpr.step(tabs[-1], csr, it_csr, hp, key, it, skip,
                          item_negative=fault != "no_item_negative")
        if fault == "unchanged":
            nxt = tabs[-1]
        if fault == "altered" and it == 0:
            nxt = (training.double_change(nxt[0], tabs[-1][0]), *nxt[1:])
        tabs.append(nxt)
    pairs = mf_bpr.auc_pairs(test, train.n_items, seed)
    if fault == "eval_half":
        pairs = tuple(a[:(len(a) + 1) // 2] for a in pairs)
    return {"tables": [training.ref_leaves(tabs[k]) for k in (0, 1, 3)],
            "evals": [(1, mf_bpr.auc(tabs[1], pairs))]}


def readings(ctx, mode: str) -> dict:
    """The compared numbers of one seed: of the program (``program``), of
    the control (``control``) or of a planted fault (one of ``FAULTS``)."""
    if mode in ("program", "control"):
        rec = run(ctx, CONTROL if mode == "control" else None)
        return {c["name"]: c["value"] for c in rec["checks"]}
    tr = {k: ctx.workload["params"][k] for k in TRAIN_KEYS}
    F = ctx.config["train"]["n_factors"]
    train, test = planted_split(ctx.config, ctx.seed, ctx.device)
    seed = training.job_seed(ctx.seed, 0)
    ref = reference_run(tr, F, train, test, seed, ctx.device)
    bad = reference_run(tr, F, train, test, seed, ctx.device, fault=mode)
    return training.numbers(bad, ref)
