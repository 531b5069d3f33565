"""Driver: one ALS training call, sweep after sweep, as ``mf --algo als``
runs it.

``train_als`` prepares its chunks, runs its first sweep and evaluates it
(kernel K0b) before the window opens: the window opens at its first
``log_eval``, seen through the benchmark's own ``MetricsLogger``, and
closes at the first eval point after ``--seconds``, where the logger ends
the call.  ``total_iterations`` outlasts any window.  Each sweep's Grams
are kernel K4 and its solves kernel K1.

Correctness: the benchmark wraps the trainer's ``als_half_sweep`` (its
module attribute; the program's files are not edited) to time each half
sweep's host call and to copy the tables at the start and after sweeps 1
and 3 into pinned host memory as they are made; the logger keeps the
evals of sweeps 1 to 3.  Once the window has closed and the program's
state is freed, the plain reference (``benchmark/reference/mf_als.py``)
draws the same start, solves the same three sweeps in float64 and
evaluates each.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.gen.planted import planted_split
from benchmark.lib import training
from benchmark.lib.training import WindowClosed
from benchmark.reference import mf_als, mf_sgd

REG_KEYS = ("P_reg", "Q_reg", "user_bias_reg", "item_bias_reg")
# Far more sweeps than any window holds: the window ends the call.
SWEEPS = 1_000_000
# The control is the reference put in the program's place, its Grams'
# inputs rounded to TF32 (``mf_als.tf32``); the faults are planted there.
FAULTS = ("unchanged", "half_users", "altered", "eval_half")


def run(ctx) -> dict:
    from cu2rec_torch.data.csr import CSRRatings
    from cu2rec_torch.ops.packed import packed_width
    from cu2rec_torch.train import als as als_mod
    from cu2rec_torch.utils.config import Config
    from cu2rec_torch.utils.metrics import MetricsLogger

    dev = ctx.device
    conf = ctx.config
    F = conf["train"]["n_factors"]
    regs = {k: conf["train"][k] for k in REG_KEYS}
    ctx.log("program imported")
    train, test = planted_split(conf, ctx.seed, dev)
    ctx.log(f"ratings drawn: {train.nnz} train, {test.nnz} test")
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    U, I = train.n_users, train.n_items
    mu = float(train.data.astype(np.float64).mean())
    seed = training.job_seed(ctx.seed, 0)
    cfg = Config(seed=seed, n_factors=F, total_iterations=SWEEPS,
                 algo="als", dtype="float32", **regs)
    W = packed_width(F)
    snaps = training.Snapshots([(U, W), (I, W)], torch.float32,
                               pin=dev == "cuda")
    evals = []
    calls = {"n": 0, "T_u": None}
    half_ms = []

    orig = als_mod.als_half_sweep

    def half_sweep(T_self, T_other, *a, **k):
        n = calls["n"]
        calls["n"] += 1
        if n == 0:
            snaps.take(0, T_self, T_other)
        with ctx.spans.span("als_half_sweep"):
            out = orig(T_self, T_other, *a, **k)
        if n % 2 == 0:
            calls["T_u"] = out
        elif n in (1, 5):
            snaps.take(1 if n == 1 else 2, calls["T_u"], out)
        if ctx.spans.on:
            ctx.counters["half_sweeps"] = ctx.counters.get("half_sweeps",
                                                           0) + 1
        return out

    def on_eval(sweep, kw):
        if sweep <= 3:
            evals.append((sweep, kw["train_rmse"], kw["test_rmse"]))
        if ctx.t0 is None:
            ctx.log("first sweep done")
            ctx.open_window()
            return
        c = ctx.counters
        c["sweeps"] = c.get("sweeps", 0) + 1
        half_ms.append(sum(kw["extras"]["half_sweep_ms"]))
        if ctx.expired():
            raise WindowClosed

    logger = training.make_logger_class(MetricsLogger, ctx, on_eval)()

    def csr(s):
        return CSRRatings(indptr=s.indptr, indices=s.indices, data=s.data,
                          n_users=s.n_users, n_items=s.n_items)

    als_mod.als_half_sweep = half_sweep
    try:
        als_mod.train_als(csr(train), csr(test), cfg, mu, logger=logger,
                          device=dev)
    except WindowClosed:
        pass
    finally:
        als_mod.als_half_sweep = orig
    calls["T_u"] = None
    ctx.close_window()
    record = {"attempted": ctx.counters.get("sweeps", 0), "failed": 0,
              "memory_peak_bytes": ctx.memory_peak(),
              "data": training.data_record(train, test, W, F, 4),
              "half_sweep_ms": half_ms}
    if dev == "cuda":
        torch.cuda.empty_cache()
    ctx.log(f"window closed after {ctx.window_s:.3f} s; reference")
    prog = {"tables": snaps.tables(F), "evals": evals}
    ref = reference_run(conf, train, test, seed, mu, dev)
    record["checks"] = training.checks(training.numbers(prog, ref),
                                       ctx.workload["limits"])
    ctx.log("reference done")
    return record


def reference_run(conf: dict, train, test, seed: int, mu: float, device,
                  fault: str | None = None, tf32: bool = False) -> dict:
    """The reference's tables at the start, after sweep 1 and after sweep
    3, and its RMSE after each of the three.  ``tf32`` rounds the Grams'
    inputs to TF32 (the control); ``fault`` plants one of ``FAULTS``."""
    F = conf["train"]["n_factors"]
    regs = {k: float(np.float32(conf["train"][k])) for k in REG_KEYS}
    mu = float(np.float32(mu))
    u_csr = mf_sgd.to_csr(train, device)
    i_csr = mf_als.transpose(*u_csr, train.n_items)
    te_csr = mf_sgd.to_csr(test, device)
    t0 = mf_sgd.init_tables(train.n_users, train.n_items, F, seed)
    skip = None
    if fault == "half_users":
        skip = torch.arange(train.n_users, device=device) % 2 == 1
    tabs = [tuple(t.to(device, torch.float64) for t in t0)]
    ev_tr, ev_te = u_csr, te_csr
    if fault == "eval_half":
        ev_tr, ev_te = training.half_csr(u_csr), training.half_csr(te_csr)
    evals = []
    for sweep in range(1, 4):
        nxt = mf_als.sweep(tabs[-1], mu, u_csr, i_csr, regs, tf32, skip)
        if fault == "unchanged":
            nxt = tabs[-1]
        if fault == "altered" and sweep == 1:
            nxt = (training.double_change(nxt[0], tabs[-1][0]), *nxt[1:])
        tabs.append(nxt)
        evals.append((sweep, mf_sgd.rmse(nxt, mu, ev_tr),
                      mf_sgd.rmse(nxt, mu, ev_te)))
    return {"tables": [training.ref_leaves(tabs[k]) for k in (0, 1, 3)],
            "evals": evals}


def readings(ctx, mode: str) -> dict:
    """The compared numbers of one seed: of the program (``program``), of
    the control (``control``: the TF32 reference in the program's place)
    or of a planted fault (one of ``FAULTS``)."""
    if mode == "program":
        return {c["name"]: c["value"] for c in run(ctx)["checks"]}
    conf = ctx.config
    train, test = planted_split(conf, ctx.seed, ctx.device)
    mu = float(train.data.astype(np.float64).mean())
    seed = training.job_seed(ctx.seed, 0)
    ref = reference_run(conf, train, test, seed, mu, ctx.device)
    if mode == "control":
        bad = reference_run(conf, train, test, seed, mu, ctx.device,
                            tf32=True)
    else:
        bad = reference_run(conf, train, test, seed, mu, ctx.device,
                            fault=mode)
    return training.numbers(bad, ref)
