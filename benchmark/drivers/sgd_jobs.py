"""Driver: whole SGD training jobs back to back, as ``mf`` runs them.

Each job is ``train_with_engine`` on one ``SingleChipEngine`` (the port's
entry for one card): a fresh ``engine.init_model`` seeded from the run's
seed and the job's index, the trainer's warm-up, its steps (kernel K0a),
its evals at the first iteration and every ``check_error`` (kernel K0b),
its learning-rate plateau decay and its ``finalize``.  The engine, and so
the uploaded ratings, is built once in set-up; a job sets its seed on it
as ``mf`` would build it with that seed.

The window opens when set-up is done and closes at the end of the first
job that ends after ``--seconds``: it holds whole jobs, so that where the
clock falls in a job (a Netflix job spends ~1.3 s of its ~4.4 s drawing
its tables on the host) does not move the rate.  The benchmark's own
``MetricsLogger`` counts each eval point's iterations; spans around the
engine's calls and counters of steps and evals are the benchmark's own.

Correctness: the window's first job is watched.  Its tables at the start,
after step 1 and after step 3 are copied to pinned host memory as they
are made, and the logger keeps its first eval.  Once the window has closed
and the program's state is freed, the plain reference
(``benchmark/reference/mf_sgd.py``) draws the same start from the seed,
takes three steps over the same ratings and evaluates after the first.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.gen.planted import planted_split
from benchmark.lib import training
from benchmark.reference import mf_sgd

TRAIN_KEYS = ("n_factors", "learning_rate", "P_reg", "Q_reg",
              "user_bias_reg", "item_bias_reg", "check_error", "patience",
              "learning_rate_decay", "total_iterations", "collision_policy",
              "dtype")
# The control: the program's own lower-precision path (bf16 tables).
CONTROL = {"dtype": "bfloat16"}
# Faults planted in the reference put in the program's place.
FAULTS = ("unchanged", "half_users", "altered", "eval_half")


class Probe:
    """Copies of the watched job's tables at its start, after step 1 and
    after step 3, taken where the engine's ``run`` makes them."""

    def __init__(self, snaps: training.Snapshots):
        self.snaps = snaps
        self.state0 = self.state1 = None

    def watch(self, state) -> None:
        self.state0 = state
        self.snaps.take(0, state.T_u, state.T_i)

    def run(self, run, state, hp, start_iter: int, n_steps: int):
        """``run`` (the engine's own) over this call, split where a copy is
        due, or None where none is; the steps and their order are the
        call's.  The trainer's first segment is the single step before the
        eval at iteration 1; its second starts at iteration 1."""
        if state is self.state0 and start_iter == 0 and n_steps == 1:
            self.state0 = None
            out = run(state, hp, 0, 1)
            self.snaps.take(1, out.T_u, out.T_i)
            self.state1 = out
            return out
        if state is self.state1 and start_iter == 1 and n_steps >= 2:
            self.state1 = None
            out = run(state, hp, 1, 2)
            self.snaps.take(2, out.T_u, out.T_i)
            if n_steps > 2:
                out = run(out, hp, 3, n_steps - 2)
            return out
        return None


def make_engine_class(SingleChipEngine):
    class Engine(SingleChipEngine):
        """The port's engine with the benchmark's spans and counters
        around its calls, and the probe's copies."""

        def attach(self, ctx, probe):
            self.ctx, self.probe = ctx, probe

        def _count(self, key, n=1):
            if self.ctx.spans.on:
                c = self.ctx.counters
                c[key] = c.get(key, 0) + n

        def init_model(self, *a, **k):
            with self.ctx.spans.span("engine.init_model"):
                return super().init_model(*a, **k)

        def run(self, state, hp, start_iter, n_steps):
            self._count("steps", n_steps)
            with self.ctx.spans.span("engine.run"):
                out = self.probe.run(super().run, state, hp, start_iter,
                                     n_steps)
                if out is None:
                    out = super().run(state, hp, start_iter, n_steps)
            return out

        def evaluate(self, state, split):
            self._count(f"evals_{split}")
            with self.ctx.spans.span("engine.evaluate"):
                return super().evaluate(state, split)

        def finalize(self, state):
            with self.ctx.spans.span("engine.finalize"):
                return super().finalize(state)

    return Engine


def run(ctx, overrides: dict | None = None) -> dict:
    from cu2rec_torch.data.csr import CSRRatings
    from cu2rec_torch.ops.packed import packed_width
    from cu2rec_torch.ops.sgd import Hyper, prng_key
    from cu2rec_torch.train.trainer import (
        SingleChipEngine, train_with_engine,
    )
    from cu2rec_torch.utils.config import Config
    from cu2rec_torch.utils.metrics import MetricsLogger

    dev = ctx.device
    conf = ctx.config
    tr = {k: conf["train"][k] for k in TRAIN_KEYS}
    tr.update(overrides or {})
    F = tr["n_factors"]
    ctx.log("program imported")
    train, test = planted_split(conf, ctx.seed, dev)
    ctx.log(f"ratings drawn: {train.nnz} train, {test.nnz} test")
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    U, I = train.n_users, train.n_items
    mu = float(train.data.astype(np.float64).mean())

    def csr(s):
        return CSRRatings(indptr=s.indptr, indices=s.indices, data=s.data,
                          n_users=s.n_users, n_items=s.n_items)

    cfg = Config(seed=training.job_seed(ctx.seed, 0), **tr)
    engine = make_engine_class(SingleChipEngine)(csr(train), csr(test), cfg,
                                                 device=dev)
    ctx.log("engine built")
    W = packed_width(F)
    dtype = torch.bfloat16 if tr["dtype"] == "bfloat16" else torch.float32
    probe = Probe(training.Snapshots([(U, W), (I, W)], dtype,
                                     pin=dev == "cuda"))
    engine.attach(ctx, probe)
    evals = []
    job = {"last": 0}

    def on_eval(iteration, kw):
        c = ctx.counters
        c["iterations"] = c.get("iterations", 0) + iteration - job["last"]
        job["last"] = iteration
        if not evals:
            evals.append((iteration, kw["train_rmse"], kw["test_rmse"]))

    logger = training.make_logger_class(MetricsLogger, ctx, on_eval)()

    # Warm-up: every kernel this cell runs, at its shapes, on a throwaway.
    warm = engine.init_model(U, I, mu)
    warm = engine.run(warm, Hyper.from_config(cfg), 0, 2)
    engine.evaluate(warm, "train")
    engine.evaluate(warm, "test")
    engine.finalize(warm)
    del warm
    ctx.log("warmed up")

    ctx.open_window()
    jobs = 0
    while not ctx.expired():
        seed_j = training.job_seed(ctx.seed, jobs)
        cfg_j = cfg.replace(seed=seed_j, cur_iterations=0)
        engine.cfg, engine.key = cfg_j, prng_key(seed_j)
        model = engine.init_model(U, I, mu)
        if jobs == 0:
            probe.watch(model)
        jobs += 1
        ctx.counters["jobs"] = jobs
        job["last"] = 0
        model, _losses = train_with_engine(engine, cfg_j, model,
                                           logger=logger)
    ctx.close_window()
    record = {"attempted": jobs, "failed": 0,
              "memory_peak_bytes": ctx.memory_peak(),
              "data": training.data_record(train, test, W, F,
                                           dtype.itemsize)}
    probe.state0 = probe.state1 = None
    del engine, model
    if dev == "cuda":
        torch.cuda.empty_cache()
    ctx.log(f"window closed after {ctx.window_s:.3f} s; reference")
    prog = {"tables": probe.snaps.tables(F), "evals": evals}
    ref = reference_run(tr, train, test, training.job_seed(ctx.seed, 0),
                        mu, dev)
    record["checks"] = training.checks(training.numbers(prog, ref),
                                       ctx.workload["limits"])
    ctx.log("reference done")
    return record


def reference_run(tr: dict, train, test, seed: int, mu: float, device,
                  fault: str | None = None) -> dict:
    """The reference's tables at the start, after step 1 and after step 3,
    and its RMSE after step 1.  ``fault`` plants one of ``FAULTS``, for the
    readings of the limits."""
    F = tr["n_factors"]
    hp = mf_sgd.Hyper(tr)
    mu = float(np.float32(mu))       # the global bias as the tables hold it
    tr_csr = mf_sgd.to_csr(train, device)
    t0 = mf_sgd.init_tables(train.n_users, train.n_items, F, seed)
    skip = None
    if fault == "half_users":
        skip = torch.arange(train.n_users, device=device) % 2 == 1
    tabs = [tuple(t.to(device, torch.float64) for t in t0)]
    for it in range(3):
        nxt = mf_sgd.step(tabs[-1], mu, tr_csr, hp, seed, it, skip)
        if fault == "unchanged":
            nxt = tabs[-1]
        if fault == "altered" and it == 0:
            nxt = (training.double_change(nxt[0], tabs[-1][0]), *nxt[1:])
        tabs.append(nxt)
    te_csr = mf_sgd.to_csr(test, device)
    if fault == "eval_half":
        tr_csr, te_csr = training.half_csr(tr_csr), training.half_csr(te_csr)
    return {"tables": [training.ref_leaves(tabs[k]) for k in (0, 1, 3)],
            "evals": [(1, mf_sgd.rmse(tabs[1], mu, tr_csr),
                       mf_sgd.rmse(tabs[1], mu, te_csr))]}


def readings(ctx, mode: str) -> dict:
    """The compared numbers of one seed: of the program (``program``), of
    the control (``control``) or of a planted fault (one of ``FAULTS``)."""
    if mode in ("program", "control"):
        rec = run(ctx, CONTROL if mode == "control" else None)
        return {c["name"]: c["value"] for c in rec["checks"]}
    conf = ctx.config
    tr = {k: conf["train"][k] for k in TRAIN_KEYS}
    train, test = planted_split(conf, ctx.seed, ctx.device)
    mu = float(train.data.astype(np.float64).mean())
    seed = training.job_seed(ctx.seed, 0)
    ref = reference_run(tr, train, test, seed, mu, ctx.device)
    bad = reference_run(tr, train, test, seed, mu, ctx.device, fault=mode)
    return training.numbers(bad, ref)
