"""Driver: the serving daemon under an open loop of independent users.

A ``ServingDaemon`` with the ``serve`` CLI's settings (``params``:
``max_batch``, ``window_ms``, ``completion_workers``; the fold-in's
hyperparameters the daemon's default ``Config``) over a ``ServingEngine``
of the configuration's widths, warmed (``daemon.warm``) before traffic.
The tables are drawn on the card from the seed; the train ratings, whose
rated items every recommend excludes, are the configuration's planted
ones.

The load is an open loop of independent users at ``rate`` requests a
second for ``--seconds``, submitted in this process through
``ServingDaemon.submit``: ``mix`` gives the shares of ``recommend`` (one
known user, drawn by activity), explicit ``fold_in`` (``fold_items``
items drawn by popularity, ``iterations`` SGD steps) and implicit
``fold_in``.  Every seed gets the same number of requests of each kind,
the same multiset of fold-in lengths and the same multiset of gaps
between arrivals (exponential quantiles), in its own order.  Each request
is timed from when it was due; how late the generator submitted is
printed on standard error.  The window closes when the last request due
in it has its answer (or ``deadline_s`` past its end; a request that never
answers, or answers an error, misses every limit).

Correctness: once the window has closed, a sample of the answers drawn
from the seed (``sample``: so many of each kind, the longest fold-ins
among them) is judged against the plain reference
(``benchmark/reference/mf_serve.py``).
"""

from __future__ import annotations

import gc
import math
import threading
import time

import numpy as np
import torch

from benchmark.gen.planted import generator, planted_split
from benchmark.lib import training
from benchmark.reference import mf_serve

KINDS = ("recommend", "explicit", "implicit")
# The control: the reference put in the program's place with its
# products' inputs rounded to TF32; the faults are planted there too.
FAULTS = ("half_batch", "altered", "unchanged")


def tables(sizes: dict, F: int, seed: int, device):
    """(P, Q, user bias, item bias) float32, drawn on ``device``."""
    g = generator(seed, 2, device)
    U, I = sizes["n_users"], sizes["n_items"]

    def normal(*shape, std):
        return torch.randn(shape, generator=g, device=device) * std

    return (normal(U, F, std=0.1), normal(I, F, std=0.1),
            normal(U, std=0.3), normal(I, std=0.3))


def schedule(train, params: dict, seconds: float, seed: int):
    """[(due offset s, kind, request)] of one window, sorted by due time."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    rate = params["rate"]
    N = max(1, int(round(rate * seconds)))
    mix = params["mix"]
    counts = [int(round(mix[k] * N)) for k in KINDS[:2]]
    counts.append(N - sum(counts))
    kinds = np.repeat(np.arange(3), counts)
    rng.shuffle(kinds)
    gaps = -np.log1p(-(np.arange(N) + 0.5) / N) / rate
    rng.shuffle(gaps)
    due = np.cumsum(gaps) - gaps[0]
    lo, hi = params["fold_items"]
    n_fold = counts[1] + counts[2]
    lens = np.linspace(lo, hi, n_fold).round().astype(int)
    rng.shuffle(lens)
    nnz = train.indptr[-1]
    users = np.searchsorted(train.indptr, rng.integers(0, nnz, N),
                            side="right") - 1
    k = params["k"]
    out, f = [], 0
    for i in range(N):
        kind = KINDS[kinds[i]]
        if kind == "recommend":
            req = {"id": i, "op": "recommend", "user": int(users[i]),
                   "k": k}
        else:
            n = int(lens[f])
            f += 1
            cand = train.indices[rng.integers(0, nnz, 4 * n)]
            _, first = np.unique(cand, return_index=True)
            items = cand[np.sort(first)][:n]
            req = {"id": i, "op": "fold_in",
                   "items": [int(x) for x in items], "k": k}
            if kind == "explicit":
                req["ratings"] = [float(x) for x in
                                  rng.integers(1, 11, len(items)) / 2.0]
                req["iterations"] = params["iterations"]
            else:
                req["ratings"] = [float(x) for x in
                                  rng.integers(1, 6, len(items))]
                req.update(mode="implicit", alpha=params["alpha"],
                           reg=params["reg"])
        out.append((float(due[i]), kind, req))
    return out


class Load:
    """One open-loop window: submits each request when due, and keeps when
    each answer came, whether it was an error, and the answers of the
    requests in ``keep`` (the sample judged), no others."""

    def __init__(self, daemon, plan, keep=()):
        self.daemon, self.plan, self.keep = daemon, plan, set(keep)
        n = len(plan)
        self.done = [None] * n
        self.error = [False] * n
        self.kept: dict = {}
        self.late = np.zeros(n)
        self.left = n
        self.cv = threading.Condition()

    def _on_done(self, i):
        def cb(f):
            t = time.perf_counter()
            ans = f.result()
            self.error[i] = "error" in ans
            if i in self.keep:
                self.kept[i] = ans
            self.done[i] = t
            with self.cv:
                self.left -= 1
                if not self.left:
                    self.cv.notify_all()
        return cb

    def run(self, t0: float, deadline_s: float) -> None:
        for i, (due, _kind, req) in enumerate(self.plan):
            t = t0 + due
            dt = t - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
            self.late[i] = time.perf_counter() - t
            self.daemon.submit(req).add_done_callback(self._on_done(i))
        end = t0 + self.plan[-1][0] + deadline_s
        with self.cv:
            self.cv.wait_for(lambda: not self.left,
                             timeout=max(0.0, end - time.perf_counter()))

    def latencies(self, t0: float) -> np.ndarray:
        """Each request's seconds from due to answer; inf for one that
        never answered or answered an error."""
        out = np.full(len(self.plan), math.inf)
        for i, (due, _k, _r) in enumerate(self.plan):
            if self.done[i] is not None and not self.error[i]:
                out[i] = self.done[i] - (t0 + due)
        return out


def p95(lat: np.ndarray) -> float:
    """The 95th percentile by nearest rank, over every request."""
    s = np.sort(lat)
    return float(s[max(0, math.ceil(0.95 * len(s)) - 1)])


def build(ctx):
    """(daemon, train, reference inputs) of a cell, warmed, not started."""
    from cu2rec_torch.data.csr import CSRRatings
    from cu2rec_torch.models.state import MFModel
    from cu2rec_torch.serve.daemon import ServingDaemon
    from cu2rec_torch.serve.engine import ServingEngine

    dev = ctx.device
    conf, params = ctx.config, ctx.workload["params"]
    F = conf["train"]["n_factors"]
    ctx.log("program imported")
    train, _test = planted_split(conf, ctx.seed, dev)
    P, Q, ub, ib = tables(conf["sizes"], F, ctx.seed, dev)
    mu = float(np.float32(train.data.astype(np.float64).mean()))
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ctx.log(f"ratings and tables drawn: {train.nnz} train ratings")
    model = MFModel(P, Q, ub, ib, torch.tensor(mu, dtype=torch.float32))
    engine = ServingEngine(model, device=dev)
    csr = CSRRatings(indptr=train.indptr, indices=train.indices,
                     data=train.data, n_users=train.n_users,
                     n_items=train.n_items)
    daemon = ServingDaemon(engine, train_csr=csr,
                           max_batch=params["max_batch"],
                           window_ms=params["window_ms"],
                           completion_workers=params["completion_workers"])
    ctx.log("engine and daemon built")
    daemon.warm(max_batch=params["max_batch"],
                max_width=params["fold_items"][1])
    if dev == "cuda":
        torch.cuda.synchronize()
    ctx.log("warmed up")
    ref = {"P": P, "Q": Q, "ub": ub, "ib": ib, "mu": mu}
    return daemon, train, ref


def _counters(daemon) -> tuple[int, int]:
    s = daemon.submit({"op": "stats"}).result()
    return s["batches"], s["mean_batch"] * s["batches"]


def run(ctx) -> dict:
    params = ctx.workload["params"]
    daemon, train, ref = build(ctx)
    plan = schedule(train, params, ctx.seconds, ctx.seed)
    keep = sample([p[1] for p in plan], [p[2] for p in plan], params,
                  ctx.seed)
    load = Load(daemon, plan, keep)
    daemon.start()
    try:
        b0, r0 = _counters(daemon)
        ctx.open_window()
        load.run(ctx.t0, params["deadline_s"])
        b1, r1 = _counters(daemon)
        ctx.close_window()
    finally:
        daemon.close()
    lat = load.latencies(ctx.t0)
    n_failed = int(np.count_nonzero(~np.isfinite(lat)))
    ctx.counters.update(requests=len(plan), batches=b1 - b0,
                        batched_requests=r1 - r0, failed=n_failed)
    ctx.log(f"generator late: mean {load.late.mean() * 1e3:.3f} ms, "
            f"p95 {p95(load.late) * 1e3:.3f} ms, max "
            f"{load.late.max() * 1e3:.3f} ms")
    record = {"attempted": len(plan), "failed": n_failed,
              "memory_peak_bytes": ctx.memory_peak(),
              "latency_p95_s": p95(lat),
              "latency_p50_s": float(np.median(lat)),
              "late_p95_s": p95(load.late)}
    answers = [(kind, req, load.kept.get(i))
               for i, (_d, kind, req) in enumerate(plan)]
    del daemon, load
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    ctx.log(f"window closed after {ctx.window_s:.3f} s; reference")
    values = judge(answers, train, ref, params, ctx.seed, ctx.device)
    values["missing"] = float(n_failed)
    record["checks"] = training.checks(values, ctx.workload["limits"])
    ctx.log("reference done")
    return record


def sample(kinds, reqs, params: dict, seed: int) -> list[int]:
    """Indices of the requests judged: so many of each kind drawn from the
    seed, and each fold-in kind's longest request."""
    rng = np.random.default_rng((int(seed) + 17) % (1 << 63))
    out = []
    for kind in KINDS:
        idx = [i for i, k in enumerate(kinds) if k == kind]
        if not idx:
            continue
        take = rng.choice(idx, size=min(params["sample"][kind], len(idx)),
                          replace=False).tolist()
        if kind != "recommend":
            take.append(max(idx, key=lambda i: len(reqs[i]["items"])))
        out += sorted(set(take))
    return out


def judge(answers, train, ref, params, seed: int, device,
          tf32: bool = False, fault: str | None = None) -> dict:
    """(score_gap, rank_gap) over the sampled answers, each the worst.
    ``tf32`` and ``fault`` put the reference, so changed, in the program's
    place (the control and the planted faults): its own answers are then
    judged."""
    from benchmark.reference.mf_sgd import Hyper

    P, Q = (ref[k].to(device, torch.float64) for k in ("P", "Q"))
    ub, ib = (ref[k].to(device, torch.float64) for k in ("ub", "ib"))
    mu = ref["mu"]
    hp = Hyper({"learning_rate": 0.01, "P_reg": 0.02, "Q_reg": 0.02,
                "user_bias_reg": 0.02, "item_bias_reg": 0.02})
    hpd = {"lr": hp.lr, "P_reg": hp.P_reg, "ub_reg": hp.ub_reg}
    key = (0, 42)                       # the daemon's Config().seed
    slots = params["max_batch"]
    worst = {"score_gap": 0.0, "rank_gap": 0.0}
    for i in sample([a[0] for a in answers], [a[1] for a in answers],
                    params, seed):
        kind, req, ans = answers[i]
        if ans is None or "error" in ans:
            worst = dict.fromkeys(worst, mf_serve.MISSING)
            break
        if kind == "recommend":
            u = req["user"]
            cands = mf_serve.scores(P[u:u + 1], ub[u:u + 1], Q, ib, mu)
            excl = mf_serve.rated_of(train.indptr, train.indices, u)
        elif kind == "implicit":
            x = mf_serve.implicit_row(Q, req["items"], req["ratings"],
                                      float(np.float32(req["alpha"])),
                                      float(np.float32(req["reg"])))
            cands = mf_serve.scores(x[None], torch.zeros(1, device=device,
                                                         dtype=x.dtype),
                                    Q, ib, mu)
            excl = req["items"]
        else:
            rows = mf_serve.explicit_rows(Q, ib, mu, req["items"],
                                          req["ratings"], key,
                                          req["iterations"], hpd, slots,
                                          device)
            F = Q.shape[1]
            cands = mf_serve.scores(rows[:, :F], rows[:, F], Q, ib, mu)
            excl = req["items"]
        got_items, got_scores = ans["items"], ans["scores"]
        if fault is not None or tf32:
            got_items, got_scores = _stand_in(req, kind, excl, P, ub, Q, ib,
                                              mu, tf32, fault, i)
        best = mf_serve.judge(cands, excl, got_items, got_scores)
        worst["score_gap"] = max(worst["score_gap"], best[0])
        worst["rank_gap"] = max(worst["rank_gap"], best[1])
    return worst


def _stand_in(req, kind, excl, P, ub, Q, ib, mu, tf32, fault, i):
    """The answer of the reference put in the program's place: with its
    scores' inputs in TF32 (the control), or with a planted fault: every
    other answer for another user's row (half of the batch wrong), one
    answer's first item swapped for an unrated item far down the list,
    or the fold-in left where it started."""
    k = 10
    if kind == "recommend":
        u = req["user"] if not (fault == "half_batch" and i % 2) else \
            (req["user"] + 1) % P.shape[0]
        s = mf_serve.scores(P[u:u + 1], ub[u:u + 1], Q, ib, mu, tf32)[0]
    elif kind == "implicit":
        x = mf_serve.implicit_row(Q, req["items"], req["ratings"],
                                  req["alpha"], req["reg"], tf32)
        s = mf_serve.scores(x[None], torch.zeros(1, device=Q.device,
                                                 dtype=x.dtype),
                            Q, ib, mu, tf32)[0]
    else:
        F = Q.shape[1]
        n_it = 0 if fault == "unchanged" else req["iterations"]
        rows = mf_serve.explicit_rows(Q, ib, mu, req["items"],
                                      req["ratings"], (0, 42), n_it,
                                      {"lr": float(np.float32(0.01)),
                                       "P_reg": float(np.float32(0.02)),
                                       "ub_reg": float(np.float32(0.02))},
                                      1, Q.device)
        s = mf_serve.scores(rows[:, :F], rows[:, F], Q, ib, mu, tf32)[0]
    s = s.clone()
    if len(excl):
        s[torch.as_tensor(excl, dtype=torch.int64, device=s.device)] = \
            -math.inf
    v, it = torch.topk(s, k)
    items, scores = it.tolist(), v.tolist()
    if fault == "altered":
        far = torch.argsort(s, descending=True)[len(s) // 2]
        items[0], scores[0] = int(far), float(s[far])
    return items, scores


def readings(ctx, mode: str) -> dict:
    """The compared numbers of one seed: of the program (``program``), of
    the control (``control``) or of a planted fault (one of ``FAULTS``):
    the reference, so changed, answers the same sampled requests."""
    if mode == "program":
        return {c["name"]: c["value"] for c in run(ctx)["checks"]}
    params = ctx.workload["params"]
    conf = ctx.config
    F = conf["train"]["n_factors"]
    train, _ = planted_split(conf, ctx.seed, ctx.device)
    P, Q, ub, ib = tables(conf["sizes"], F, ctx.seed, ctx.device)
    ref = {"P": P, "Q": Q, "ub": ub, "ib": ib,
           "mu": float(np.float32(train.data.astype(np.float64).mean()))}
    plan = schedule(train, params, ctx.seconds, ctx.seed)
    answers = [(kind, req, {"items": [], "scores": []})
               for _d, kind, req in plan]
    values = judge(answers, train, ref, params, ctx.seed, ctx.device,
                   tf32=mode == "control",
                   fault=None if mode == "control" else mode)
    return values


def sweep(ctx, rates) -> list[dict]:
    """The knee: one daemon, a window of ``--seconds`` at each rate in
    turn; each window's p50 and p95 from due time, the generator's
    lateness, and the p95 of the window's last quarter of requests beside
    its first (a backlog that grows reads well above it).  Each window
    starts as ``run`` does: set-up's garbage collected and frozen."""
    params = dict(ctx.workload["params"])
    daemon, train, _ref = build(ctx)
    daemon.start()
    out = []
    try:
        for rate in rates:
            params["rate"] = rate
            plan = schedule(train, params, ctx.seconds, ctx.seed + rate)
            load = Load(daemon, plan)
            gc.collect()
            gc.freeze()
            t0 = time.perf_counter() + 0.05
            load.run(t0, params["deadline_s"])
            lat = load.latencies(t0)
            q = max(1, len(lat) // 4)
            out.append({"rate": rate, "requests": len(lat),
                        "p50_ms": float(np.median(lat)) * 1e3,
                        "p95_ms": p95(lat) * 1e3,
                        "first_quarter_p95_ms": p95(lat[:q]) * 1e3,
                        "last_quarter_p95_ms": p95(lat[-q:]) * 1e3,
                        "failed": int(np.count_nonzero(~np.isfinite(lat))),
                        "late_p95_ms": p95(load.late) * 1e3,
                        "span_s": max(d for d in load.done if d) - t0})
            ctx.log(f"sweep {out[-1]}")
    finally:
        daemon.close()
    return out
