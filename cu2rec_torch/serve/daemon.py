"""Warm-pool serving daemon: a long-lived process around a serving engine
(one GPU, or a catalog item-sharded over several) with cross-request
micro-batching.

The reference's serving story is one process launch per user
(predict.cu:72-133: load Q/item_bias/global_bias, partial-fit, score,
sort, print, exit).  The daemon inverts it: the catalog is uploaded ONCE,
then requests stream in over stdio or a unix socket and are coalesced into
engine-sized batches.

Micro-batching: the dispatcher blocks for the first pending request,
then drains everything that arrives within ``window_ms`` (up to
``max_batch``), groups compatible requests (same op / k / iteration
count), and executes each group as ONE engine call — fold-ins ride one
``fold_in_and_recommend`` over the catalog, known-user recommends ride one
scoring batch.  The engine pads every batch to a power of two;
``warm()`` runs that ladder of padded signatures once at startup.

Pipelining: CUDA launches are asynchronous — an engine call returns device
tensors while the card works — so the dispatcher hands the un-materialized
results to a completion thread and starts forming the next batch at once.
Copying batch N's results to the host (``.cpu()``, which waits for the
card) overlaps batch N+1's dispatch.

This module is the TPU package's ``serve/daemon.py`` with the same request
protocol; only materialization differs (``.cpu().numpy()`` in the
completion thread), and ``stats`` also names the engine's lead device
(``device``) and each shard's (``devices``).

Request protocol (JSONL, one object per line):

    {"id": 1, "op": "fold_in", "items": [3, 7], "ratings": [5.0, 3.5],
     "k": 10, "iterations": 500}
    {"id": 9, "op": "fold_in", "mode": "implicit", "items": [3, 7],
     "ratings": [2.0, 1.0], "alpha": 40.0, "reg": 0.1, "k": 10}
    {"id": 2, "op": "recommend", "user": 42, "k": 10}
    {"id": 3, "op": "recommend", "users": [42, 7, 9], "k": 10}
    {"id": 4, "op": "stats"}

The batch form ("users") amortizes JSON parse + queue + dispatch overhead
over many users — a single client can drive the engine at its measured
batch ceiling without opening hundreds of connections.

Responses (one JSON object per line, in request order per connection):

    {"id": 1, "items": [...], "scores": [...]}
    {"id": 3, "results": [{"items": [...], "scores": [...]}, ...]}
    {"id": 4, "n_items": ..., "requests": ..., "batches": ...}
    {"id": 5, "error": "..."}
"""

from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

from cu2rec_torch.serve.engine import _host, _pow2_pad
from cu2rec_torch.utils.config import Config


@dataclass
class _Pending:
    req: dict
    future: Future = field(default_factory=Future)
    # Engine rows this request occupies in its dispatched group (a batch
    # "users" recommend spans several; everything else spans one).
    n_rows: int = 1


class ServingDaemon:
    """Micro-batching request broker over a ``ServingEngine``.

    ``submit`` is thread-safe and returns a ``Future`` resolving to the
    response dict.  ``process_once`` executes one drain-and-dispatch
    cycle synchronously (tests drive this directly); ``start`` runs it
    on a background thread.
    """

    def __init__(self, engine, train_csr=None, cfg: Config | None = None,
                 max_batch: int = 512, window_ms: float = 4.0,
                 default_k: int = 10, max_rows: int = 4096,
                 max_fold_in_items: int = 16384,
                 completion_workers: int = 4):
        self.engine = engine
        self.train_csr = train_csr
        self.cfg = cfg or Config()
        self.max_batch = max_batch
        self.window_ms = window_ms
        self.default_k = default_k
        # Completion fetches materialize device tensors — each waits for
        # its group's device work and copies to the host.  ONE completer
        # would fetch groups serially, so a cycle that splits into G groups
        # would pay G waits back to back; a small pool overlaps them.
        # Per-connection response order is preserved by each connection's
        # own future queue.
        self.completion_workers = max(1, completion_workers)
        # Engine-call row budget: ``max_batch`` counts REQUESTS, but a
        # batch "users" request carries many rows — without a row cap one
        # dispatch group could flatten to 65536+ rows, whose score tile
        # (B × chunk, engine.py's C formula floors the chunk at 8192
        # items) blows past the ~512 MB budget the chunking was sized
        # for.  Oversized groups split into several engine calls of
        # ≤ max_rows rows each; results are reassembled per request.
        self.max_rows = max_rows
        self.max_fold_in_items = max_fold_in_items
        self._queue: queue.Queue[_Pending] = queue.Queue()
        self._thread: threading.Thread | None = None
        self._completers: list[threading.Thread] = []
        self._completions: queue.Queue | None = None
        self._stop = threading.Event()
        # Counters are touched from every connection thread (submit) and
        # the dispatcher (process_once) — guard the read-modify-writes or
        # pooled multi-client load loses increments.
        self._stats_lock = threading.Lock()
        self.n_requests = 0
        self.n_batches = 0
        self.n_batched_requests = 0

    # -- submission --------------------------------------------------------
    def submit(self, req: dict) -> Future:
        """Validate and enqueue one request; returns its response Future."""
        fut = Future()
        err = self._validate(req)
        if err is not None:
            fut.set_result({"id": req.get("id"), "error": err})
            return fut
        with self._stats_lock:
            self.n_requests += 1
        if req["op"] == "stats":
            fut.set_result(self._stats(req))
            return fut
        self._queue.put(_Pending(req, fut))
        return fut

    @staticmethod
    def _is_int(x) -> bool:
        # bool is a subclass of int in Python — "user": true must not
        # silently serve user 1.
        return isinstance(x, int) and not isinstance(x, bool)

    def _validate(self, req: dict) -> str | None:
        import math
        if not isinstance(req, dict):
            return "request must be a JSON object"
        op = req.get("op")
        if op == "fold_in":
            items = req.get("items")
            ratings = req.get("ratings")
            if not items or not isinstance(items, list):
                return "fold_in needs a non-empty 'items' list"
            if len(items) > self.max_fold_in_items:
                return (f"'items' list too long "
                        f"(max {self.max_fold_in_items})")
            if not isinstance(ratings, list) or len(ratings) != len(items):
                return "'ratings' must match 'items' in length"
            n_items = self.engine.n_items
            if not all(self._is_int(i) and 0 <= i < n_items
                       for i in items):
                return f"item ids must be ints in [0, {n_items})"
            # Finite only: a NaN rating propagates through the fold-in SGD
            # and turns the whole response into a silently empty list.
            if not all(isinstance(r, (int, float))
                       and not isinstance(r, bool) and math.isfinite(r)
                       for r in ratings):
                return "'ratings' must be finite numbers"
            it = req.get("iterations")
            if it is not None and not (self._is_int(it) and it >= 0):
                return "'iterations' must be a non-negative int"
            mode = req.get("mode", "sgd")
            if mode not in ("sgd", "implicit"):
                return "'mode' must be 'sgd' or 'implicit'"
            if mode == "implicit":
                # Strengths are confidence weights c−1 = α·r: a negative
                # one makes the ridge system indefinite → NaN factors →
                # a silently empty recommendation list (the same failure
                # mode the NaN check above guards).
                if any(r < 0 for r in ratings):
                    return ("implicit 'ratings' are confidence strengths "
                            "and must be >= 0")
            for fld in ("alpha", "reg"):
                v = req.get(fld)
                if v is not None and not (
                        isinstance(v, (int, float))
                        and not isinstance(v, bool)
                        and math.isfinite(v) and v >= 0):
                    return f"'{fld}' must be a finite non-negative number"
        elif op == "recommend":
            n_users = int(np.shape(self.engine.P)[0])
            if "users" in req:
                us = req.get("users")
                if req.get("user") is not None:
                    return "'user' and 'users' are mutually exclusive"
                if (not isinstance(us, list) or not us
                        or not all(self._is_int(u) and 0 <= u < n_users
                                   for u in us)):
                    return ("'users' must be a non-empty list of ints in "
                            f"[0, {n_users})")
                if len(us) > 65536:
                    return "'users' batch too large (max 65536)"
            else:
                u = req.get("user")
                if not self._is_int(u) or not (0 <= u < n_users):
                    return f"'user' must be an int in [0, {n_users})"
        elif op == "stats":
            pass
        else:
            return f"unknown op: {op!r}"
        if op != "stats":
            k = req.get("k")
            if k is not None and not (self._is_int(k) and k > 0):
                return "'k' must be a positive int"
        return None

    def _stats(self, req: dict) -> dict:
        with self._stats_lock:
            n_req, n_bat, n_breq = (self.n_requests, self.n_batches,
                                    self.n_batched_requests)
        return {
            "id": req.get("id"),
            "n_items": self.engine.n_items,
            "n_factors": self.engine.F,
            "n_shards": self.engine.n_ip,
            "device": str(self.engine.device),
            "devices": [str(d) for d in self.engine.devices],
            "requests": n_req,
            "batches": n_bat,
            "mean_batch": (n_breq / n_bat if n_bat else 0.0),
        }

    # -- dispatch ----------------------------------------------------------
    def process_once(self, block: bool = True,
                     timeout: float | None = None) -> int:
        """One drain-and-dispatch cycle; returns #requests processed."""
        try:
            first = self._queue.get(block=block, timeout=timeout)
        except queue.Empty:
            return 0
        pend = [first]
        deadline = time.monotonic() + self.window_ms / 1e3
        while len(pend) < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                pend.append(self._queue.get(
                    block=remaining > 0,
                    timeout=remaining if remaining > 0 else None))
            except queue.Empty:
                break
        groups: dict[tuple, list[_Pending]] = {}
        for p in pend:
            r = p.req
            try:
                k = int(r.get("k", self.default_k))
                if r["op"] == "fold_in":
                    if r.get("mode", "sgd") == "implicit":
                        # One exact solve per (alpha, reg): grouping on
                        # the hyperparams keeps each engine call a single
                        # batched ridge solve.
                        key = ("fold_in_implicit", k,
                               float(r.get("alpha", 40.0)),
                               float(r.get("reg", 0.1)))
                    else:
                        key = ("fold_in", k,
                               int(r.get("iterations",
                                         self.cfg.total_iterations)))
                else:
                    key = ("recommend", k)
            except Exception as e:  # noqa: BLE001 — fail the request, not the thread
                self._fail([p], e)
                continue
            groups.setdefault(key, []).append(p)
        # Snapshot the completion queue once per cycle: close() swaps the
        # attribute to None, and a check-then-put against the attribute
        # could fall in that window and kill the dispatch thread.
        completions = self._completions
        for key, grp in groups.items():
            try:
                # Dispatch only — the returned tensors are un-materialized
                # device values (asynchronous CUDA launches).  ``parts`` is a
                # list of (scores, ids, n_real_rows) spans: one for
                # fold-in, possibly several for a recommend group split
                # at the max_rows engine-call budget.
                if key[0] == "fold_in":
                    scores, ids = self._run_fold_in(grp, k=key[1],
                                                    iterations=key[2])
                    parts = [(scores, ids, len(grp))]
                elif key[0] == "fold_in_implicit":
                    parts = self._run_fold_in_implicit(
                        grp, k=key[1], alpha=key[2], reg=key[3])
                else:
                    parts = self._run_recommend(grp, k=key[1])
            except Exception as e:  # noqa: BLE001 — fail the group, not the daemon
                self._fail(grp, e)
            else:
                if completions is not None:
                    completions.put((grp, parts))
                else:
                    self._finish(grp, parts)
            with self._stats_lock:
                self.n_batches += 1
                self.n_batched_requests += len(grp)
        return len(pend)

    @staticmethod
    def _fail(grp: list[_Pending], e: Exception) -> None:
        for p in grp:
            if not p.future.done():
                p.future.set_result(
                    {"id": p.req.get("id"), "error": repr(e)})

    def _finish(self, grp: list[_Pending], parts) -> None:
        """Materialize one dispatched group's result spans and resolve
        futures.  ``parts``: list of (scores, ids, n_real_rows); padded
        surplus rows are trimmed before the spans are joined."""
        try:
            scores = np.concatenate(
                [_host(s)[:n] for s, _, n in parts])
            ids = np.concatenate(
                [_host(i)[:n] for _, i, n in parts])
        except Exception as e:  # noqa: BLE001
            self._fail(grp, e)
            return
        b = 0
        for p in grp:
            if "users" in p.req:
                rows = [self._row(ids[b + j], scores[b + j])
                        for j in range(p.n_rows)]
                p.future.set_result({"id": p.req.get("id"),
                                     "results": rows})
            else:
                p.future.set_result(
                    self._response(p.req, ids[b], scores[b]))
            b += p.n_rows

    @staticmethod
    def _row(ids_row, scores_row) -> dict:
        keep = scores_row > -1e30
        return {"items": [int(i) for i in ids_row[keep]],
                "scores": [round(float(s), 6) for s in scores_row[keep]]}

    @staticmethod
    def _response(req: dict, ids_row, scores_row) -> dict:
        # Fewer than k unrated items leaves surplus slots carrying the
        # engine's mask sentinel (serve/recommend.py contract: < -1e30);
        # trim them rather than surface sentinel "recommendations" (_row).
        resp = {"id": req.get("id")}
        resp.update(ServingDaemon._row(ids_row, scores_row))
        return resp

    @staticmethod
    def _pack_group(grp: list[_Pending]):
        """(rated, vals, mask) padded arrays for a fold-in group — the
        shared request-row packing of both fold-in paths."""
        B = len(grp)
        D = max(len(p.req["items"]) for p in grp)
        rated = np.zeros((B, D), np.int32)
        vals = np.zeros((B, D), np.float32)
        mask = np.zeros((B, D), bool)
        for b, p in enumerate(grp):
            n = len(p.req["items"])
            rated[b, :n] = p.req["items"]
            vals[b, :n] = p.req["ratings"]
            mask[b, :n] = True
        return rated, vals, mask

    def _run_fold_in(self, grp: list[_Pending], k: int, iterations: int):
        rated, vals, mask = self._pack_group(grp)
        import dataclasses
        cfg = dataclasses.replace(self.cfg, total_iterations=iterations,
                                  is_train=False)
        return self.engine.fold_in_and_recommend_padded(
            rated, vals, mask, cfg=cfg, k=k)

    # Element budget for one implicit solve's (B, D, F) gathered-rows
    # tensor: 32 Mi elements = 128 MB float32 (plus the same again for
    # the weighted copy inside the einsum).  The SGD fold-in never
    # materializes a (B, D, F) tensor, so only this path needs the cap.
    _IFOLD_ELEMS = 32 << 20

    def _run_fold_in_implicit(self, grp: list[_Pending], k: int,
                              alpha: float, reg: float):
        """Implicit (iALS) fold-in group: batched exact ridge solves
        against the frozen catalog, then the standard masked recommend.
        'ratings' act as confidence strengths (c = 1 + α·r).

        The group splits into engine calls bounding Bp·Dp·F to
        ``_IFOLD_ELEMS`` (a max_batch group of max-width requests would
        otherwise gather a multi-GB (B, D, F) tensor — the same
        unbounded-tile class max_rows closes for recommends).  Returns
        a parts list like ``_run_recommend``.
        """
        F = self.engine.F
        parts = []
        s = 0
        while s < len(grp):
            d_max = 8
            e = s
            while e < len(grp):
                d = max(d_max, _pow2_pad(len(grp[e].req["items"])))
                n = _pow2_pad(e - s + 1)
                if e > s and n * d * F > self._IFOLD_ELEMS:
                    break
                d_max = d
                e += 1
            sub = grp[s:e]
            rated, vals, mask = self._pack_group(sub)
            # Dispatch-only like the sgd fold-in path: the returned
            # arrays stay un-materialized; the completion pool fetches.
            scores, ids = self.engine.fold_in_implicit_and_recommend_padded(
                rated, vals, mask, alpha=alpha, reg=reg, k=k)
            parts.append((scores, ids, len(sub)))
            s = e
        return parts

    def _run_recommend(self, grp: list[_Pending], k: int):
        flat: list[int] = []
        for p in grp:
            us = p.req.get("users")
            if us is not None:
                p.n_rows = len(us)
                flat.extend(us)
            else:
                flat.append(p.req["user"])
        # Split at the engine-call row budget (a request may straddle
        # spans; _finish reassembles by row position).  Each call's score
        # tile is then bounded by (max_rows, C) regardless of how many
        # rows one client packed into a single "users" request.
        parts = []
        for s in range(0, len(flat), self.max_rows):
            uids = np.asarray(flat[s:s + self.max_rows], np.int64)
            if self.train_csr is not None:
                scores, ids = self.engine.recommend_known_padded(
                    uids, self.train_csr, k=k)
            else:
                # No train CSR loaded: nothing to filter, score the raw
                # rows (host gather from the engine's numpy P).
                pp, ubp = self.engine._pad_rows(self.engine.P[uids],
                                                self.engine.user_bias[uids])
                Bp = pp.shape[0]
                scores, ids = self.engine.recommend_padded(
                    pp, ubp, np.zeros((Bp, 1), np.int32),
                    np.zeros((Bp, 1), bool), k=k)
            parts.append((scores, ids, len(uids)))
        return parts

    # -- lifecycle ---------------------------------------------------------
    def warm(self, max_batch: int | None = None, max_width: int = 32,
             iterations: int | None = None, verbose: bool = False,
             ks: tuple | None = None, ops: tuple | None = None) -> int:
        """Run the pow2 signature ladder once before taking traffic.

        Dispatch pads every batch to a power of two, so steady state uses
        O(log max_batch) padded signatures per op; running each once at
        startup pays the first-call costs (cuBLAS heuristics, allocator
        growth, the K1 build) before traffic arrives.

        Warms recommend at every rated-list width the train CSR can
        produce — known-user filtering pads the rated lists to pow2 of
        the batch's max user degree, so the ladder runs to
        pow2(deg.max()) regardless of ``max_width`` — and fold-in (+ its
        recommend) at request widths up to ``max_width``.  ``ks`` lists
        the top-k values to warm (default: just ``default_k``; signatures
        are keyed on k).  The warm fold-ins run ONE optimisation step: the
        iteration count is not part of a signature.  Returns the number of
        new signatures recorded.

        ``ops`` selects which op ladders to warm, from {"recommend",
        "fold_in", "fold_in_implicit"} (default: all).  An explicit-only
        deployment should pass ``ops=("recommend", "fold_in")`` — the
        implicit rung buys nothing if no iALS fold-ins will be served.
        """
        import dataclasses

        mb = _pow2_pad(max_batch or self.max_batch)
        ladder = []
        b = 8
        while b <= mb:
            ladder.append(b)
            b *= 2
        widths = []
        w = 8
        while w <= _pow2_pad(max_width):
            widths.append(w)
            w *= 2
        # rated lists pad to at least 8 (engine._pad_rated's pow2 floor),
        # including the no-CSR "width 1" path
        rec_widths = {8}
        if self.train_csr is not None:
            deg_max = int(np.diff(self.train_csr.indptr).max(initial=1))
            w = 8
            while w <= _pow2_pad(deg_max):
                rec_widths.add(w)
                w *= 2
        rec_widths.update(widths)  # fold-in's recommend rides its D
        del iterations  # not part of a signature; kept for API
        cfg = dataclasses.replace(self.cfg, is_train=False,
                                  total_iterations=1)
        ks = tuple(ks) if ks else (self.default_k,)
        ops = (tuple(ops) if ops is not None
               else ("recommend", "fold_in", "fold_in_implicit"))
        unknown = set(ops) - {"recommend", "fold_in", "fold_in_implicit"}
        if unknown:
            raise ValueError(f"unknown warm ops: {sorted(unknown)}")
        n0 = len(self.engine._programs)
        for B in ladder:
            for k in ks:
                if "recommend" in ops:
                    for R in sorted(rec_widths):
                        if verbose:
                            print(f"warm recommend B={B} R={R} k={k}",
                                  flush=True)
                        self.engine.recommend_padded(
                            np.zeros((B, self.engine.F), np.float32),
                            np.zeros(B, np.float32),
                            np.zeros((B, R), np.int32),
                            np.zeros((B, R), bool), k=k)
                for D in widths:
                    mask = np.zeros((B, D), bool)
                    mask[:, 0] = True
                    if "fold_in" in ops:
                        if verbose:
                            print(f"warm fold_in B={B} D={D} k={k}",
                                  flush=True)
                        self.engine.fold_in_and_recommend_padded(
                            np.zeros((B, D), np.int32),
                            np.full((B, D), 3.0, np.float32), mask,
                            cfg=cfg, k=k)
                    # Implicit ladder: alpha/reg are not part of a
                    # signature, so one per (B, D, k) covers them all.
                    if "fold_in_implicit" in ops:
                        if verbose:
                            print(f"warm fold_in_implicit B={B} D={D} "
                                  f"k={k}", flush=True)
                        self.engine.fold_in_implicit_and_recommend_padded(
                            np.zeros((B, D), np.int32),
                            np.full((B, D), 1.0, np.float32), mask, k=k)
        return len(self.engine._programs) - n0

    def start(self) -> None:
        if self._thread is not None:
            return
        # Fresh Event per generation: if a previous close() abandoned a
        # wedged dispatcher (join timeout), that thread holds the OLD
        # event — which stays set forever — so it exits the moment its
        # stuck engine call returns instead of being revived by this
        # clear() and double-consuming the queue.
        self._stop = threading.Event()
        stop = self._stop
        self._completions = queue.Queue()

        def complete_loop(q):
            while True:
                item = q.get()
                if item is None:
                    break
                self._finish(*item)

        self._completers = [
            threading.Thread(target=complete_loop,
                             args=(self._completions,), daemon=True,
                             name=f"cu2rec-serve-complete-{w}")
            for w in range(self.completion_workers)]
        for t in self._completers:
            t.start()

        def loop():
            while not stop.is_set():
                try:
                    self.process_once(block=True, timeout=0.05)
                except Exception:  # noqa: BLE001 — keep the daemon alive
                    # Per-request and per-group failures are already
                    # converted to error responses inside process_once;
                    # anything reaching here is unexpected but must not
                    # silently kill the shared dispatcher.
                    import traceback
                    traceback.print_exc()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="cu2rec-serve-dispatch")
        self._thread.start()

    def close(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        # A batch may be mid-dispatch; the loop re-checks _stop between
        # cycles, so a generous join is bounded by one batch, not by
        # traffic.
        self._thread.join(timeout=300.0)
        if self._thread.is_alive():
            # Pathological: dispatcher wedged inside an engine call.
            # Leave the completion queue in place (it may still put) and
            # abandon the threads — they are daemonic.
            self._thread = None
            return
        self._thread = None
        completions, self._completions = self._completions, None
        # Drain anything still queued so no future hangs forever.
        while self.process_once(block=False):
            pass
        for _ in self._completers:
            completions.put(None)
        for t in self._completers:
            t.join(timeout=60.0)
        self._completers = []


# -- transports --------------------------------------------------------------

def run_stdio(daemon: ServingDaemon, infile, outfile) -> int:
    """Serve JSONL requests from ``infile`` to ``outfile`` until EOF.

    Responses are written in request order.  The reader keeps submitting
    while earlier responses are still pending, so consecutive requests
    coalesce into engine batches.
    """
    daemon.start()
    try:
        run_stdio_connection(daemon, infile, outfile)
    finally:
        daemon.close()
    return 0


def run_socket(daemon: ServingDaemon, path: str) -> int:
    """Serve JSONL over a unix socket; one thread per connection, batching
    shared across connections (the warm-pool).  Runs until SIGINT."""
    import os
    import socket

    if os.path.exists(path):
        os.unlink(path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(64)
    daemon.start()
    print(f"serving on {path}", flush=True)

    def handle(conn):
        rf = conn.makefile("r", encoding="utf-8")
        wf = conn.makefile("w", encoding="utf-8")
        try:
            run_stdio_connection(daemon, rf, wf)
        finally:
            conn.close()

    try:
        while True:
            conn, _ = srv.accept()
            threading.Thread(target=handle, args=(conn,),
                             daemon=True).start()
    except KeyboardInterrupt:
        return 0
    finally:
        daemon.close()
        srv.close()
        if os.path.exists(path):
            os.unlink(path)


def run_stdio_connection(daemon: ServingDaemon, infile, outfile) -> None:
    """Per-connection JSONL pump (daemon lifecycle managed by caller)."""
    pending: queue.Queue = queue.Queue()
    done = threading.Event()

    def writer():
        while True:
            fut = pending.get()
            if fut is None:
                break
            try:
                resp = fut.result()
                outfile.write(json.dumps(resp) + "\n")
                outfile.flush()
            except (BrokenPipeError, ValueError):
                break
        done.set()

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    try:
        for line in infile:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except json.JSONDecodeError as e:
                fut = Future()
                fut.set_result({"id": None, "error": f"bad json: {e}"})
                pending.put(fut)
                continue
            pending.put(daemon.submit(req))
    finally:
        pending.put(None)
        done.wait(timeout=60.0)
