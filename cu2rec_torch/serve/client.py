"""Client for the serving daemon: pipelining + client-side auto-batching.

Single-user ``recommend`` requests pay JSON, queueing and dispatch a row,
while the daemon's batch ``users`` op pays them once for many users.  This
client (a) keeps many requests in flight over one connection, which the
daemon coalesces into engine batches across the pipeline, and (b) merges
single-user ``recommend`` calls into batch ``users`` requests, so callers
keep the one-user-per-call API and still ride the batch path.

    from cu2rec_torch.serve.client import ServeClient

    with ServeClient(socket_path="/tmp/cu2rec.sock") as c:
        futs = [c.recommend(u, k=10) for u in range(10_000)]
        results = [f.result() for f in futs]          # auto-batched
        c.fold_in([3, 7], [5.0, 3.5], k=10).result()  # pass-through

Wire protocol: the JSONL request/response contract of ``serve/daemon.py``
(the replacement for the reference's process-per-user predict binary,
predict.cu:72-133).  Transport: a unix socket from ``serve --socket`` (or
any connected read/write file pair).

This is the port's own copy of the TPU package's ``serve/client.py``, with
three faults of that file repaired:

* a caller's future that is already done (cancelled, say) no longer makes
  its resolution raise in the reader thread, which ended the connection
  for every other caller: each resolution is guarded (``_resolve``);
* a batch response with fewer results than the batch had users no longer
  leaves the unpaired callers waiting forever: each gets an error;
* ``close()`` no longer fails healthy callers whose batch is being
  resubmitted user by user: it lets that resubmission finish.
"""

from __future__ import annotations

import itertools
import json
import socket as _socket
import threading
import time
from concurrent.futures import Future, InvalidStateError

# How long close() waits for the requests in flight.
CLOSE_TIMEOUT_S = 60.0


def _resolve(fut, result=None, exc: BaseException | None = None) -> None:
    """Resolve ``fut`` unless it is done already (a caller may have
    cancelled it): a resolution never raises into the reader thread."""
    if fut.done():
        return
    try:
        if exc is None:
            fut.set_result(result)
        else:
            fut.set_exception(exc)
    except InvalidStateError:
        pass  # done between the check and the call


class _StripId:
    """Future adapter for resubmitted single-user requests: resolves the
    wrapped future with the response minus the wire ``id``, preserving
    recommend()'s bare per-row shape contract."""

    def __init__(self, fut: Future):
        self._fut = fut

    def set_result(self, resp):
        if isinstance(resp, dict):
            resp = {k: v for k, v in resp.items() if k != "id"}
        _resolve(self._fut, resp)

    def set_exception(self, e):
        _resolve(self._fut, exc=e)

    def done(self):
        return self._fut.done()


class ServeClient:
    """Pipelined JSONL client over one daemon connection.

    ``recommend`` buffers single-user requests and flushes them as one
    batch ``users`` request when ``batch_size`` accumulate, when
    ``flush_after_ms`` elapses since the first buffered user, or on an
    explicit ``flush()``; responses are fanned back out to the per-caller
    futures.  All other ops submit immediately.  Up to ``max_in_flight``
    wire requests ride the connection concurrently (the daemon's
    per-connection writer returns responses in order; ids are matched, not
    assumed).
    """

    def __init__(self, socket_path: str | None = None, *,
                 infile=None, outfile=None,
                 batch_size: int = 256, flush_after_ms: float = 2.0,
                 max_in_flight: int = 64):
        if socket_path is not None:
            self._sock = _socket.socket(_socket.AF_UNIX,
                                        _socket.SOCK_STREAM)
            self._sock.connect(socket_path)
            self._rf = self._sock.makefile("r", encoding="utf-8")
            self._wf = self._sock.makefile("w", encoding="utf-8")
        else:
            if infile is None or outfile is None:
                raise ValueError("need socket_path or infile+outfile")
            self._sock = None
            self._rf, self._wf = infile, outfile
        self.batch_size = int(batch_size)
        self.flush_after_ms = float(flush_after_ms)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()          # buffer + table state
        self._wlock = threading.Lock()         # serializes wire writes
        self._in_flight: dict[int, Future] = {}
        # rid -> (k, [(user, fut), ...]) for batch 'users' requests
        self._batch_fanout: dict[int, tuple] = {}
        self._buf: list[tuple[int, Future]] = []   # (user, fut)
        self._buf_k: int | None = None
        self._sem = threading.BoundedSemaphore(max_in_flight)
        # _closing: close() has begun, new calls are refused; _dead: the
        # connection is gone, nothing more can be sent.
        self._closing = False
        self._dead = False
        self._resubmits: set[threading.Thread] = set()
        self._flush_timer: threading.Timer | None = None
        self._reader = threading.Thread(target=self._read_loop,
                                        daemon=True,
                                        name="cu2rec-client-reader")
        self._reader.start()

    # -- public ops --------------------------------------------------------

    def recommend(self, user: int, k: int = 10) -> Future:
        """Top-k for a known user; auto-batched with concurrent calls.

        The future resolves to ``{"items": [...], "scores": [...]}`` (or
        ``{"error": ...}``).
        """
        fut: Future = Future()
        stale = full = None
        with self._lock:
            self._check_open_locked()
            if self._buf and self._buf_k != k:
                stale = self._take_buf_locked()  # k is a batch key
            self._buf_k = k
            self._buf.append((int(user), fut))
            if len(self._buf) >= self.batch_size:
                full = self._take_buf_locked()
            elif self._flush_timer is None:
                t = threading.Timer(self.flush_after_ms / 1e3, self.flush)
                t.daemon = True
                self._flush_timer = t
                t.start()
        # Sends happen OUTSIDE the state lock: _send can block on the
        # in-flight semaphore, which only the reader thread (which needs
        # the state lock) releases.
        if stale:
            self._send_batch(stale)
        if full:
            self._send_batch(full)
        return fut

    def recommend_many(self, users, k: int = 10) -> Future:
        """One explicit batch request; resolves to the raw batch
        response ``{"results": [...]}`` in input order."""
        return self._submit({"op": "recommend",
                             "users": [int(u) for u in users], "k": k})

    def fold_in(self, items, ratings, k: int = 10, *,
                iterations: int | None = None, mode: str | None = None,
                alpha: float | None = None,
                reg: float | None = None) -> Future:
        req = {"op": "fold_in", "items": [int(i) for i in items],
               "ratings": [float(r) for r in ratings], "k": k}
        if iterations is not None:
            req["iterations"] = int(iterations)
        if mode is not None:
            req["mode"] = mode
        if alpha is not None:
            req["alpha"] = float(alpha)
        if reg is not None:
            req["reg"] = float(reg)
        return self._submit(req)

    def stats(self) -> Future:
        return self._submit({"op": "stats"})

    def flush(self) -> None:
        """Send any buffered single-user recommends now."""
        with self._lock:
            batch = self._take_buf_locked()
        if batch:
            self._send_batch(batch)

    def close(self) -> None:
        """Refuse new calls, send what is buffered and wait until every
        request in flight is answered, a resubmission under way included,
        then close the connection."""
        with self._lock:
            self._closing = True
        self.flush()
        deadline = time.monotonic() + CLOSE_TIMEOUT_S
        while time.monotonic() < deadline:
            with self._lock:
                busy = (self._in_flight or self._batch_fanout
                        or self._resubmits)
            if not busy:
                break
            time.sleep(0.002)
        if self._sock is not None:
            try:
                self._sock.shutdown(_socket.SHUT_WR)
            except OSError:
                pass
            self._reader.join(timeout=10.0)
            self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- internals ---------------------------------------------------------

    def _check_open_locked(self) -> None:
        if self._closing or self._dead:
            raise RuntimeError("client closed")

    def _take_buf_locked(self):
        """Detach the recommend buffer (state lock held); returns
        ``(k, [(user, fut), ...])`` or None."""
        if self._flush_timer is not None:
            self._flush_timer.cancel()
            self._flush_timer = None
        if not self._buf:
            return None
        buf, self._buf = self._buf, []
        k, self._buf_k = self._buf_k, None
        return (k, buf)

    def _send_batch(self, batch) -> None:
        # Always the batch op, even for one user: every recommend()
        # future then resolves to the SAME bare per-row shape
        # ({"items": ..., "scores": ...}) regardless of how the flush
        # happened to group it.
        k, buf = batch
        fut: Future = Future()
        self._send({"op": "recommend", "users": [u for u, _ in buf],
                    "k": k}, fut, fans=(k, list(buf)))

    def _submit(self, req: dict) -> Future:
        fut: Future = Future()
        with self._lock:
            self._check_open_locked()
        self._send(req, fut)
        return fut

    def _send(self, req: dict, fut, fans=None) -> int:
        """Write one request.  Blocks when max_in_flight wire requests
        are outstanding — backpressure, not unbounded queueing.  Must
        NOT be called with the state lock held (the semaphore is
        released by the reader thread, which takes that lock)."""
        rid = next(self._ids)
        req = dict(req, id=rid)
        self._sem.acquire()
        with self._lock:
            self._in_flight[rid] = fut
            if fans is not None:
                self._batch_fanout[rid] = fans
        try:
            with self._wlock:
                self._wf.write(json.dumps(req) + "\n")
                self._wf.flush()
        except Exception as e:
            with self._lock:
                self._in_flight.pop(rid, None)
                self._batch_fanout.pop(rid, None)
            self._sem.release()
            _resolve(fut, exc=e)
            if fans:
                for _u, f in fans[1]:
                    _resolve(f, exc=e)
        return rid

    def _read_loop(self) -> None:
        try:
            for line in self._rf:
                line = line.strip()
                if not line:
                    continue
                self._dispatch(json.loads(line))
        except Exception:
            pass
        # EOF / error: fail anything still outstanding.  Release one
        # semaphore permit per popped wire request — otherwise senders
        # (and close()'s flush) block forever in _sem.acquire() once the
        # connection dies with max_in_flight requests outstanding.
        with self._lock:
            leftovers = list(self._in_flight.values())
            self._in_flight.clear()
            fans = [f for _k, fs in self._batch_fanout.values()
                    for _u, f in fs]
            self._batch_fanout.clear()
            self._dead = True   # no more sends on a dead connection
        for _ in leftovers:
            try:
                self._sem.release()
            except ValueError:    # BoundedSemaphore over-release guard
                pass
        for f in leftovers + fans:
            _resolve(f, exc=ConnectionError("daemon connection closed"))

    def _dispatch(self, resp: dict) -> None:
        rid = resp.get("id")
        resubmit = None
        with self._lock:
            fut = self._in_flight.pop(rid, None)
            fans = self._batch_fanout.pop(rid, None)
            if fans is not None and resp.get("results") is None:
                # Whole-batch rejection (the daemon validates batch
                # 'users' requests wholesale): one bad id must not
                # poison co-batched callers — resubmit every member as
                # its own single-user request so each gets its own
                # verdict.  Resubmission happens OFF the reader thread:
                # _send can block on the in-flight semaphore, which only
                # this thread releases.  It is registered in the same
                # critical section as the pop, so that close() never
                # finds nothing in flight in between.
                resubmit = threading.Thread(
                    target=self._resubmit_singles, args=fans, daemon=True,
                    name="cu2rec-client-resubmit")
                self._resubmits.add(resubmit)
        if fut is None:
            return  # unknown id (daemon-side parse error rows carry None)
        self._sem.release()
        if resubmit is not None:
            _resolve(fut, resp)
            resubmit.start()
            return
        if fans is not None:
            _k, members = fans
            results = resp["results"]
            for (_u, f), r in zip(members, results):
                _resolve(f, r)
            for _u, f in members[len(results):]:
                _resolve(f, exc=RuntimeError(
                    f"the daemon answered {len(results)} of the batch's "
                    f"{len(members)} users"))
        _resolve(fut, resp)

    def _resubmit_singles(self, k: int, members) -> None:
        try:
            for user, f in members:
                try:
                    with self._lock:
                        dead = self._dead
                    if dead:
                        raise ConnectionError("daemon connection closed")
                    self._send({"op": "recommend", "user": int(user),
                                "k": k}, _StripId(f))
                except Exception as e:
                    _resolve(f, exc=e)
        finally:
            with self._lock:
                self._resubmits.discard(threading.current_thread())
