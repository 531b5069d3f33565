"""The port's ``ServeClient`` against the port's daemon on the CPU, as
``tests/test_daemon.py`` holds the TPU package's: auto-batching, the
isolation of a bad user in a batch, many caller threads and a dead
connection.  Then one test for each fault of the TPU package's client that
the port repairs: a cancelled caller future, a batch answered short, and
``close()`` during a resubmission.  The last two talk to a scripted server
on a unix socket."""

import json
import os
import pathlib
import socket
import threading
import time

import numpy as np
import pytest

from cu2rec_torch.data import build_csr, read_ratings_csv
from cu2rec_torch.models.state import init_model
from cu2rec_torch.serve.client import ServeClient
from cu2rec_torch.serve.daemon import ServingDaemon, run_socket
from cu2rec_torch.serve.engine import ServingEngine
from cu2rec_torch.utils.config import Config

DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    rd = read_ratings_csv(str(DATA / "test_ratings.csv"))
    csr = build_csr(rd)
    model = init_model(csr.n_users, csr.n_items, 4, rd.global_bias, seed=5,
                       device="cpu")
    engine = ServingEngine(model, device="cpu")
    cfg = Config(n_factors=4, total_iterations=30, learning_rate=0.05,
                 is_train=False)
    daemon = ServingDaemon(engine, train_csr=csr, cfg=cfg, window_ms=0.0)
    path = str(tmp_path_factory.mktemp("client") / "serve.sock")
    threading.Thread(target=run_socket, args=(daemon, path),
                     daemon=True).start()
    deadline = time.monotonic() + 10
    while not os.path.exists(path):
        assert time.monotonic() < deadline, "socket never appeared"
        time.sleep(0.01)
    return daemon, engine, csr, path


def test_client_auto_batches(served):
    daemon, engine, csr, path = served
    n_users = csr.n_users
    n_req0 = daemon.n_requests
    with ServeClient(path, batch_size=8, flush_after_ms=50.0) as c:
        futs = [c.recommend(u % n_users, k=2) for u in range(16)]
        results = [f.result(timeout=30) for f in futs]
        direct = daemon.submit({"id": 0, "op": "recommend", "user": 0,
                                "k": 2}).result(timeout=30)
        assert results[0]["items"] == direct["items"]
        for r in results:
            assert "error" not in r and len(r["items"]) >= 1
        # 16 users crossed the wire as 2 batch requests, not 16.
        assert daemon.n_requests - n_req0 == 2 + 1  # +1 direct submit
        # Each row is the engine's own top-k for that user.
        _, idx = engine.recommend_known(np.arange(n_users), csr, k=2)
        for u in range(16):
            assert results[u]["items"] == [
                int(i) for i in idx[u % n_users]][:len(results[u]["items"])]

        batch = c.recommend_many([0, 1, 2], k=2).result(timeout=30)
        assert len(batch["results"]) == 3
        assert batch["results"][0]["items"] == direct["items"]
        fi = c.fold_in([0, 1], [4.0, 3.0], k=2,
                       iterations=5).result(timeout=30)
        assert "error" not in fi and len(fi["items"]) >= 1
        assert not set(fi["items"]) & {0, 1}
        st = c.stats().result(timeout=30)
        assert st["n_items"] == engine.n_items
        lone = c.recommend(1, k=2).result(timeout=30)
        assert "error" not in lone


def test_client_isolates_bad_user_in_batch(served):
    _, _, csr, path = served
    with ServeClient(path, batch_size=2, flush_after_ms=200.0) as c:
        good = c.recommend(0, k=2)
        bad = c.recommend(csr.n_users + 99, k=2)  # out of range
        r_good = good.result(timeout=30)
        r_bad = bad.result(timeout=30)
    assert "error" not in r_good and len(r_good["items"]) >= 1
    assert "id" not in r_good  # bare per-row shape, even resubmitted
    assert "error" in r_bad


def test_client_thread_stress(served):
    daemon, _, csr, path = served
    n_threads, per = 8, 25
    errs: list = []
    n_req0 = daemon.n_requests
    with ServeClient(path, batch_size=16, flush_after_ms=2.0,
                     max_in_flight=8) as c:
        def worker(t):
            try:
                futs = [c.recommend((t * per + j) % csr.n_users, k=2)
                        for j in range(per)]
                if t % 2 == 0:
                    futs.append(c.fold_in([0, 1], [4.0, 3.0], k=2,
                                          iterations=3))
                for f in futs:
                    r = f.result(timeout=60)
                    if "error" in r or "items" not in r:
                        errs.append(r)
            except Exception as e:  # noqa: BLE001 — collect, assert below
                errs.append(repr(e))

        ts = [threading.Thread(target=worker, args=(t,))
              for t in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
            assert not t.is_alive(), "worker deadlocked"
    assert not errs, errs[:3]
    assert daemon.n_requests - n_req0 < n_threads * per


def _scripted_server(path: str, answer):
    """A one-connection server: ``answer(req)`` gives (delay s, response
    or None) for each request line."""
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(1)

    def serve():
        conn, _ = srv.accept()
        rf = conn.makefile("r", encoding="utf-8")
        wf = conn.makefile("w", encoding="utf-8")
        lock = threading.Lock()

        def reply(delay, resp):
            time.sleep(delay)
            with lock:
                wf.write(json.dumps(resp) + "\n")
                wf.flush()

        for line in rf:
            delay, resp = answer(json.loads(line))
            if resp is not None:
                threading.Thread(target=reply, args=(delay, resp),
                                 daemon=True).start()
        time.sleep(0.5)
        conn.close()
        srv.close()

    threading.Thread(target=serve, daemon=True).start()


def test_client_survives_dead_connection(tmp_path):
    path = str(tmp_path / "dead.sock")
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(1)

    def accept_then_hang():
        conn, _ = srv.accept()
        time.sleep(0.3)
        conn.close()          # the daemon "crashes" with requests in flight

    threading.Thread(target=accept_then_hang, daemon=True).start()
    c = ServeClient(path, batch_size=4, flush_after_ms=1.0,
                    max_in_flight=2)
    futs = [c.recommend(u, k=2) for u in range(4)]
    c.flush()
    for f in futs:
        with pytest.raises(ConnectionError):
            f.result(timeout=30)
    t0 = time.monotonic()
    c.close()                 # must not hang on leaked permits
    assert time.monotonic() - t0 < 10
    with pytest.raises(RuntimeError, match="client closed"):
        c.recommend(0)
    srv.close()


def test_cancelled_future_does_not_end_the_connection(served):
    """A caller may cancel its future before the answer comes; resolving
    it must not raise in the reader thread, which would fail every other
    caller and the connection."""
    _, _, _, path = served
    with ServeClient(path, batch_size=3, flush_after_ms=10_000.0) as c:
        futs = [c.recommend(u, k=2) for u in range(2)]
        assert futs[0].cancel()
        futs.append(c.recommend(2, k=2))          # fills the batch: sent
        assert "items" in futs[1].result(timeout=30)
        assert "items" in futs[2].result(timeout=30)
        single = c.fold_in([0], [4.0], k=2)
        assert single.cancel()
        # The connection still serves.
        assert "items" in c.recommend_many([0], k=2).result(
            timeout=30)["results"][0]
        assert c.stats().result(timeout=30)["n_items"] > 0


def test_short_batch_answer_fails_the_unpaired_callers(tmp_path):
    path = str(tmp_path / "short.sock")

    def answer(req):
        if "users" in req:   # one result for a batch of three
            return 0.0, {"id": req["id"], "results": [
                {"items": [req["users"][0]], "scores": [1.0]}]}
        return 0.0, {"id": req["id"], "n_items": 1}

    _scripted_server(path, answer)
    with ServeClient(path, batch_size=3, flush_after_ms=10_000.0) as c:
        futs = [c.recommend(u, k=1) for u in (5, 6, 7)]
        assert futs[0].result(timeout=10) == {"items": [5], "scores": [1.0]}
        for f in futs[1:]:
            with pytest.raises(RuntimeError, match="answered 1 of the "
                               "batch's 3 users"):
                f.result(timeout=10)
        assert c.stats().result(timeout=10)["n_items"] == 1


def test_close_lets_a_resubmission_finish(tmp_path):
    """The batch is rejected whole while close() is already waiting; its
    users are resubmitted one by one and must get their answers, not a
    ConnectionError."""
    path = str(tmp_path / "resub.sock")

    def answer(req):
        if "users" in req:
            return 0.3, {"id": req["id"], "error": "unknown user"}
        return 0.2, {"id": req["id"], "items": [req["user"]],
                     "scores": [0.5]}

    _scripted_server(path, answer)
    c = ServeClient(path, batch_size=3, flush_after_ms=10_000.0)
    futs = [c.recommend(u, k=1) for u in (1, 2, 3)]
    c.close()
    for u, f in zip((1, 2, 3), futs):
        assert f.result(timeout=10) == {"items": [u], "scores": [0.5]}
