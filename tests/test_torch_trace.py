"""The port's recorder of host spans and counters (``utils/timing.py``):
off by default and then a shared object that does nothing; on, nested
spans on the ``perf_counter`` clock with their parents, per thread; and the
spans the trainers record at their layer boundaries, on the CPU, with
tables bitwise equal whether recording is on or off."""

import threading
import time

import numpy as np
import pytest
import torch

from cu2rec_torch.data.csr import csr_from_arrays
from cu2rec_torch.train.als import sweep_chunks, train_als
from cu2rec_torch.train.trainer import train
from cu2rec_torch.utils import timing
from cu2rec_torch.utils.config import Config
from cu2rec_torch.utils.metrics import MetricsLogger


@pytest.fixture
def recorder():
    """Recording off before and after the test, whatever it leaves."""
    timing.trace_stop()
    yield timing
    timing.trace_stop()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s[0], []).append(s)
    return out


def _parents(spans):
    """{span name: the set of its parents' names (None: no parent)}."""
    names = {s[1]: s[0] for s in spans}
    out = {}
    for name, _id, parent, _a, _b in spans:
        out.setdefault(name, set()).add(names.get(parent))
    return out


def test_off_records_nothing_and_returns_one_object(recorder):
    assert recorder.span("a") is recorder.span("b")
    with recorder.span("a"):
        recorder.count("c", 3)
    recorder.trace_start()
    assert recorder.trace_stop() == {"spans": [], "counters": {}}
    assert recorder.trace_stop() == {"spans": [], "counters": {}}


def test_on_nests_counts_and_stop_drains(recorder):
    recorder.trace_start()
    t_before = time.perf_counter()
    with recorder.span("outer"):
        recorder.count("n")
        with recorder.span("inner"):
            recorder.count("n", 4)
        with recorder.span("inner"):
            pass
    t_after = time.perf_counter()
    got = recorder.trace_stop()
    assert got["counters"] == {"n": 5}
    spans = _by_name(got["spans"])
    (outer,) = spans["outer"]
    assert outer[2] is None
    assert len(spans["inner"]) == 2
    for _name, _id, parent, a, b in spans["inner"]:
        assert parent == outer[1]
        assert outer[3] <= a <= b <= outer[4]
    assert t_before <= outer[3] <= outer[4] <= t_after
    assert len({s[1] for s in got["spans"]}) == 3
    # Stopped: off again, and nothing kept for the next start.
    assert recorder.span("x") is recorder.span("y")
    recorder.trace_start()
    assert recorder.trace_stop()["spans"] == []


def test_threads_do_not_parent_each_other(recorder):
    recorder.trace_start()
    both_open = threading.Barrier(2, timeout=10)

    def work(tag):
        with recorder.span(f"root.{tag}"):
            both_open.wait()
            with recorder.span(f"child.{tag}"):
                both_open.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    parents = _parents(recorder.trace_stop()["spans"])
    assert parents == {"root.a": {None}, "root.b": {None},
                       "child.a": {"root.a"}, "child.b": {"root.b"}}


def _ratings(U=90, I=40, n=1500, seed=3):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, U, n)
    i = np.minimum((I * rng.power(0.5, n)).astype(np.int64), I - 1)
    keys = np.unique(u * I + i)
    u, i = (keys // I).astype(np.int32), (keys % I).astype(np.int32)
    r = (rng.integers(1, 11, len(u)) / 2.0).astype(np.float32)
    test = rng.random(len(u)) < 0.15
    train_csr = csr_from_arrays(u[~test], i[~test], r[~test], U, I,
                                use_native=False)
    test_csr = csr_from_arrays(u[test], i[test], r[test], U, I,
                               use_native=False)
    return train_csr, test_csr, float(r[~test].mean())


def _quiet():
    return MetricsLogger(verbose=False)


def _tables(model):
    return [t.clone() for t in (model.P, model.Q, model.user_bias,
                                model.item_bias)]


def test_sgd_job_records_its_layers(recorder):
    tr, te, mu = _ratings()
    cfg = dict(total_iterations=23, check_error=10, n_factors=8,
               learning_rate=0.05, train_eval_sample=400)
    off, _ = train(tr, te, Config(**cfg), mu, logger=_quiet(), device="cpu")
    recorder.trace_start()
    on, _ = train(tr, te, Config(**cfg), mu, logger=_quiet(), device="cpu")
    got = recorder.trace_stop()
    for a, b in zip(_tables(off), _tables(on)):
        assert torch.equal(a, b)

    parents = _parents(got["spans"])
    assert parents == {
        "engine.build": {None},
        "model.init": {None},
        "model.init.draw": {"model.init"},
        "model.init.upload": {"model.init"},
        "model.init.pack": {"model.init"},
        "trainer.job": {None},
        "trainer.warmup": {"trainer.job"},
        "sgd.run_steps": {"trainer.warmup", "trainer.job"},
        "eval": {"trainer.warmup", "trainer.job"},
        "eval.wait": {"eval"},
        "trainer.finalize": {"trainer.job"},
    }
    evals = 4                       # iterations 1, 10, 20, 23
    spans = _by_name(got["spans"])
    assert len(spans["sgd.run_steps"]) == 2 + evals
    assert got["counters"] == {"sgd.steps": 23 + 2,       # + the warm-up's
                               "eval.calls": 2 * evals + 2}
    (job,) = spans["trainer.job"]
    for s in got["spans"]:
        assert s[3] <= s[4]
        if s[2] == job[1]:
            assert job[3] <= s[3] <= s[4] <= job[4]


def test_als_run_records_its_layers(recorder):
    tr, te, mu = _ratings()
    cfg = dict(total_iterations=3, n_factors=8, algo="als")
    off, _ = train_als(tr, te, Config(**cfg), mu, logger=_quiet(),
                       device="cpu")
    recorder.trace_start()
    on, _ = train_als(tr, te, Config(**cfg), mu, logger=_quiet(),
                      device="cpu")
    got = recorder.trace_stop()
    for a, b in zip(_tables(off), _tables(on)):
        assert torch.equal(a, b)

    assert _parents(got["spans"]) == {
        "als.prepare_chunks": {None},
        "model.init.draw": {None},
        "model.init.upload": {None},
        "als.sweep": {None},
        "als.half_sweep": {"als.sweep"},
        "als.chunk": {"als.half_sweep"},
        "eval": {None},
        "eval.wait": {"eval"},
    }
    user_chunks, item_chunks = sweep_chunks(tr, 8, "cpu")
    per_sweep = len(user_chunks) + len(item_chunks)
    assert per_sweep > 2
    spans = _by_name(got["spans"])
    assert len(spans["als.sweep"]) == 3
    assert len(spans["als.half_sweep"]) == 6
    assert len(spans["als.chunk"]) == 3 * per_sweep
    slots = user_chunks.slots + item_chunks.slots
    assert got["counters"] == {"als.sweeps": 3, "als.chunks": 3 * per_sweep,
                               "als.gram_slots": 3 * slots,
                               "als.gram_live_slots": 3 * 2 * tr.nnz,
                               "eval.calls": 6}


def test_draw_tables_open_once_and_draws_count_by_dispatch(recorder,
                                                          monkeypatch):
    """``model.init.draw.tables`` opens once, inside the process's first
    draw through the tables (their upload and check; the CPU standing in
    for the card); ``model.init.card_draws`` and ``.cpu_draws`` count each
    ``init_model`` for the card by the way it drew, and a model for the
    CPU counts in neither."""
    from cu2rec_torch.models.state import init_model
    from cu2rec_torch.ops import cuda_draw

    real = cuda_draw.draws_on_card
    monkeypatch.setattr(cuda_draw, "draws_on_card", lambda device: True)
    monkeypatch.setattr(cuda_draw, "normal_draw_cuda",
                        cuda_draw.draw_reference)      # K5's plain version
    monkeypatch.setattr(cuda_draw, "_host_tables",
                        cuda_draw.extract_tables())
    monkeypatch.setattr(cuda_draw, "_device_tables", {})
    recorder.trace_start()
    init_model(200, 40, 8, 3.5, seed=1, device="cpu")   # tables, checked
    init_model(200, 40, 8, 3.5, seed=2, device="cpu")
    init_model(10, 40, 8, 3.5, seed=3, device="cpu")    # 10 biases: CPU
    monkeypatch.setattr(cuda_draw, "draws_on_card", real)
    init_model(200, 40, 8, 3.5, seed=4, device="cpu")   # the CPU's own
    got = recorder.trace_stop()
    assert got["counters"] == {"model.init.card_draws": 2,
                               "model.init.cpu_draws": 1}
    spans = _by_name(got["spans"])
    assert len(spans["model.init.draw"]) == 4
    (tables,) = spans["model.init.draw.tables"]
    assert tables[2] == spans["model.init.draw"][0][1]
    assert _parents(got["spans"])["model.init.draw.tables"] == {
        "model.init.draw"}


def test_bpr_run_records_its_layers(recorder):
    """``train_bpr``: a span around each ``bpr_run_steps`` call with a
    ``bpr.draws`` child a step, ``eval.plan`` around each of the two eval
    plans built before the loop, and ``bpr.eval`` around each eval point's
    AUC and ranking eval; the counters count the iterations, the evals and
    the plans; the model, the losses and the draws are the same with the
    recorder on or off, and off it keeps nothing."""
    from cu2rec_torch.data.csr import to_device
    from cu2rec_torch.ops.bpr import bpr_draws
    from cu2rec_torch.ops.sgd import prng_key
    from cu2rec_torch.train.bpr import train_bpr

    tr, te, _mu = _ratings()
    cfg = dict(total_iterations=23, check_error=10, n_factors=8,
               learning_rate=0.1, seed=5, algo="bpr")
    off, off_losses = train_bpr(tr, te, Config(**cfg), logger=_quiet(),
                                device="cpu")
    ids_off = bpr_draws(to_device(tr, "cpu", item_major=True),
                        prng_key(5), 7)
    assert recorder.trace_stop() == {"spans": [], "counters": {}}
    recorder.trace_start()
    on, on_losses = train_bpr(tr, te, Config(**cfg), logger=_quiet(),
                              device="cpu")
    ids_on = bpr_draws(to_device(tr, "cpu", item_major=True), prng_key(5),
                       7)
    got = recorder.trace_stop()
    for a, b in zip(_tables(off), _tables(on)):
        assert torch.equal(a, b)
    assert off_losses == on_losses
    for a, b in zip(ids_off, ids_on):
        assert torch.equal(a, b)

    assert _parents(got["spans"]) == {
        "model.init.draw": {None},
        "model.init.upload": {None},
        "bpr.run_steps": {None},
        "bpr.draws": {"bpr.run_steps"},
        "bpr.eval": {None},
        "bpr.eval.auc": {"bpr.eval"},
        "bpr.eval.ranking": {"bpr.eval"},
        "eval.plan": {None},
    }
    evals = 4                       # iterations 1, 10, 20, 23
    spans = _by_name(got["spans"])
    assert len(spans["bpr.run_steps"]) == evals
    assert len(spans["bpr.draws"]) == 23     # one a step
    assert len(spans["bpr.eval"]) == len(spans["bpr.eval.auc"]) == evals
    assert len(spans["eval.plan"]) == 2      # the AUC's and the ranking's
    assert got["counters"] == {"bpr.steps": 23, "bpr.evals": evals,
                               "eval.plans": 2}
    by_id = {s[1]: s for s in got["spans"]}
    for _name, _id, parent, a, b in got["spans"]:
        assert a <= b
        if parent is not None:
            assert by_id[parent][3] <= a <= b <= by_id[parent][4]
