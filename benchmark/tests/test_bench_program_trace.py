"""The program's spans in a traced run (``lib/program_trace.py``): the
innermost span that holds a point however deep the nesting, the record's
keys from a recording of the program on the CPU, nothing where the program
has no recorder, and a ``--trace 0`` run that leaves the recorder alone
and keeps its record's keys.  On the card: the program's spans and the
profile's device events on one clock."""

import random
import time

import pytest

from bench_util import run_cell

from benchmark.lib import harness, program_trace

# A run's record without a trace, as the drivers and ``run.py`` make it.
RECORD_KEYS = {"attempted", "failed", "memory_peak_bytes", "data", "checks",
               "cell", "setup_s", "window_s", "counters", "spans", "trace"}


def test_a_gap_between_many_children_takes_their_parent():
    children = [("child", 1.0 + k, 1.5 + k) for k in range(1000)]
    spans = [("parent", 0.5, 1001.0)] + children + [("late", 2000.0, 2001.0)]
    points = [500.75, 501.25, 0.1, 1500.0, 2000.5]
    assert program_trace.innermost(spans, points) == [
        "parent", "child", program_trace.HOST, program_trace.HOST, "late"]


def test_innermost_is_the_latest_to_start_that_holds_the_point():
    rng = random.Random(7)
    for _ in range(50):
        spans = []
        for k in range(rng.randint(0, 40)):
            a = rng.uniform(0, 100)
            spans.append((f"s{k}", a, a + rng.expovariate(0.1)))
        points = [rng.uniform(-5, 110) for _ in range(30)]
        want = []
        for t in points:
            holding = [s for s in spans if s[1] <= t <= s[2]]
            want.append(max(holding, key=lambda s: (s[1], -s[2]))[0]
                        if holding else program_trace.HOST)
        assert program_trace.innermost(spans, points) == want


def _tiny_job():
    import numpy as np

    from cu2rec_torch.data.csr import csr_from_arrays
    from cu2rec_torch.train.trainer import train
    from cu2rec_torch.utils.config import Config
    from cu2rec_torch.utils.metrics import MetricsLogger

    rng = np.random.default_rng(0)
    u = rng.integers(0, 50, 600).astype(np.int32)
    i = rng.integers(0, 20, 600).astype(np.int32)
    r = (rng.integers(1, 11, 600) / 2.0).astype(np.float32)
    csr = csr_from_arrays(u, i, r, 50, 20, use_native=False)
    cfg = Config(total_iterations=12, check_error=5, n_factors=8)
    train(csr, csr, cfg, float(r.mean()),
          logger=MetricsLogger(verbose=False), device="cpu")


def test_record_keys_from_a_recording_of_the_program():
    trace = program_trace.ProgramTrace.start()
    assert trace is not None
    try:
        _tiny_job()
        trace.open_window()
        t0 = time.perf_counter()
        _tiny_job()
        t_end = time.perf_counter()
        trace.close_window()
    finally:
        trace.timing.trace_stop()
    rec = trace.record(t0, t_end)
    assert set(rec) == {"program_spans", "program_counters",
                        "program_setup_s"}
    # One job: 12 steps, evals at 1, 5, 10 and 12; its warm-up's 2 steps
    # and 2 evals.
    assert rec["program_counters"] == {"sgd.steps": 14, "eval.calls": 10}
    assert rec["program_spans"]["trainer.job"][1] == 1
    assert rec["program_spans"]["sgd.run_steps"][1] == 2 + 4
    for seconds, n in rec["program_spans"].values():
        assert 0 < seconds <= t_end - t0 and n > 0
    # The set-up job's parentless spans: build, init, the job.
    assert 0 < rec["program_setup_s"] < t0 - min(
        s[3] for s in trace.setup["spans"]) + 1e-9
    labels = program_trace.innermost(trace.host_spans(t0, t_end),
                                      [s[3] for s in trace.window["spans"]
                                       if s[0] == "eval.wait"])
    assert set(labels) == {"eval.wait"}


def test_nothing_without_the_programs_recorder(monkeypatch):
    from cu2rec_torch.utils import timing

    monkeypatch.delattr(timing, "trace_start")
    assert program_trace.recorder() is None
    assert program_trace.ProgramTrace.start() is None


@pytest.mark.parametrize("cell", ["ml20m-f50.sgd", "ml20m-f50.als"])
def test_an_untraced_run_keeps_its_record_and_leaves_the_recorder(cell):
    from cu2rec_torch.utils import timing

    record = run_cell(cell, trace=False)
    extra = {"half_sweep_ms"} if cell.endswith(".als") else set()
    assert set(record) == RECORD_KEYS | extra
    assert record["trace"] is None
    assert timing.span("a") is timing.span("b")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_program_spans_share_the_profiles_clock(card):
    """The host sleeps 50 ms inside a program span between two kernels: at
    least 90% of that idle gap falls under the span (a profile at times
    records no device event; it is taken again, at most three times)."""
    import torch

    x = torch.randn(1 << 22, device="cuda")
    torch.cuda.synchronize()
    for _ in range(3):
        trace = program_trace.ProgramTrace.start()
        trace.open_window()
        prof = harness.start_profile("cuda")
        t0 = time.perf_counter()
        with trace.timing.span("clock.gap"):
            y = x * 2.0
            torch.cuda.synchronize()
            time.sleep(0.05)
            y = y + 1.0
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        trace.close_window()
        rec = harness.stop_profile(prof, t0, t_end,
                                   trace.host_spans(t0, t_end))
        if rec["n_events"] >= 2:
            break
    assert rec["n_events"] >= 2
    assert rec["idle"].get("clock.gap", 0.0) >= 0.9 * 0.05, rec["idle"]
