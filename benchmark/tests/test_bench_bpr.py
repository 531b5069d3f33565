"""The BPR cell (``ml20m-f50.bpr``) on the CPU: its count against a hand
count, its four per-layer readers on a recorded traced run of the chip
(``data/record_ml20m-f50.bpr.json``, NVIDIA H100 80GB HBM3) and on a
record of a program without the BPR spans, the driver's comparison
(correct for the sound run; not correct for the control and for each
fault planted in the reference put in the program's place), and that the
reference loads nothing of the port or of JAX."""

import json
import subprocess
import sys

import pytest

from bench_util import ROOT, tiny

from benchmark.lib import harness

CELL = "ml20m-f50.bpr"
DATA = ROOT / "benchmark" / "tests" / "data"
READERS = ("bpr.host_ms_per_step", "bpr.draw_ms_per_step", "bpr.mfu_pct",
           "device_idle_pct.bpr")
# The CPU's sound run: the plain step in float32 against the float64
# reference, a few roundings of float32 in each compared number (readings
# of the order of 1e-8, the widest entry's 1e-6).
CPU_BOUND = {"start_gap": 0.0, "update1_gap": 1e-6, "change3_gap": 1e-6,
             "change3_max_gap": 1e-5, "eval_gap": 1e-6}


def _read(name, record):
    return harness.load_module("metrics", name).read(record)


def _record():
    with open(DATA / f"record_{CELL}.json") as f:
        return json.load(f)


def test_bpr_step_count_by_hand():
    bpr = harness.load_module("counts", "bpr")
    # 3 users (2 with interactions), 2 items (1 with raters), rows of 64
    # float32: both tables read and written, both indptr arrays, an id a
    # user with interactions, a rater an item with raters, and a user's
    # bounds and an id for each item's uniform user.
    assert bpr.step_bytes(3, 2, 64, 2, 1) == (
        2 * (3 + 2) * 64 * 4 + 4 * 4 + 4 * 3 + 4 * 2 + 4 * 1 + 12 * 2)
    assert bpr.step_bytes(3, 2, 64, 2, 1, elem=2) == (
        2 * (3 + 2) * 64 * 2 + 16 + 12 + 8 + 4 + 24)
    assert bpr.step_ops(50, 2, 2) == 2 * 6 * 50 + 2 * 12 * 50
    # The cell's step: about 86 MB, 0.026 ms at 3.35 TB/s.
    n = bpr.step_bytes(138493, 26744, 64, 138479, 26744)
    assert 85e6 < n < 87e6


def test_bpr_eval_counts_by_hand():
    bpr = harness.load_module("counts", "bpr")
    # 10 pairs over 4 users and 6 items: three ids a pair, the rows once.
    assert bpr.auc_bytes(10, 4, 6, 64) == 10 * 12 + 10 * 64 * 4
    assert bpr.auc_ops(10, 8) == 10 * (2 * 17 + 1)
    # 2 users ranked over 5 items with 7 train and 3 test interactions,
    # k = 2: the catalog's and the users' rows once, the lists, the ids.
    assert bpr.scan_bytes(2, 5, 64, 7, 3, 2) == (7 * 64 * 4 + 4 * 10
                                                 + 4 * 2 * 2)
    assert bpr.scan_ops(2, 5, 8) == 2 * 5 * 17


def test_readers_on_a_recorded_trace():
    record = _record()
    got = {name: _read(name, record) for name in READERS}
    assert all(v is not None for v in got.values()), got
    assert 0.0 < got["bpr.draw_ms_per_step"] < got["bpr.host_ms_per_step"]
    assert 0.0 < got["bpr.mfu_pct"] < 100.0
    assert 0.0 <= got["device_idle_pct.bpr"] <= 100.0
    c = record["counters"]
    assert record["program_counters"]["bpr.steps"] == c["steps"] \
        == c["iterations"]


def test_readers_without_the_program_spans():
    """A program without the BPR spans (the checkout before them) records
    neither ``bpr.draws`` nor ``bpr.steps``: that reader reads None, and
    the others read what the benchmark itself records."""
    record = dict(_record(), program_spans={}, program_counters={})
    assert _read("bpr.draw_ms_per_step", record) is None
    del record["program_spans"], record["program_counters"]
    assert _read("bpr.draw_ms_per_step", record) is None
    assert _read("bpr.host_ms_per_step", record) > 0.0
    assert _read("device_idle_pct.bpr", dict(record, trace=None)) is None


def _context(seed=12345, trace=False):
    import time

    workload, config = tiny(CELL)
    workload["params"].update(check_error=10, total_iterations=40)
    return harness.Context(time.perf_counter(), CELL, workload, config,
                           seed, 0.3, trace, device="cpu")


def _driver():
    return harness.load_module("drivers", "bpr_jobs")


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_agrees_with_the_reference(trace):
    ctx = _context(trace=trace)
    record = _driver().run(ctx)
    values = {c["name"]: c["value"] for c in record["checks"]}
    assert set(values) == set(CPU_BOUND)
    for k, v in values.items():
        assert v <= CPU_BOUND[k], (k, v)
    assert all(c["ok"] for c in record["checks"]), record["checks"]
    assert ctx.counters["steps"] == ctx.counters["iterations"] > 0
    if trace:
        assert record["program_counters"]["bpr.steps"] \
            == ctx.counters["steps"]
        assert {"bpr.run_steps", "bpr.draws", "bpr.eval"} \
            <= set(record["program_spans"])


@pytest.mark.parametrize("mode", ["control", *_driver().FAULTS])
def test_control_and_faults_are_not_correct(mode):
    """The program's bf16 tables; the reference with its tables left
    unchanged, half of the users left out of the user pass, one row's
    change doubled, the AUC over half of its pairs, or the item-negative
    pass left out, in the program's place."""
    ctx = _context()
    values = _driver().readings(ctx, mode)
    limits = ctx.workload["limits"]
    assert any(v > limits[k] for k, v in values.items()), values


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.mf_bpr as r, torch; "
            "assert not torch.backends.cuda.matmul.allow_tf32; "
            "assert not torch.backends.cudnn.allow_tf32; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('cu2rec_torch', 'cu2rec_tpu', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)") % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
