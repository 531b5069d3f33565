"""The cell ``ml20m-f50.sgd_short``: ``sgd_jobs`` with its workload file's
``params`` (100-iteration jobs) handed over as the jobs' settings.  Its
compared numbers (the first job's start, steps 1 and 3, its eval at
iteration 1) are those of ``ml20m-f50.sgd`` for the same seed, so it is
held to that cell's limits."""

from bench_util import context, run_cell

from benchmark.lib import harness


def _values(record):
    return {c["name"]: c["value"] for c in record["checks"]}


def test_short_jobs_compare_as_the_long_ones():
    short = run_cell("ml20m-f50.sgd_short", seed=2147483999)
    long = run_cell("ml20m-f50.sgd", seed=2147483999)
    assert _values(short) == _values(long)


def test_params_reach_the_jobs(monkeypatch):
    """Each job of the window runs the workload file's 100 iterations."""
    ctx = context("ml20m-f50.sgd_short")
    assert ctx.workload["params"] == {"total_iterations": 100}
    driver = harness.load_module("drivers", "sgd_jobs_params")
    seen = []
    real = driver.sgd_jobs.run

    def run(ctx, overrides=None):
        seen.append(overrides)
        return real(ctx, overrides)

    monkeypatch.setattr(driver.sgd_jobs, "run", run)
    driver.run(ctx)
    assert seen == [{"total_iterations": 100}]
    assert ctx.counters["iterations"] == 100 * ctx.counters["jobs"]


def test_limits_are_the_long_cells():
    a = harness.load_json(harness.HERE / "workloads"
                          / "ml20m-f50.sgd_short.json")
    b = harness.load_json(harness.HERE / "workloads" / "ml20m-f50.sgd.json")
    assert a["limits"] == b["limits"] and a["config"] == b["config"]
