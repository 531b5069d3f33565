"""Every metric reader on a recorded profile: the records of chip runs of
each cell with ``--trace 1`` (``run.py --record``, NVIDIA H100 80GB HBM3),
kept in ``data/``.  A share of a roofline or of a peak lies in (0, 100];
a reader that finds nothing to read returns None, never 0."""

import json

import pytest

from bench_util import ROOT

from benchmark.lib import harness

DATA = ROOT / "benchmark" / "tests" / "data"
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _record(cell):
    with open(DATA / f"record_{cell}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("cell", CELLS)
def test_per_layer_readers_on_a_recorded_trace(cell):
    record = _record(cell)
    assert record["trace"] is not None
    for m in harness.cell_metrics(BENCH, cell, True):
        value = harness.load_module("metrics", m["name"]).read(record)
        assert value is not None, m["name"]
        if m["unit"] == "%":
            assert 0.0 <= value <= 100.0, (m["name"], value)
            if "roofline" in m["name"] or "mfu" in m["name"]:
                assert value > 0.0, m["name"]
        else:
            assert value > 0.0, (m["name"], value)


@pytest.mark.parametrize("cell", CELLS)
def test_end_to_end_readers_on_a_record(cell):
    record = _record(cell)
    for m in harness.cell_metrics(BENCH, cell, False):
        value = harness.load_module("metrics", m["name"]).read(record)
        assert value is not None and value > 0.0, (m["name"], value)


@pytest.mark.parametrize("cell", CELLS)
def test_trace_readers_find_nothing_without_a_trace(cell):
    record = dict(_record(cell), trace=None)
    for m in harness.cell_metrics(BENCH, cell, True):
        if m["source"] != "device_trace":
            continue
        assert harness.load_module("metrics", m["name"]).read(record) \
            is None, m["name"]


def test_serving_readers_on_a_recorded_trace():
    """The serving cell's readers (its cell waits for a later benchmark
    PR, PERF.md §7) on a traced run of it at 800 requests/s."""
    record = _record("ml20m-f50.serve")
    read = {name: harness.load_module("metrics", name).read(record)
            for name in ("request_p95_ms", "serve.mean_batch",
                         "device_idle_pct.serve", "setup_s")}
    assert 0 < read["request_p95_ms"] < 1e3
    assert read["serve.mean_batch"] >= 1.0
    assert 0.0 <= read["device_idle_pct.serve"] <= 100.0
    assert read["setup_s"] > 0


def test_idle_gaps_fall_in_the_host_span_that_holds_them():
    spans = [("engine.run", 1.0, 2.0), ("engine.evaluate", 2.5, 3.0)]
    assert harness._host_label(sorted((a * 1e9, b * 1e9, l)
                                      for l, a, b in spans), 1.5e9) \
        == "engine.run"
    assert harness._host_label(sorted((a * 1e9, b * 1e9, l)
                                      for l, a, b in spans), 2.2e9) == "host"


def test_union_of_device_intervals():
    total, merged = harness._union([(0, 2), (1, 3), (5, 6)])
    assert total == 4 and merged == [[0, 3], [5, 6]]
