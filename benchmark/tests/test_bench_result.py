"""The result line: its keys, the device's, each metric's value and unit,
and the compared numbers last, each with its limit."""

import importlib.util
import json

import pytest

from bench_util import run_cell

from benchmark.lib import harness

CELLS = ("ml20m-f50.sgd", "ml20m-f50.als")


def _run_module():
    spec = importlib.util.spec_from_file_location(
        "_bench_run", harness.HERE / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line_schema(cell, trace):
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    record = run_cell(cell, trace=trace)
    device = {"platform": "gpu", "kind": "a card", "count": 1}
    out, lines = _run_module().report(bench, cell, record, device)
    line = json.loads(json.dumps(out))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in harness.cell_metrics(bench, cell, trace)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], (int, float))
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert lines[-len(line["checks"]):] == [
        l for l in lines if l.startswith("check ")]


def test_every_cell_reports_setup_an_end_to_end_and_a_layer_metric():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(bench, w["name"],
                                                       False)}
        layer = harness.cell_metrics(bench, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layer
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_every_name_has_its_file():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
    for w in bench["workloads"]:
        wl = harness.load_json(harness.HERE / "workloads"
                               / f"{w['name']}.json")
        assert wl["config"] == w["config"]
        assert (harness.HERE / "drivers" / f"{wl['driver']}.py").is_file()
    for c in bench["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
