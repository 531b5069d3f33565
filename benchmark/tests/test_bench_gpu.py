"""On the card: each cell's run, short, prints a correct result line.  The
control of each training cell (the program's bf16 tables for SGD, the
TF32 reference for ALS) comes out as not correct at the cell's own size.
Skips where there is no CUDA card."""

import json
import subprocess
import sys

import pytest

from bench_util import ROOT

from benchmark.lib import harness

BENCH = harness.load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if not c.endswith(".serve")])
def test_control_is_not_correct_on_the_card(card, cell):
    import time

    workload = harness.load_json(harness.HERE / "workloads"
                                 / f"{cell}.json")
    config = harness.load_json(harness.HERE / "configs"
                               / f"{workload['config']}.json")
    driver = harness.load_module("drivers", workload["driver"])
    ctx = harness.Context(time.perf_counter(), cell, workload, config,
                          2147483998, 3.0, False)
    values = driver.readings(ctx, "control")
    assert any(v > workload["limits"][k] for k, v in values.items()), values
