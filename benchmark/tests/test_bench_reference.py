"""The comparison that decides ``correct``, at a size the CPU holds: the
plain reference agrees with the port's sound run; the control (the
lower precision) and each fault planted under the timed path come out as
not correct.

On the CPU the port runs its plain versions, not the kernels, so the sound
run's numbers are held here to a CPU bound; the limits of the cells are
the chip's (PERF.md gives their readings).  Every fault and the control
must fail the cell's own limits.
"""

import dataclasses

import pytest
import torch

from bench_util import context, run_cell

from benchmark.lib import harness, training

# The CPU's sound runs: the plain step in float32 against the float64
# reference, a few roundings of float32 in each compared number.
CPU_BOUND = {"start_gap": 0.0, "update1_gap": 1e-6, "change3_gap": 1e-6,
             "change3_max_gap": 1e-4, "eval_gap": 1e-6}
CELLS = ("ml20m-f50.sgd", "ml20m-f50.als")
SERVE = "ml20m-f50.serve"


def _values(record):
    return {c["name"]: c["value"] for c in record["checks"]}


def _correct(record):
    return all(c["ok"] for c in record["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_agrees_with_the_reference(cell):
    values = _values(run_cell(cell))
    assert set(values) == set(CPU_BOUND)
    for k, v in values.items():
        assert v <= CPU_BOUND[k], (k, v)


def test_sgd_control_is_not_correct():
    """The program's own bf16 tables, the step below float32."""
    ctx = context("ml20m-f50.sgd")
    driver = harness.load_module("drivers", "sgd_jobs")
    assert not _correct(driver.run(ctx, driver.CONTROL))


def test_als_control_is_not_correct():
    """The reference with its Grams' inputs in TF32, in the program's
    place."""
    ctx = context("ml20m-f50.als")
    driver = harness.load_module("drivers", "als_sweeps")
    values = driver.readings(ctx, "control")
    limits = ctx.workload["limits"]
    assert any(values[k] > limits[k] for k in values), values


def test_serve_sound_run_agrees_with_the_reference():
    values = _values(run_cell(SERVE))
    assert values["missing"] == 0.0
    assert values["rank_gap"] <= 1e-6 and values["score_gap"] <= 1e-5


def test_serve_control_is_not_correct():
    """The reference with its scores' inputs in TF32, in the program's
    place, answering the same sampled requests."""
    ctx = context(SERVE)
    driver = harness.load_module("drivers", "serve_open_loop")
    values = driver.readings(ctx, "control")
    limits = ctx.workload["limits"]
    assert any(values[k] > limits[k] for k in values), values


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_serve_fault_under_the_timed_path_is_not_correct(monkeypatch,
                                                         fault):
    """The daemon with its engine broken underneath: the fold-in leaves
    its rows where they started; half of each scoring batch scored for no
    user; the first item of every answer swapped for its last."""
    from cu2rec_torch.serve import engine

    cls = engine.ShardedServingEngine
    fold, rec = cls._fold_in, cls._recommend

    def no_steps(self, T_u, items, vals, valid, hp, key, n_steps):
        return fold(self, T_u, items, vals, valid, hp, key, 0)

    def half(self, pr, ub, rated, rmask, k):
        pr = pr.clone()
        pr[1::2] = 0
        return rec(self, pr, ub, rated, rmask, k)

    def altered(self, pr, ub, rated, rmask, k):
        vals, idx = rec(self, pr, ub, rated, rmask, k)
        idx = idx.clone()
        idx[:, 0] = idx[:, -1]
        return vals, idx

    target, fn = {"unchanged": ("_fold_in", no_steps),
                  "half_batch": ("_recommend", half),
                  "altered": ("_recommend", altered)}[fault]
    monkeypatch.setattr(cls, target, fn)
    assert not _correct(run_cell(SERVE))


def _sgd_fault(monkeypatch, fault):
    from cu2rec_torch.ops.packed import PackedModel
    from cu2rec_torch.train import trainer

    steps = trainer.packed_run_steps
    evaluate = trainer.evaluate_packed

    def run_steps(pm, dev, hp, key, start, n, *a):
        out = steps(pm, dev, hp, key, start, n, *a)
        if fault == "unchanged":
            return pm
        T_u = out.T_u.clone()
        if fault == "half_batch":
            T_u[1::2] = pm.T_u[1::2]
        if fault == "altered" and start == 0:
            T_u = training.double_change(out.T_u, pm.T_u)
        return PackedModel(T_u=T_u, T_i=out.T_i,
                           global_bias=out.global_bias,
                           n_factors=out.n_factors)

    def half_eval(pm, dev):
        return evaluate(pm, dataclasses.replace(dev, nnz=dev.nnz // 2))

    if fault == "eval_half":
        monkeypatch.setattr(trainer, "evaluate_packed", half_eval)
    else:
        monkeypatch.setattr(trainer, "packed_run_steps", run_steps)


def _als_fault(monkeypatch, fault):
    from cu2rec_torch.train import als

    half_sweep = als.als_half_sweep
    evaluate = als.evaluate_packed

    def sweep(T_self, T_other, *a, **k):
        out = half_sweep(T_self, T_other, *a, **k)
        if fault == "unchanged":
            return T_self
        out = out.clone()
        if fault == "half_batch":
            out[1::2] = T_self[1::2]
        if fault == "altered":
            out = training.double_change(out, T_self)
        return out

    def half_eval(pm, dev):
        return evaluate(pm, dataclasses.replace(dev, nnz=dev.nnz // 2))

    if fault == "eval_half":
        monkeypatch.setattr(als, "evaluate_packed", half_eval)
    else:
        monkeypatch.setattr(als, "als_half_sweep", sweep)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered",
                                   "eval_half"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_under_the_timed_path_is_not_correct(monkeypatch, cell, fault):
    """The run with the timed path broken underneath (no look for a card
    here): a step that returns its state unchanged, half of the batch left
    out, an answer altered where it is made, the eval's mean over half of
    its ratings.  (One card: no exchange between cards to leave out.)"""
    plant = _sgd_fault if cell.endswith(".sgd") else _als_fault
    plant(monkeypatch, fault)
    record = run_cell(cell)
    assert not _correct(record), _values(record)


def test_reference_imports_nothing_of_the_port():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.mf_sgd, benchmark.reference.mf_als; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('cu2rec_torch', 'cu2rec_tpu', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)") % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_tf32_rounding():
    from benchmark.reference.mf_als import tf32

    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.14159265])
    y = tf32(x)
    assert y[0] == 1.0 and y[2] == 1.0 + 2 ** -10
    assert y[1] in (1.0, 1.0 + 2 ** -10)
    assert abs(float(y[3]) - 3.14159265) <= 3.2 * 2 ** -11
    assert torch.all((y.view(torch.int32) & 0x1FFF) == 0)
