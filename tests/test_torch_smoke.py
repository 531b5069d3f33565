"""``chip_smoke.py``'s profiling on the CPU, with stand-in profiler sessions:
a session that records no device event is run again, at most
``PROFILE_TRIES`` times, both for the step loop and for a serving wave's
replay, and the smoke fails after that many empty sessions."""

import importlib.util
import json
import pathlib
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


class _Session:
    """A profiler session that records the given events, parsed
    (``events()``) and raw (``profiler.kineto_results.events()``)."""

    def __init__(self, events):
        self._events = events
        raw = [SimpleNamespace(device_type=lambda e=e: e.device_type)
               for e in events]
        self.profiler = SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: raw))

    def start(self):
        pass

    def stop(self):
        pass

    def events(self):
        return self._events


def _event(device, name="kernel", start=0, end=5):
    return SimpleNamespace(device_type=device, name=name,
                           time_range=SimpleNamespace(start=start, end=end))


CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def test_profiled_runs_again_until_a_session_records_device_time():
    smoke = _smoke()
    sessions = iter([_Session([]), _Session([_event(CPU)]),
                     _Session([_event(CPU), _event(CUDA)])])
    runs = []
    prof, host_s = smoke._profiled(torch, lambda: runs.append(1),
                                   lambda: next(sessions))
    assert len(runs) == 3 and host_s >= 0
    assert smoke._device_breakdown(torch, prof) == (5e-6,
                                                    [("kernel", 0.005, 1)])


def test_profiled_fails_after_as_many_empty_sessions_as_it_tries():
    smoke = _smoke()
    runs = []
    with pytest.raises(smoke.SmokeFailure, match="no device time"):
        smoke._profiled(torch, lambda: runs.append(1),
                        lambda: _Session([_event(CPU)]))
    assert len(runs) == smoke.PROFILE_TRIES


def test_wave_input_replays_a_wave_while_its_profile_is_empty():
    """The serve phase's replay of a wave goes out again, under new ids,
    until its session records device time; the attempt kept is noted."""
    smoke = _smoke()
    waves = [[{"id": "a", "op": "recommend"}], [{"id": "s", "op": "stats"}]]
    out = SimpleNamespace(cond=threading.Condition(), t_done={
        i: 0.0 for i in ("a", "a~prof0", "a~prof1", "s")})
    sessions = iter([_Session([]), _Session([_event(CUDA)])])
    inp = smoke._WaveInput(waves, out, lambda: 0, lambda: next(sessions),
                           lambda p: smoke._has_device_time(torch, p))
    sent = [json.loads(line)["id"] for line in inp]
    assert sent == ["a", "a~prof0", "a~prof1", "s"]
    assert [attempt for _, _, attempt in inp.profiles] == [1]
    assert inp.counts == [(0, 0), (0, 0)]


def test_has_device_time_reads_a_real_session():
    """On a real session of the CPU profiler, which records no device
    event, the check reads the raw trace and finds none."""
    from torch.profiler import ProfilerActivity

    smoke = _smoke()
    prof = torch.profiler.profile(activities=[ProfilerActivity.CPU])
    prof.start()
    torch.ones(8).sum()
    prof.stop()
    assert not smoke._has_device_time(torch, prof)
    assert any(e.device_type == CPU for e in prof.events())


# ---- phase 7 (the training families): its helpers on the CPU --------------

def test_implicit_on_card_recipe_on_cpu_tensors():
    """The on-card implicit generator, run on CPU tensors at a small size:
    sorted unique pairs, disjoint train and test, about a tenth held out,
    and an oracle AUC well above chance."""
    import numpy as np

    smoke = _smoke()
    tr, te, oracle = smoke._implicit_on_card(torch, 400, 60, 12_000, 8, 3,
                                             torch.device("cpu"),
                                             chunk_users=64)
    assert 0.6 < oracle <= 1.0
    keys = {}
    for name, csr in (("train", tr), ("test", te)):
        assert csr.n_users == 400 and csr.n_items == 60
        assert csr.indptr[-1] == csr.nnz and (np.diff(csr.indptr) >= 0).all()
        k = csr.row_ids.astype(np.int64) * 60 + csr.indices
        assert (np.diff(k) > 0).all()                  # sorted and unique
        assert (csr.data == 1.0).all()
        keys[name] = set(k.tolist())
    assert not keys["train"] & keys["test"]
    n = tr.nnz + te.nnz
    assert 0.05 < te.nnz / n < 0.15 and n < 12_000     # deduplicated
    # The same seed gives the same data.
    again, _, oracle2 = smoke._implicit_on_card(
        torch, 400, 60, 12_000, 8, 3, torch.device("cpu"), chunk_users=64)
    assert np.array_equal(again.indices, tr.indices) and oracle2 == oracle


def test_phase7_gates_and_metric_parsing():
    smoke = _smoke()
    text = ("IALS sweep 1: AUC = 0.6010  recall@10 = 0.0100  "
            "ndcg@10 = 0.0200\nsomething else\n"
            "IALS sweep 5: AUC = 0.7400  recall@10 = 0.0500  "
            "ndcg@10 = 0.0600\n")
    rows = smoke._implicit_metrics(text)
    assert rows == [(1, 0.601, 0.01, 0.02), (5, 0.74, 0.05, 0.06)]
    smoke._gate_ials(rows, 27_000)
    with pytest.raises(smoke.SmokeFailure, match="recall"):
        smoke._gate_ials(rows, 500)                # needs recall >= 0.1
    with pytest.raises(smoke.SmokeFailure, match="AUC"):
        smoke._gate_ials([(5, 0.64, 0.9, 0.9)], 27_000)
    with pytest.raises(smoke.SmokeFailure, match="does not parse"):
        smoke._implicit_metrics("BPR iteration 1: AUC = nan  recall@10 = "
                                "0.1  ndcg@10 = 0.1\n")
    with pytest.raises(smoke.SmokeFailure, match="no implicit"):
        smoke._implicit_metrics("TRAIN: Iteration 1 GPU MAE: 1 RMSE: 1\n")
    smoke._gate_bpr([(1, 0.5, 0, 0), (500, 0.61, 0, 0)])
    for rows in ([(1, 0.5, 0, 0), (500, 0.59, 0, 0)],
                 [(1, 0.7, 0, 0), (500, 0.65, 0, 0)]):
        with pytest.raises(smoke.SmokeFailure, match="BPR AUC"):
            smoke._gate_bpr(rows)
    smoke._gate_als([0.9, 0.7, 0.5], 0.8)
    for rmse, mean in (([0.9, 0.95], 1.0), ([0.9, 0.85], 0.8)):
        with pytest.raises(smoke.SmokeFailure, match="ALS test RMSE"):
            smoke._gate_als(rmse, mean)


def test_phase7_entry_points_on_cpu(tmp_path, monkeypatch):
    """``mf --algo als|ials|bpr`` as phase 7 runs it, on the CPU at a tiny
    shape: every run exits 0, its lines parse and its CSVs are written."""
    smoke = _smoke()
    monkeypatch.setattr(smoke, "ML100K", (60, 40, 1500))
    monkeypatch.setattr(smoke, "F", 8)
    launches = smoke._entry_points(0, tmp_path, "cpu", device="cpu")
    assert set(launches) == {"als", "ials", "bpr"}
    assert (tmp_path / "out_bpr" / "implicit_train_f8_q.csv").exists()


def test_explicit_family_data_at_a_small_shape(monkeypatch):
    smoke = _smoke()
    monkeypatch.setattr(smoke, "U", 300)
    monkeypatch.setattr(smoke, "I", 80)
    monkeypatch.setattr(smoke, "ALS_DRAWS", 6000)
    tr, te, mu, mean_rmse = smoke._explicit_family_data(1)
    assert tr.nnz == 5400 and te.nnz == 600
    assert tr.n_users == te.n_users == 300 and tr.n_items == 80
    assert (np.diff(tr.indptr) >= 0).all() and tr.indptr[-1] == tr.nnz
    assert abs(mu - float(np.mean(tr.data))) < 1e-9 and 0.3 < mean_rmse < 2


def test_phase8_pipeline_on_cpu(tmp_path, monkeypatch):
    """Phase 8 as the smoke runs it, on the CPU at ML-100K's preset and
    F=8: synth, map_items, split, mf, the three evaluate runs, convert_to_np
    and the reader comparison pass their gates, and mf went through the
    native library."""
    smoke = _smoke()
    monkeypatch.setattr(smoke, "F", 8)
    monkeypatch.setattr(smoke, "PIPE_PRESET", "ml100k")
    launches, measured = smoke.phase_pipeline(0, tmp_path, "cpu",
                                              device="cpu")
    assert launches == {"sgd_step": 0, "eval_error": 0}
    assert measured["native_calls"] >= 7
    assert {"synth", "map_items", "split", "mf", "evaluate",
            "convert_to_np"} <= measured["steps_s"].keys()
    assert (tmp_path / "out" / "raw_mapped_train_f8_q.npy").exists()


def test_phase5_train_on_cpu(tmp_path, monkeypatch, capsys):
    """Phase 5's ``mf`` run as the smoke drives it, on the CPU at a small
    shape: its gates hold and its line splits the export into the CSVs and
    the checkpoint."""
    smoke = _smoke()
    for name, value in (("U", 500), ("I", 200), ("F", 8),
                        ("TRAIN_RATINGS", 20_000), ("TEST_RATINGS", 2_000)):
        monkeypatch.setattr(smoke, name, value)
    launches, out, final = smoke.phase_train(torch, 0, tmp_path, "cpu",
                                             device="cpu")
    assert launches == {"sgd_step": 0, "eval_error": 0}
    assert np.isfinite(final)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[train] mf on cpu")][0]
    assert "CSVs" in line and "checkpoint" in line
    assert (out / "train_f8_q.csv").exists()


def test_phase9_entry_points_on_cpu(tmp_path, monkeypatch, capsys):
    """Phase 9's entry points as the smoke drives them, on the CPU at small
    shapes: mf in bf16 and with mean collisions, the trainer for the other
    variants, predict with a bf16 config, ALS in both dtypes, both fold-in
    ranking evals and the client pass their gates."""
    smoke = _smoke()
    for name, value in (("U", 500), ("I", 200), ("F", 8),
                        ("TRAIN_RATINGS", 20_000), ("TEST_RATINGS", 2_000),
                        ("CLIENT_CALLS", 600)):
        monkeypatch.setattr(smoke, name, value)
    _launches, _out, final = smoke.phase_train(torch, 0, tmp_path, "cpu",
                                               device="cpu")
    launches, extras = smoke.phase_variants(torch, 0, tmp_path, "cpu", final,
                                            device="cpu")
    assert launches["ridge_cholesky"] == 0
    out = capsys.readouterr().out
    for what in ("mf --dtype bfloat16", "mf --collision mean",
                 "train bfloat16/twin", "train float32/sum",
                 "predict with a bf16 config", "--algo als --dtype bfloat16",
                 "foldin_ranking_eval explicit",
                 "foldin_ranking_eval implicit", "[client] 600"):
        assert what in out, what
    assert extras["client_requests_s"] > 0
    assert extras["foldin_recall"]["implicit"] > 10 / 1682


@pytest.mark.parametrize("collision", ["sum", "mean"])
@pytest.mark.parametrize("skewed", [False, True])
def test_phase9_bf16_gate_reads_a_planted_fault(monkeypatch, collision,
                                                skewed):
    """Phase 9's gate on the item side of bf16 mean and sum, on the CPU at
    a small shape: the plain version reads 0 against itself, and a plain
    version that drops the last pair of the step's longest run reads above
    BF16_CHAIN_ULPS under sum, and under mean where runs are short (on a
    skewed run the dropped delta over the run's count is below an ulp)."""
    smoke = _smoke()
    for name, value in (("U", 3000), ("I", 800), ("N_HEADLINE", 30_000)):
        monkeypatch.setattr(smoke, name, value)
    from cu2rec_torch.data.csr import to_device
    from cu2rec_torch.ops.packed import (PackedModel, packed_step,
                                         packed_step_reference)
    from cu2rec_torch.ops.sgd import prng_key

    csr = smoke._headline_csr(0, smoke.SKEW_POWER if skewed else None)
    dr = to_device(csr, "cpu")
    pm = smoke._packed_tables(torch, 3000, 800, 16, 0, "cpu")
    pm = PackedModel(T_u=pm.T_u.bfloat16(), T_i=pm.T_i.bfloat16(),
                     global_bias=pm.global_bias, n_factors=16)
    got = packed_step(pm, dr, smoke._hp(), prng_key(0), 0,
                      collision=collision)
    peak = torch.zeros(pm.T_i.shape)
    want = packed_step_reference(pm, dr, smoke._hp(), prng_key(0), 0,
                                 collision=collision, peak=peak)
    assert smoke._bf16_error(torch, got.T_i, want.T_i, pm.T_i,
                             peak) == (0.0, 0, 0)
    faults = smoke._planted_readings(torch, pm, dr, collision, 0, got, peak)
    assert set(faults) == {"drop", "reverse"}
    if collision == "sum" or not skewed:
        assert faults["drop"] > smoke.BF16_CHAIN_ULPS, faults


def test_step_ab_runs_each_checkout_in_turn_and_takes_medians(
        monkeypatch, tmp_path):
    """``experiments/step_ab.py`` runs A B B A and reports, per checkout,
    the median of each time over its runs."""
    from cu2rec_torch.experiments import step_ab

    calls = []

    def run(root, reps):
        calls.append((root.name, reps))
        t = float(len(calls))
        return {"first_wins": {"loop_ms": t, "enqueue_ms": t, "held_ms": t},
                "twin": {"loop_ms": t, "enqueue_ms": t, "held_ms": t},
                "eval_error": {"held_ms": 2 * t}}

    monkeypatch.setattr(step_ab, "_run", run)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    out = tmp_path / "ab.json"
    assert step_ab.main([str(tmp_path / "a"), str(tmp_path / "b"),
                         "--reps", "3", "--out", str(out)]) == 0
    assert calls == [("a", 3), ("b", 3), ("b", 3), ("a", 3)]
    median = json.loads(out.read_text())["median"]
    assert median["a"]["first_wins"]["loop_ms"] == 2.5     # runs 1 and 4
    assert median["b"]["twin"]["held_ms"] == 2.5           # runs 2 and 3
    assert median["b"]["eval_error"]["held_ms"] == 5.0


def test_serve_ab_runs_each_checkout_in_turn_and_takes_medians(
        monkeypatch, tmp_path, capsys):
    """``experiments/serve_ab.py`` runs A B B A through the shared turns and
    reports, per checkout, the median of each wave's latency and of the
    requests/s over its runs."""
    from cu2rec_torch.experiments import serve_ab

    calls = []

    def run(root):
        calls.append(root.name)
        t = float(len(calls)) ** 2
        return {"lat_ms": [t, 2 * t, 3 * t], "rps": 10 * t, "card": "x",
                "log": []}

    monkeypatch.setattr(serve_ab, "_run", run)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    assert serve_ab.main([str(tmp_path / "a"), str(tmp_path / "b")]) == 0
    assert calls == ["a", "b", "b", "a"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln)["checkout"] for ln in lines[:4]] == \
        ["a", "b", "b", "a"]
    median = json.loads(lines[-1])["median"]
    assert median["a"] == {"lat_ms": [8.5, 17.0, 25.5], "rps": 85.0}
    assert median["b"] == {"lat_ms": [6.5, 13.0, 19.5], "rps": 65.0}


@pytest.mark.parametrize("skewed", [False, True])
def test_phase9_run_order_check_rejects_planted_faults(monkeypatch, skewed):
    """Phase 9's check of a mean/sum step's runs, on the CPU at a small
    shape: the runs pass against the stable sort, and a planted swap of two
    users in a run and a planted dropped pair are each rejected."""
    smoke = _smoke()
    for name, value in (("U", 3000), ("I", 800), ("N_HEADLINE", 30_000)):
        monkeypatch.setattr(smoke, name, value)
    from cu2rec_torch.data.csr import to_device
    from cu2rec_torch.ops.packed import collision_runs
    from cu2rec_torch.ops.sgd import prng_key, sample_items

    dr = to_device(smoke._headline_csr(0, smoke.SKEW_POWER if skewed
                                       else None), "cpu")
    pairs, longest = smoke._check_run_order(torch, dr, 0, "test")
    assert pairs > 2500 and longest >= (100 if skewed else 2)
    offsets, users = collision_runs(dr, prng_key(0), 7)
    items, _r, has = sample_items(prng_key(0), 7, dr.indptr, dr.indices,
                                  dr.data)
    for fault in ("swap", "drop"):
        bad = smoke._planted_runs(torch, offsets, users, fault)
        with pytest.raises(smoke.SmokeFailure, match="test: the"):
            smoke._check_runs(torch, *bad, items, has, 800, "test")
    # The planted runs leave the inputs as they were.
    assert smoke._check_runs(torch, offsets, users, items, has, 800,
                             "test") == longest


def test_item_side_time_is_the_busy_time_outside_the_user_kernel():
    """The profile's item side: the union of the kernel intervals less the
    user kernel's, overlaps counted once."""
    smoke = _smoke()
    prof = _Session([_event(CUDA, "sgd_user_kernel<128>", 0, 10),
                     _event(CUDA, "run_offsets_kernel", 2, 12),
                     _event(CUDA, "collide_long_kernel", 12, 30),
                     _event(CUDA, "collide_item_kernel", 14, 20),
                     _event(CPU, "host", 0, 100)])
    busy, top = smoke._device_breakdown(torch, prof)
    side, _ = smoke._device_breakdown(torch, prof,
                                      outside="sgd_user_kernel")
    assert busy == pytest.approx(30e-6) and side == pytest.approx(20e-6)
    assert top[0] == ("collide_long_kernel", 0.018, 1)


def test_phase11_response_gate_reads_planted_faults():
    """Phase 11 holds a sharded response against the one-device one:
    scores within rtol (plus a response's rounding), items equal wherever
    the reference's score is not tied; a swapped untied item, a moved
    score or a missing item fails."""
    smoke = _smoke()
    want = {"items": [4, 9, 2, 7], "scores": [3.9, 3.5, 3.5, 3.1]}
    same = {"items": [4, 2, 9, 7], "scores": [3.9, 3.5, 3.5, 3.1000002]}
    smoke._same_response(same, want, 1e-5, "tied swap")
    faults = {
        "swap": {"items": [9, 4, 2, 7], "scores": [3.9, 3.5, 3.5, 3.1]},
        "score": {"items": [4, 9, 2, 7], "scores": [3.9, 3.5, 3.5, 3.2]},
        "short": {"items": [4, 9, 2], "scores": [3.9, 3.5, 3.5]},
    }
    for what, got in faults.items():
        with pytest.raises(smoke.SmokeFailure):
            smoke._same_response(got, want, 1e-5, what)


def test_wave_input_without_a_profiler_sends_each_wave_once():
    smoke = _smoke()
    out = smoke._ResponseOutput()
    waves = [[{"id": "a"}, {"id": "b"}], [{"id": "c"}]]
    inp = smoke._WaveInput(waves, out, lambda: 0, None, None)
    lines = []
    for line in inp:
        lines.append(json.loads(line))
        out.write(json.dumps({"id": lines[-1]["id"]}) + "\n")
    assert [r["id"] for r in lines] == ["a", "b", "c"]
    assert inp.profiles == [] and len(inp.counts) == 2
    items, vals, mask = smoke._fold_arrays([
        {"items": [3, 1], "ratings": [5.0, 4.0]},
        {"items": [2], "ratings": [1.0]}])
    np.testing.assert_array_equal(items, [[3, 1], [2, 0]])
    np.testing.assert_array_equal(mask, [[True, True], [True, False]])
    np.testing.assert_array_equal(vals, [[5.0, 4.0], [1.0, 0.0]])


# ---- K0c (the explicit serving fold-in): its checks' helpers on the CPU ---

def test_wave_launches_hold_each_kernel_to_its_wave():
    """K1 and K4 only in the implicit wave and K0c only in the explicit
    wave: any other placement fails the smoke.  Each probe reads (K1,
    K0c, K4)."""
    smoke = _smoke()
    good = [((0, 0, 0), (0, 0, 0)), ((0, 0, 0), (0, 1, 0)),
            ((0, 1, 0), (3, 1, 3)), ((3, 1, 3), (3, 1, 3))]
    inp = SimpleNamespace(counts=good)
    assert smoke._wave_launches(inp, "x") == ([0, 0, 3], [0, 1, 0],
                                              [0, 0, 3])
    for bad, what in (([((0, 0, 0), (0, 0, 0)), ((0, 0, 0), (0, 0, 0)),
                        ((0, 0, 0), (3, 0, 3))], "foldin was not launched"),
                      ([((0, 0, 0), (0, 1, 0)), ((0, 1, 0), (0, 2, 0)),
                        ((0, 2, 0), (3, 2, 3))], "foldin launched outside"),
                      ([((0, 0, 0), (0, 0, 0)), ((0, 0, 0), (0, 1, 0)),
                        ((0, 1, 0), (0, 1, 0))], "ridge_cholesky was not"),
                      ([((0, 0, 0), (0, 0, 0)), ((0, 0, 0), (0, 1, 0)),
                        ((0, 1, 0), (3, 1, 0))], "gather_gram was not"),
                      ([((0, 0, 0), (0, 0, 1)), ((0, 0, 1), (0, 1, 1)),
                        ((0, 1, 1), (3, 1, 4))],
                       "gather_gram launched outside")):
        with pytest.raises(smoke.SmokeFailure, match=what):
            smoke._wave_launches(SimpleNamespace(counts=bad), "x")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_foldin_check_rejects_a_shifted_counter(dtype):
    """The K0c phase's inputs on the CPU: the plain fold-in agrees with
    itself, a run whose iteration counter is shifted by one falls outside
    FOLD_RTOL, and the distinct sampled rows are those the draws name."""
    from cu2rec_torch.ops.sgd import prng_key
    from cu2rec_torch.serve.engine import fold_in_steps

    smoke = _smoke()
    sets = smoke._fold_inputs(torch, torch.device("cpu"), 0, 500, 16, 12,
                              8, 2, dtype, 2)
    assert len(sets) == 2
    args = sets[0]
    assert args[1].dtype == dtype and args[1].shape == (500, 64)
    lens = args[4].sum(dim=1)
    assert bool(((lens >= 2) & (lens <= 8)).all())
    assert torch.equal(args[4], torch.arange(8)[None, :] < lens[:, None])
    key = prng_key(3)
    want = fold_in_steps(*args, 3.5, smoke._hp(), key, 40, 16)
    assert smoke._fold_err(torch, want, want) == 0.0
    shifted = smoke._shifted_plain(args, 3.5, smoke._hp(), key, 40, 16)
    assert smoke._fold_err(torch, want, shifted) > smoke.FOLD_RTOL
    assert smoke._fold_err(torch, want, fold_in_steps(
        *args, 3.5, smoke._hp(), key, 40, 16)) == 0.0   # restored
    one = (args[0], args[1], args[2][:, :1].contiguous(),
           args[3][:, :1].contiguous(), args[4][:, :1].contiguous())
    assert smoke._sampled_rows(torch, key, one[2], one[4], 5) == \
        torch.unique(one[2]).numel()


@pytest.mark.parametrize("n_ip", [1, 2])
def test_fold_stages_split_a_batch_and_leave_the_engine_as_it_was(n_ip):
    """Phase 11 (b)'s stage timers on a CPU engine: every stage of
    FOLD_STAGES a batch, none negative beyond the clock's jitter, their sum
    the batch's total; the rows assembled only over several shards; the
    engine's methods and the kernel's wrapper put back."""
    from _torch_serving_util import planted_arrays

    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.ops import cuda_foldin
    from cu2rec_torch.serve.engine import ShardedServingEngine
    from cu2rec_torch.utils.config import Config

    smoke = _smoke()
    tables, _ = planted_arrays()
    eng = ShardedServingEngine(model_from_numpy(tables, "cpu"),
                               devices=["cpu"] * n_ip)
    rng = np.random.default_rng(0)
    fold = (rng.integers(0, 300, (6, 5)).astype(np.int32),
            np.full((6, 5), 3.0, np.float32), rng.random((6, 5)) < 0.7)
    cfg = Config(total_iterations=20, n_factors=16, is_train=False)
    kernel = cuda_foldin.fold_in_cuda
    batches = smoke._fold_stages(eng, fold, cfg, 3)
    assert len(batches) == 3
    for b in batches:
        assert set(b) == {"total", *smoke.FOLD_STAGES}
        assert all(b[k] > -0.05 for k in smoke.FOLD_STAGES)
        assert sum(b[k] for k in smoke.FOLD_STAGES) == pytest.approx(
            b["total"], abs=1e-6)
        assert b["launch"] == 0.0            # the CPU runs the plain loop
        assert (b["assemble"] > 0) == (n_ip > 1)
    assert cuda_foldin.fold_in_cuda is kernel
    assert not {"fold_in_padded", "_default_init", "_upload", "_fold_in",
                "_rows"} & set(vars(eng))


def test_foldin_holey_inputs_mask_out_ids_past_the_catalog():
    """Phase 4's holey case: every eighth user has no rating, the others
    about 60% of their columns in no order, and every masked-out id lies
    past the catalog, which the plain fold-in never reads."""
    from cu2rec_torch.ops.sgd import prng_key
    from cu2rec_torch.serve.engine import fold_in_steps

    smoke = _smoke()
    (args,) = smoke._fold_inputs(torch, torch.device("cpu"), 1, 400, 16,
                                 24, 33, 0, torch.float32, 1, True)
    mask = args[4]
    assert not mask[3::8].any() and bool(mask.any(dim=1)[:3].all())
    assert not bool(mask.all(dim=1).any())       # holes in every row
    assert bool((args[2][~mask] == 407).all())
    assert bool((args[2][mask] < 400).all())
    out = fold_in_steps(*args, 3.5, smoke._hp(), prng_key(1), 20, 16)
    assert torch.equal(out[3::8], args[0][3::8])
    assert smoke._sampled_rows(torch, prng_key(1), args[2], mask, 20) > 0


@pytest.mark.parametrize("mangled,name", [
    ("_ZN41_GLOBAL__N__03227e47_9_foldin_cu_21312c7d13foldin_kernelINS_10"
     "FoldLayoutILi128EfLi32EEEEEvPKfPfPKNT_4ElemEPKiS4_PKhiiiiffffjj",
     "foldin_kernel<128,float32,32>"),
    ("_ZN41_GLOBAL__N__03227e47_9_foldin_cu_21312c7d13foldin_kernelINS_10"
     "FoldLayoutILi64E13__nv_bfloat16Li8EEEEEvPKfPfPKNT_4ElemEPKiS5_PKhiiii"
     "ffffjj", "foldin_kernel<64,bfloat16,8>"),
    ("_ZN41_GLOBAL__N__3523bec8_9_foldin_cu_512ffaf313foldin_kernelI9RowLa"
     "youtILi128EfEEEvPKfPfPKNT_4ElemEPKiS4_SB_iiiiffffjj",
     "foldin_kernel<128,float32>")])
def test_kernel_names_read_every_template_argument(mangled, name):
    """Phase 2's names of the ``-Xptxas -v`` report: the row width, the
    element type and, for K0c, the lanes a row."""
    assert _smoke()._kernel_name(mangled) == name
