"""The port's serving daemon against the TPU package's: the same JSONL
lines through both daemons' ``run_stdio`` give the same responses.

Recommend (single and batch) and implicit fold-in responses must agree:
items exactly wherever scores are not tied, scores within rtol 1e-5 /
atol 1e-5 for recommends (responses are rounded to 6 decimals) and
rtol 1e-3 for implicit fold-ins (float32 Cholesky).  Explicit fold-in uses
the default initial rows, which the port draws from a torch.Generator and
the TPU package from threefry, so it is checked for shape, exclusion of
rated items and determinism for a seed.  Errors, stats, ``warm()`` and the
``serve`` CLI are checked too."""

import io
import json
import pathlib
import sys

import jax
import numpy as np
import pytest

from cu2rec_torch.models.state import model_from_numpy
from cu2rec_torch.serve.daemon import ServingDaemon as TDaemon
from cu2rec_torch.serve.daemon import run_stdio as t_run_stdio
from cu2rec_torch.serve.engine import ServingEngine
from cu2rec_tpu.data import build_csr, read_ratings_csv
from cu2rec_tpu.models.state import init_model, model_to_numpy
from cu2rec_tpu.serve.daemon import ServingDaemon as JDaemon
from cu2rec_tpu.serve.daemon import run_stdio as j_run_stdio
from cu2rec_tpu.serve.engine import ShardedServingEngine
from cu2rec_tpu.utils.config import Config

DATA = pathlib.Path(__file__).parent / "data"


def _setup(seed=5, F=4):
    rd = read_ratings_csv(str(DATA / "test_ratings.csv"))
    csr = build_csr(rd)
    jmodel = init_model(csr.n_users, csr.n_items, F, rd.global_bias,
                        seed=seed)
    cfg = Config(n_factors=F, total_iterations=30, learning_rate=0.05,
                 is_train=False)
    jd = JDaemon(ShardedServingEngine(jmodel, devices=jax.devices()[:1]),
                 train_csr=csr, cfg=cfg, window_ms=0.0)
    from cu2rec_torch.data import build_csr as t_build_csr
    from cu2rec_torch.data import read_ratings_csv as t_read
    tcsr = t_build_csr(t_read(str(DATA / "test_ratings.csv")))
    td = TDaemon(ServingEngine(model_from_numpy(model_to_numpy(jmodel),
                                                "cpu"), device="cpu"),
                 train_csr=tcsr, cfg=cfg, window_ms=0.0)
    return jd, td, csr


def _serve(run, daemon, lines):
    out = io.StringIO()
    assert run(daemon, io.StringIO("\n".join(lines) + "\n"), out) == 0
    resps = [json.loads(line) for line in out.getvalue().splitlines()]
    assert len(resps) == len(lines)
    return resps


def _match_row(t, j, rtol, atol):
    assert len(t["items"]) == len(j["items"])
    np.testing.assert_allclose(t["scores"], j["scores"], rtol=rtol, atol=atol)
    s = np.asarray(j["scores"])
    for n, (a, b) in enumerate(zip(t["items"], j["items"])):
        if (np.abs(s - s[n]) <= 1e-5).sum() == 1:
            assert a == b


RECOMMEND = [
    {"id": 1, "op": "recommend", "user": 0, "k": 2},
    {"id": 2, "op": "recommend", "user": 3, "k": 4},
    {"id": 3, "op": "recommend", "users": [5, 1, 2, 4], "k": 3},
]
IMPLICIT = [
    {"id": 10 + b, "op": "fold_in", "mode": "implicit",
     "items": [0, 2 + b], "ratings": [2.0, 1.0 + b], "alpha": 5.0,
     "reg": 0.3, "k": 2} for b in range(3)
] + [{"id": 20, "op": "fold_in", "mode": "implicit", "items": [4],
      "ratings": [0.5], "k": 3}]


def test_recommend_and_implicit_responses_match():
    jd, td, _ = _setup()
    lines = [json.dumps(r) for r in RECOMMEND + IMPLICIT]
    jr = {r["id"]: r for r in _serve(j_run_stdio, jd, lines)}
    tr = {r["id"]: r for r in _serve(t_run_stdio, td, lines)}
    assert jr.keys() == tr.keys()
    for rid in jr:
        assert "error" not in tr[rid], tr[rid]
        if "results" in jr[rid]:
            assert len(tr[rid]["results"]) == len(jr[rid]["results"])
            for a, b in zip(tr[rid]["results"], jr[rid]["results"]):
                _match_row(a, b, rtol=1e-5, atol=1e-5)
        elif rid >= 10:
            _match_row(tr[rid], jr[rid], rtol=1e-3, atol=1e-4)
        else:
            _match_row(tr[rid], jr[rid], rtol=1e-5, atol=1e-5)
    # user 0 rated 4 of the 5 toy items: k=2 trims to 1
    assert len(tr[1]["items"]) == 1
    for r in IMPLICIT:
        assert not set(tr[r["id"]]["items"]) & set(r["items"])


def test_explicit_fold_in_shape_exclusion_and_determinism():
    _, td, _ = _setup()
    reqs = [{"id": 1, "op": "fold_in", "items": [0, 1, 2],
             "ratings": [5.0, 5.0, 5.0], "k": 2},
            {"id": 2, "op": "fold_in", "items": [3], "ratings": [1.0],
             "k": 3, "iterations": 12}]
    lines = [json.dumps(r) for r in reqs]
    first = {r["id"]: r for r in _serve(t_run_stdio, td, lines)}
    again = {r["id"]: r for r in _serve(t_run_stdio, _setup()[1], lines)}
    assert first == again
    assert len(first[1]["items"]) == 2 and len(first[2]["items"]) == 3
    assert not set(first[1]["items"]) & {0, 1, 2}
    assert 3 not in first[2]["items"]


BAD = [
    {"id": 1, "op": "nope"},
    {"id": 2, "op": "fold_in", "items": [], "ratings": []},
    {"id": 3, "op": "fold_in", "items": [0], "ratings": [1.0, 2.0]},
    {"id": 4, "op": "fold_in", "items": [99], "ratings": [1.0]},
    {"id": 5, "op": "recommend", "user": -1},
    {"id": 6, "op": "recommend", "user": 0, "k": 0},
    {"id": 7, "op": "fold_in", "items": [0], "ratings": [float("nan")]},
    {"id": 8, "op": "recommend", "users": [0, True]},
    {"id": 9, "op": "fold_in", "mode": "implicit", "items": [1, 2],
     "ratings": [-1.0, 2.0]},
    {"id": 10, "op": "fold_in", "mode": "ridge", "items": [1],
     "ratings": [1.0]},
]


def test_errors_and_stats_match():
    jd, td, _ = _setup()
    lines = [json.dumps(r) for r in BAD] + ["not json",
                                            json.dumps({"id": 99,
                                                        "op": "stats"})]
    jr = _serve(j_run_stdio, jd, lines)
    tr = _serve(t_run_stdio, td, lines)
    for a, b in zip(tr[:-2], jr[:-2]):
        assert a == b and "error" in a
    assert "bad json" in tr[-2]["error"] and "bad json" in jr[-2]["error"]
    ts, js = tr[-1], jr[-1]
    for key in ("id", "n_items", "n_factors", "n_shards", "requests",
                "batches", "mean_batch"):
        assert ts[key] == js[key], key
    assert ts["device"] == "cpu"


def test_warm_counts_signatures_on_a_fresh_daemon():
    _, td, _ = _setup()
    n = td.warm(max_batch=8, max_width=8)
    assert n > 0
    assert td.warm(max_batch=8, max_width=8) == 0  # nothing new
    with pytest.raises(ValueError, match="unknown warm ops"):
        td.warm(max_batch=8, ops=("recommend", "bogus"))


def test_serve_cli_checkpoint_stdio(tmp_path, monkeypatch, capsys):
    from cu2rec_torch.cli.serve import main
    from cu2rec_tpu.utils.checkpoint import save_checkpoint

    rd = read_ratings_csv(str(DATA / "test_ratings.csv"))
    jmodel = init_model(rd.n_users, rd.n_items, 4, rd.global_bias, seed=5)
    ckpt = save_checkpoint(str(tmp_path / "m.npz"), jmodel,
                           Config(n_factors=4, total_iterations=20))
    reqs = "\n".join(json.dumps(r) for r in [
        {"id": 1, "op": "recommend", "user": 0, "k": 2},
        {"id": 2, "op": "fold_in", "items": [0, 1], "ratings": [5.0, 4.0],
         "k": 2},
        {"id": 3, "op": "fold_in", "mode": "implicit", "items": [0, 1],
         "ratings": [1.0, 4.0], "k": 2},
        {"id": 4, "op": "stats"},
    ]) + "\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO(reqs))
    rc = main(["--checkpoint", ckpt, "--train",
               str(DATA / "test_ratings.csv"), "--device", "cpu",
               "--window-ms", "0", "--warm-batch", "8", "--warm-width", "8"])
    assert rc == 0
    captured = capsys.readouterr()
    by_id = {r["id"]: r for r in (json.loads(line) for line in
                                  captured.out.splitlines() if line.strip())}
    assert all("error" not in r for r in by_id.values()), by_id
    assert len(by_id[1]["items"]) == 1
    assert len(by_id[2]["items"]) == 2 and len(by_id[3]["items"]) == 2
    assert not {0, 1} & set(by_id[2]["items"] + by_id[3]["items"])
    assert by_id[4]["device"] == "cpu" and by_id[4]["n_factors"] == 4
    assert "warm:" in captured.err


def _cli_responses(main, argv, reqs, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "\n".join(json.dumps(r) for r in reqs) + "\n"))
    assert main(argv) == 0
    captured = capsys.readouterr()
    return {r["id"]: r for r in (json.loads(line) for line in
                                 captured.out.splitlines() if line.strip())
            }, captured.err


def test_serve_cli_rejects_several_devices(tmp_path, monkeypatch, capsys):
    """``serve --devices 2 --device cpu`` (once refused) cuts the catalog
    into two item shards on the CPU and answers as the TPU package's CLI
    does over two devices (tests/test_daemon.py): a known-user recommend
    and a fold-in from a checkpoint, and a fold-in from -q/-i/-g
    components, where a recommend by id is an error."""
    from cu2rec_torch.cli.serve import main
    from cu2rec_tpu.utils.checkpoint import export_components, save_checkpoint

    rd = read_ratings_csv(str(DATA / "test_ratings.csv"))
    jmodel = init_model(rd.n_users, rd.n_items, 4, rd.global_bias, seed=5)
    ckpt = save_checkpoint(str(tmp_path / "m.npz"), jmodel,
                           Config(n_factors=4, total_iterations=20))
    by_id, err = _cli_responses(main, [
        "--checkpoint", ckpt, "--train", str(DATA / "test_ratings.csv"),
        "--devices", "2", "--device", "cpu", "--window-ms", "0"], [
        {"id": 1, "op": "recommend", "user": 0, "k": 2},
        {"id": 2, "op": "fold_in", "items": [0, 1], "ratings": [5.0, 4.0],
         "k": 2},
        {"id": 3, "op": "stats"}], monkeypatch, capsys)
    assert all("error" not in r for r in by_id.values()), by_id
    # user 0 has a single unrated item; the fold-in user left 3 unrated
    assert len(by_id[1]["items"]) == 1
    assert len(by_id[2]["items"]) == 2 and not {0, 1} & set(
        by_id[2]["items"])
    assert by_id[3]["n_shards"] == 2
    assert by_id[3]["devices"] == ["cpu", "cpu"]
    assert "2 item shard(s)" in err

    export_components(jmodel, str(tmp_path), "toy", 4)
    by_id, _ = _cli_responses(main, [
        "-q", str(tmp_path / "toy_f4_q.csv"),
        "-i", str(tmp_path / "toy_f4_item_bias.csv"),
        "-g", str(tmp_path / "toy_f4_global_bias.csv"),
        "--devices", "2", "--device", "cpu", "--window-ms", "0"], [
        {"id": 1, "op": "fold_in", "items": [0, 1], "ratings": [5.0, 4.0],
         "k": 3},
        {"id": 2, "op": "recommend", "user": 0, "k": 3}],
        monkeypatch, capsys)
    assert len(by_id[1]["items"]) == 3
    assert not {0, 1} & set(by_id[1]["items"])
    assert "error" in by_id[2]  # no known users in this mode


def test_serve_cli_item_components_foldin_only(tmp_path, monkeypatch,
                                               capsys):
    """predict.cu-style source (-q/-i/-g): fold-in works, recommend-by-id
    is rejected (no known users)."""
    from cu2rec_torch.cli.serve import main
    from cu2rec_tpu.utils.checkpoint import export_components

    jmodel = init_model(6, 5, 4, 3.0, seed=5)
    export_components(jmodel, str(tmp_path), "toy", 4)
    reqs = "\n".join(json.dumps(r) for r in [
        {"id": 1, "op": "fold_in", "items": [0, 1], "ratings": [5.0, 4.0],
         "k": 3},
        {"id": 2, "op": "recommend", "user": 0, "k": 3},
    ]) + "\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO(reqs))
    rc = main(["-q", str(tmp_path / "toy_f4_q.csv"),
               "-i", str(tmp_path / "toy_f4_item_bias.csv"),
               "-g", str(tmp_path / "toy_f4_global_bias.csv"),
               "--device", "cpu", "--window-ms", "0"])
    assert rc == 0
    by_id = {r["id"]: r for r in (json.loads(line) for line in
                                  capsys.readouterr().out.splitlines()
                                  if line.strip())}
    assert len(by_id[1]["items"]) == 3
    assert not {0, 1} & set(by_id[1]["items"])
    assert "error" in by_id[2]


def test_completion_threads_materialize_device_results():
    """The daemon's completion pool turns the engine's tensors into host
    responses (``_host``), for a group split over several engine calls."""
    _, td, _ = _setup()
    td.max_rows = 2
    td.start()
    try:
        fut = td.submit({"id": 1, "op": "recommend", "users": [0, 1, 2, 3,
                                                               4], "k": 2})
        resp = fut.result(timeout=60)
    finally:
        td.close()
    assert len(resp["results"]) == 5
    assert all(isinstance(i, int) for r in resp["results"]
               for i in r["items"])
