"""The port's trainer (``train/trainer.py`` on the CPU: the plain versions
of K0a and K0b) against the TPU package's ``train`` on ML-100K, F=16, 300
iterations, an eval every 50, with the TPU package's initial tables
injected into both.

The learning rate is 0.1.  At that rate the test RMSE rises twice within
300 iterations under both policies, so the plateau scheduler decays the
rate once (after iteration 250 under first_wins, 200 under twin).  Every
rise is above 0.005, fifty times the 1e-4 tolerance, so no decay hangs on
a near tie.  (At 0.05 two first_wins eval points tie to five decimals.)
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cu2rec_torch.data.csr import build_csr as t_build
from cu2rec_torch.data.ratings import read_ratings_csv as t_read
from cu2rec_torch.models.state import model_from_numpy
from cu2rec_torch.train import trainer as tt
from cu2rec_torch.utils.config import Config as TConfig
from cu2rec_torch.utils.metrics import MetricsLogger as TLogger
from cu2rec_tpu.data import build_csr, read_ratings_csv
from cu2rec_tpu.models.state import MFModel, init_model, model_to_numpy
from cu2rec_tpu.train import trainer as jt
from cu2rec_tpu.utils.config import Config
from cu2rec_tpu.utils.metrics import MetricsLogger

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRAIN = str(ROOT / "data/ml100k_ratings_train.csv")
TEST = str(ROOT / "data/ml100k_ratings_test.csv")
CFG = dict(total_iterations=300, n_factors=16, check_error=50,
           learning_rate=0.1)


def _csrs(read, build):
    tr, te = read(TRAIN), read(TEST)
    nu, ni = max(tr.n_users, te.n_users), max(tr.n_items, te.n_items)
    return build(tr, nu, ni), build(te, nu, ni), tr.global_bias


@pytest.fixture(scope="module")
def data():
    jtr, jte, gb = _csrs(read_ratings_csv, build_csr)
    ttr, tte, tgb = _csrs(t_read, t_build)
    assert tgb == gb
    init = model_to_numpy(init_model(jtr.n_users, jtr.n_items, 16, gb,
                                     seed=42))
    return (jtr, jte), (ttr, tte), gb, init


def _history(logger):
    evals = [(r["iteration"], r["train_rmse"], r["train_mae"],
              r["test_rmse"], r["test_mae"]) for r in logger.history
             if r["event"] == "eval"]
    decays = [r["learning_rate"] for r in logger.history
              if r["event"] == "lr_decay"]
    return evals, decays


def _port_train(data, cfg, model=None, device="cpu"):
    _, (ttr, tte), gb, init = data
    logger = TLogger(verbose=False)
    model = model_from_numpy(init, device) if model is None else model
    out, losses = tt.train(ttr, tte, cfg, gb, model=model, logger=logger,
                           device=device)
    return out, losses, logger


@pytest.mark.parametrize("collision", ["first_wins", "twin"])
def test_training_tracks_the_tpu_package(data, collision):
    (jtr, jte), _, gb, init = data
    jlog = MetricsLogger(verbose=False)
    # A model of its own: the TPU package's step donates its buffers.
    j_init = jax.tree.map(jnp.asarray, init)
    jt.train(jtr, jte, Config(**CFG, collision_policy=collision), gb,
             model=MFModel(P=j_init["p"], Q=j_init["q"],
                           user_bias=j_init["user_bias"],
                           item_bias=j_init["item_bias"],
                           global_bias=j_init["global_bias"].reshape(())),
             logger=jlog)
    _, _, tlog = _port_train(data, TConfig(**CFG,
                                           collision_policy=collision))
    j_evals, j_decays = _history(jlog)
    t_evals, t_decays = _history(tlog)
    assert [e[0] for e in t_evals] == [1, 50, 100, 150, 200, 250, 300]
    assert [e[0] for e in t_evals] == [e[0] for e in j_evals]
    np.testing.assert_allclose(np.array(t_evals)[:, 1:],
                               np.array(j_evals)[:, 1:], rtol=0, atol=1e-4)
    assert len(j_decays) == 1
    np.testing.assert_allclose(t_decays, j_decays, rtol=1e-12)
    # The decay lands at the same eval point in both runs.
    j_lr = [r["learning_rate"] for r in jlog.history if r["event"] == "eval"]
    t_lr = [r["learning_rate"] for r in tlog.history if r["event"] == "eval"]
    np.testing.assert_allclose(t_lr, j_lr, rtol=1e-12)


def test_resume_from_cur_iterations_equals_unbroken_run(data, tmp_path):
    """150 iterations, a checkpoint, then 150 more from ``cur_iterations``
    give the tables of 300 unbroken iterations (patience is set out of
    reach so that the plateau state, which a checkpoint does not hold,
    plays no part)."""
    from cu2rec_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    cfg = dict(CFG, patience=100)
    whole, _, _ = _port_train(data, TConfig(**cfg))
    first = TConfig(**dict(cfg, total_iterations=150))
    half, _, _ = _port_train(data, first)
    assert first.cur_iterations == 150
    ck = save_checkpoint(str(tmp_path / "half"), half, first)
    model, resumed, _ = load_checkpoint(ck, device="cpu")
    resumed.total_iterations = 300
    assert resumed.cur_iterations == 150
    rest, losses, _ = _port_train(data, resumed, model=model)
    assert sorted(losses) == [200, 250, 300]
    for name in ("P", "Q", "user_bias", "item_bias"):
        assert torch.equal(getattr(rest, name), getattr(whole, name)), name


def test_completed_run_trains_nothing(data):
    cfg = TConfig(**dict(CFG, cur_iterations=300))
    model, losses, logger = _port_train(data, cfg)
    assert losses == {}
    assert [r["event"] for r in logger.history] == ["time"]
    np.testing.assert_array_equal(model.P.numpy(), data[3]["p"])


@pytest.mark.parametrize("total,check,start", [
    (300, 50, 0), (300, 50, 150), (5000, 500, 4500), (7, 3, 0), (1, 500, 0),
    (10, 500, 0), (300, 7, 5)])
def test_eval_segments_match(total, check, start):
    assert list(tt.eval_segments(total, check, start)) == \
        list(jt.eval_segments(total, check, start))


def test_train_eval_subsample_is_the_tpu_packages(data):
    (jtr, jte), (ttr, tte), _, _ = data
    cfg = dict(train_eval_sample=5000, test_eval_sample=1000)
    a = jt.SingleChipEngine(jtr, jte, Config(**CFG, **cfg))
    b = tt.SingleChipEngine(ttr, tte, TConfig(**CFG, **cfg), device="cpu")
    for split in ("train_eval_dev", "test_eval_dev"):
        ja, tb = getattr(a, split), getattr(b, split)
        assert tb.nnz == ja.nnz
        np.testing.assert_array_equal(tb.row_ids.numpy(),
                                      np.asarray(ja.row_ids)[:ja.nnz])
        np.testing.assert_array_equal(tb.indices.numpy(),
                                      np.asarray(ja.indices)[:ja.nnz])


@pytest.mark.parametrize("dtype,collision", [("bfloat16", "first_wins"),
                                             ("float32", "mean"),
                                             ("bfloat16", "sum")])
def test_bf16_and_collision_training_tracks_the_tpu_package(data, dtype,
                                                            collision):
    """The trainer with bf16 tables or the mean/sum policies, from the same
    initial tables (in the TPU package cast to bf16, in the port cast by
    the engine): the tables come out in the config's dtype and the test
    RMSE stays within 2e-3 of the TPU package's at each eval point."""
    (jtr, jte), _, gb, init = data
    cfg = dict(CFG, total_iterations=100, check_error=25,
               collision_policy=collision, dtype=dtype)
    jlog = MetricsLogger(verbose=False)
    j_init = jax.tree.map(lambda a: jnp.asarray(a).astype(
        jnp.dtype(dtype)), init)
    jt.train(jtr, jte, Config(**cfg), gb,
             model=MFModel(P=j_init["p"], Q=j_init["q"],
                           user_bias=j_init["user_bias"],
                           item_bias=j_init["item_bias"],
                           global_bias=jnp.asarray(
                               init["global_bias"]).reshape(())),
             logger=jlog)
    out, losses, tlog = _port_train(data, TConfig(**cfg))
    assert out.P.dtype == getattr(torch, dtype)
    j_evals, _ = _history(jlog)
    t_evals, _ = _history(tlog)
    assert [e[0] for e in t_evals] == [e[0] for e in j_evals]
    np.testing.assert_allclose(np.array(t_evals)[:, 1:],
                               np.array(j_evals)[:, 1:], rtol=0, atol=2e-3)
