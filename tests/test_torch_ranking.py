"""The port's ranking metrics against the TPU package's: recall@k and NDCG@k
on given lists (tolerance 1e-6, float32 sums), and ``ranking_eval`` and
the sampled ``auc_eval`` on a random model with continuous scores, so that
no tie decides a top-k order (1e-6: the same lists, sums in float32).
Within the port, the evals with a plan built once equal, bit for bit, the
evals without one, and a plan refuses an eval of other arguments."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cu2rec_torch.data.csr import csr_from_arrays as t_csr
from cu2rec_torch.models.state import MFModel, model_from_numpy
from cu2rec_torch.ops.bpr import auc_eval as t_auc
from cu2rec_torch.ops.bpr import prepare_auc
from cu2rec_torch.ops.topk import ndcg_at_k as t_ndcg
from cu2rec_torch.ops.topk import recall_at_k as t_recall
from cu2rec_torch.serve.recommend import prepare_ranking
from cu2rec_torch.serve.recommend import ranking_eval as t_ranking
from cu2rec_torch.serve.recommend import recall_at_k_eval as t_recall_eval
from cu2rec_tpu.data.csr import csr_from_arrays as j_csr
from cu2rec_tpu.models.state import MFModel as JModel
from cu2rec_tpu.ops.bpr import auc_eval as j_auc
from cu2rec_tpu.ops.topk import ndcg_at_k as j_ndcg
from cu2rec_tpu.ops.topk import recall_at_k as j_recall
from cu2rec_tpu.serve.recommend import ranking_eval as j_ranking

TOL = 1e-6


def _lists(seed=0, B=40, K=7, R=9, I=30):
    rng = np.random.default_rng(seed)
    rec = np.stack([rng.choice(I, K, replace=False) for _ in range(B)])
    rel = rng.integers(0, I, (B, R)).astype(np.int32)
    mask = rng.random((B, R)) < 0.5
    mask[:3] = False                 # users with no held-out item
    mask[3, :] = True
    return rec.astype(np.int32), rel, mask


@pytest.mark.parametrize("name", ["recall", "ndcg"])
@pytest.mark.parametrize("seed", [0, 1])
def test_list_metrics_match(name, seed):
    rec, rel, mask = _lists(seed)
    t_fn, j_fn = {"recall": (t_recall, j_recall),
                  "ndcg": (t_ndcg, j_ndcg)}[name]
    got = t_fn(torch.from_numpy(rec).long(), torch.from_numpy(rel).long(),
               torch.from_numpy(mask))
    want = np.asarray(j_fn(jnp.asarray(rec), jnp.asarray(rel),
                           jnp.asarray(mask)))
    assert got.dtype == torch.float32 and got.shape == (40,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert got[:3].tolist() == [0.0, 0.0, 0.0]


def _split_data(seed=0, U=120, I=70, n=2400):
    """Train and test CSRs of both packages over disjoint (user, item)
    pairs, and a random model of both packages."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(U * I, n, replace=False)
    u, i = (keys // I).astype(np.int32), (keys % I).astype(np.int32)
    r = np.ones(n, np.float32)
    test = rng.random(n) < 0.2
    csrs = {}
    for name, build in (("port", t_csr), ("jax", j_csr)):
        csrs[name] = (build(u[~test], i[~test], r[~test], U, I),
                      build(u[test], i[test], r[test], U, I))
    d = {"p": rng.normal(0, 0.5, (U, 8)).astype(np.float32),
         "q": rng.normal(0, 0.5, (I, 8)).astype(np.float32),
         "user_bias": np.zeros(U, np.float32),
         "item_bias": rng.normal(0, 0.3, I).astype(np.float32),
         "global_bias": np.zeros(1, np.float32)}
    j_model = JModel(P=jnp.asarray(d["p"]), Q=jnp.asarray(d["q"]),
                     user_bias=jnp.asarray(d["user_bias"]),
                     item_bias=jnp.asarray(d["item_bias"]),
                     global_bias=jnp.float32(0.0))
    return csrs, model_from_numpy(d, "cpu"), j_model


@pytest.mark.parametrize("k,batch,max_users", [(10, 1024, None),
                                               (5, 16, 50)])
def test_ranking_eval_matches(k, batch, max_users):
    csrs, t_model, j_model = _split_data()
    got = t_ranking(t_model, *csrs["port"], k=k, batch_size=batch,
                    max_users=max_users)
    want = j_ranking(j_model, *csrs["jax"], k=k, batch_size=batch,
                     max_users=max_users)
    assert got.keys() == want.keys() == {"recall", "ndcg"}
    for m in got:
        assert got[m] == pytest.approx(want[m], abs=TOL)
    assert got["recall"] > 0
    assert t_recall_eval(t_model, *csrs["port"], k=k, batch_size=batch,
                         max_users=max_users) == got["recall"]
    with pytest.raises(ValueError, match="unknown ranking metric"):
        t_ranking(t_model, *csrs["port"], metrics=("map",))


@pytest.mark.parametrize("n_pairs,seed", [(100_000, 0), (50, 3)])
def test_auc_eval_matches(n_pairs, seed):
    csrs, t_model, j_model = _split_data(seed=1)
    got = t_auc(t_model, *csrs["port"], n_pairs=n_pairs, seed=seed)
    want = j_auc(j_model, *csrs["jax"], n_pairs=n_pairs, seed=seed)
    assert got == pytest.approx(want, abs=TOL)
    assert 0.0 < got < 1.0


PLAN_CASES = [(10, 1024, None), (5, 16, 50), (3, 7, 30), (10, 1, 5)]


@pytest.mark.parametrize("k,batch,max_users", PLAN_CASES)
@pytest.mark.parametrize("seed", [0, 5])
def test_evals_with_a_plan_equal_evals_without(k, batch, max_users, seed):
    csrs, model, _ = _split_data(seed=seed)
    train, test = csrs["port"]
    rplan = prepare_ranking(train, test, batch, max_users, "cpu")
    aplan = prepare_auc(train, test, n_pairs=300, seed=seed, device="cpu")
    assert rplan.n_users == min(max_users or 10 ** 9,
                                int((np.diff(test.indptr) > 0).sum()))
    assert len(rplan.batches) == -(-rplan.n_users // batch)
    got = t_ranking(model, train, test, k=k, batch_size=batch,
                    max_users=max_users, plan=rplan)
    assert got == t_ranking(model, train, test, k=k, batch_size=batch,
                            max_users=max_users)
    assert t_auc(model, train, test, n_pairs=300, seed=seed, plan=aplan) \
        == t_auc(model, train, test, n_pairs=300, seed=seed)


@pytest.mark.parametrize("k,batch,max_users", PLAN_CASES)
def test_one_plan_over_changing_tables(k, batch, max_users):
    """A plan built once serves every eval of a run: three evals on tables
    that change between them equal three evals that build their own."""
    csrs, model, _ = _split_data(seed=2)
    train, test = csrs["port"]
    rplan = prepare_ranking(train, test, batch, max_users, "cpu")
    aplan = prepare_auc(train, test, seed=7, device="cpu")
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):
        model = MFModel(
            P=model.P + 0.3 * torch.randn(model.P.shape, generator=gen),
            Q=model.Q + 0.3 * torch.randn(model.Q.shape, generator=gen),
            user_bias=model.user_bias, item_bias=model.item_bias,
            global_bias=model.global_bias)
        assert t_ranking(model, train, test, k=k, batch_size=batch,
                         max_users=max_users, plan=rplan) \
            == t_ranking(model, train, test, k=k, batch_size=batch,
                         max_users=max_users)
        assert t_auc(model, train, test, seed=7, plan=aplan) \
            == t_auc(model, train, test, seed=7)


def test_plans_of_no_held_out_items():
    """No held-out item: a plan of no users (metrics 0.0) and of no pairs
    (AUC 0.5), as without one."""
    csrs, model, _ = _split_data()
    train, _ = csrs["port"]
    empty = t_csr(np.empty(0, np.int32), np.empty(0, np.int32),
                  np.empty(0, np.float32), train.n_users, train.n_items)
    rplan = prepare_ranking(train, empty, device="cpu")
    assert rplan.n_users == 0 and rplan.batches == ()
    assert t_ranking(model, train, empty, plan=rplan) \
        == {"recall": 0.0, "ndcg": 0.0}
    assert t_auc(model, train, empty,
                 plan=prepare_auc(train, empty, device="cpu")) == 0.5


@pytest.mark.parametrize("arg,value", [("n_pairs", 299), ("seed", 4),
                                       ("batch_size", 8), ("max_users", 31)])
def test_a_plan_refuses_an_eval_of_other_arguments(arg, value):
    """A plan holds what its arguments drew or batched: an eval asked for
    other pairs, another seed, batch size or user count raises."""
    csrs, model, _ = _split_data(seed=1)
    train, test = csrs["port"]
    rplan = prepare_ranking(train, test, 7, 30, "cpu")
    aplan = prepare_auc(train, test, n_pairs=300, seed=5, device="cpu")
    auc_kw = {"n_pairs": 300, "seed": 5}
    rank_kw = {"batch_size": 7, "max_users": 30}
    assert t_auc(model, train, test, plan=aplan, **auc_kw) \
        == t_auc(model, train, test, **auc_kw)
    assert t_ranking(model, train, test, plan=rplan, **rank_kw) \
        == t_ranking(model, train, test, **rank_kw)
    if arg in auc_kw:
        with pytest.raises(ValueError, match=f"{arg}={value}"):
            t_auc(model, train, test, plan=aplan, **{**auc_kw, arg: value})
    else:
        with pytest.raises(ValueError, match=f"{arg}={value}"):
            t_ranking(model, train, test, plan=rplan,
                      **{**rank_kw, arg: value})
