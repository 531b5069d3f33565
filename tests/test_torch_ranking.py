"""The port's ranking metrics against the TPU package's: recall@k and NDCG@k
on given lists (tolerance 1e-6, float32 sums), and ``ranking_eval`` and
the sampled ``auc_eval`` on a random model with continuous scores, so that
no tie decides a top-k order (1e-6: the same lists, sums in float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cu2rec_torch.data.csr import csr_from_arrays as t_csr
from cu2rec_torch.models.state import model_from_numpy
from cu2rec_torch.ops.bpr import auc_eval as t_auc
from cu2rec_torch.ops.topk import ndcg_at_k as t_ndcg
from cu2rec_torch.ops.topk import recall_at_k as t_recall
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
