"""Serving helpers: full-catalog scoring, ranked recommendations, and the
ranking eval (recall@k, NDCG@k).

Replaces the reference's CPU scoring + ``std::sort`` serving path
(predict.cu:17-29, 49-70): scoring a block of users against the whole
catalog is one ``P_u @ Q.T``, and rated items are masked by a scatter-min
before ``torch.topk``.  ``ranking_eval`` is the implicit trainers' metric;
``foldin_ranking_eval`` scores the serving engine's fold-in the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from cu2rec_torch.models.state import MFModel
from cu2rec_torch.ops.model import score_catalog
from cu2rec_torch.ops.topk import mask_rated, ndcg_at_k, recall_at_k


def predict_all_items(p_row, user_bias, Q, item_bias, global_bias):
    """Scores for every item for one user (predict_ratings equivalent,
    predict.cu:17-29)."""
    scores = score_catalog(p_row.reshape(1, -1), user_bias.reshape(1),
                           Q, item_bias, global_bias)
    return scores[0]


def _topk_users(P_rows, ub_rows, Q, item_bias, global_bias,
                rated_items, rated_mask, k: int):
    scores = score_catalog(P_rows, ub_rows, Q, item_bias, global_bias)
    scores = mask_rated(scores, rated_items, rated_mask)
    return torch.topk(scores, k, dim=-1)


def recommend_users(model: MFModel, user_ids, rated_items, rated_mask,
                    k: int = 10):
    """Top-k unrated items for a batch of users.

    ``rated_items``/``rated_mask``: (B, R) padded already-rated item ids.
    Returns (scores (B,k), item_ids (B,k)) on the model's device.  If a user
    has fewer than k unrated items, the surplus entries carry sentinel
    scores < -1e30 and should be discarded by the caller.
    """
    dev = model.device
    uids = torch.as_tensor(np.asarray(user_ids), device=dev).to(torch.int64)
    rated = torch.as_tensor(np.asarray(rated_items), device=dev)
    rmask = torch.as_tensor(np.asarray(rated_mask), device=dev)
    return _topk_users(model.P[uids], model.user_bias[uids], model.Q,
                       model.item_bias, model.global_bias,
                       rated.to(torch.int64), rmask.to(torch.bool), k)


def ranked_items(scores) -> list[tuple[float, int]]:
    """All items sorted by descending score — the
    ``get_recommendations`` output shape (predict.cu:49-63)."""
    if isinstance(scores, torch.Tensor):
        scores = scores.detach().cpu().numpy()
    scores = np.asarray(scores)
    order = np.argsort(-scores, kind="stable")
    return [(float(scores[i]), int(i)) for i in order]


def padded_user_lists(csr, user_ids, pad_to: int | None = None):
    """(items (B,R), mask (B,R)) of each user's rated items from a CSR."""
    slices = [csr.indices[csr.indptr[u]:csr.indptr[u + 1]] for u in user_ids]
    R = pad_to or max((len(s) for s in slices), default=1) or 1
    items = np.zeros((len(user_ids), R), dtype=np.int32)
    mask = np.zeros((len(user_ids), R), dtype=bool)
    for b, s in enumerate(slices):
        items[b, :len(s)] = s[:R]
        mask[b, :len(s)] = True
    return items, mask


def ranking_eval(model: MFModel, train_csr, test_csr, k: int = 10,
                 batch_size: int = 1024, max_users: int | None = None,
                 metrics: tuple = ("recall", "ndcg")) -> dict:
    """Mean top-k ranking metrics over test users (the first ``max_users``
    with held-out items): recommend k items unrated in train, score them
    against the held-out test items.  Returns ``{metric: mean}`` for
    ``recall`` (hit fraction) and/or ``ndcg`` (binary relevance)."""
    fns = {"recall": recall_at_k, "ndcg": ndcg_at_k}
    unknown = set(metrics) - fns.keys()
    if unknown:
        raise ValueError(f"unknown ranking metric(s): {sorted(unknown)}")
    users = np.nonzero(np.diff(test_csr.indptr) > 0)[0]
    if max_users:
        users = users[:max_users]
    if len(users) == 0:
        return {m: 0.0 for m in metrics}
    dev = model.device
    totals = {m: 0.0 for m in metrics}
    for b0 in range(0, len(users), batch_size):
        batch = users[b0:b0 + batch_size]
        rated, rmask = padded_user_lists(train_csr, batch)
        _, rec = recommend_users(model, batch, rated, rmask, k)
        rel, relmask = padded_user_lists(test_csr, batch)
        rel = torch.from_numpy(rel).to(dev, torch.int64)
        relmask = torch.from_numpy(relmask).to(dev)
        for m in metrics:
            totals[m] += float(torch.sum(fns[m](rec, rel, relmask)))
    return {m: totals[m] / len(users) for m in metrics}


def recall_at_k_eval(model: MFModel, train_csr, test_csr, k: int = 10,
                     batch_size: int = 1024, max_users: int | None = None):
    """Mean recall@k over test users (see :func:`ranking_eval`)."""
    return ranking_eval(model, train_csr, test_csr, k, batch_size,
                        max_users, metrics=("recall",))["recall"]


def foldin_ranking_eval(engine, input_csr, holdout_csr, cfg=None,
                        k: int = 10, batch_size: int = 256,
                        max_users: int | None = None,
                        metrics: tuple = ("recall", "ndcg"),
                        mode: str = "sgd", alpha: float = 40.0,
                        reg: float = 0.1) -> dict:
    """Fold-in quality: for each user with ratings in BOTH splits, learn a
    fresh (p_row, user_bias) from the ``input_csr`` ratings alone through
    the engine's batched fold-in (frozen catalog, predict.cu:126-132
    semantics), recommend k items with only the INPUT items masked, and
    score recall@k / ndcg@k against the user's ``holdout_csr`` items.

    ``engine`` is a ``ServingEngine`` or an item-sharded
    ``ShardedServingEngine``; ``cfg`` configures the fold-in
    partial fit (iterations, lr).  ``mode="implicit"`` takes the one-shot
    exact iALS ridge fold-in (``fold_in_implicit`` with ``alpha``/``reg``,
    kernel K1 on the card) instead of the explicit SGD partial fit; the
    input values then act as confidence strengths, not ratings.  Returns
    ``{metric: mean, "n_users": count}``.
    """
    fns = {"recall": recall_at_k, "ndcg": ndcg_at_k}
    unknown = set(metrics) - fns.keys()
    if unknown:
        raise ValueError(f"unknown ranking metric(s): {sorted(unknown)}")
    if mode not in ("sgd", "implicit"):
        raise ValueError(f"unknown fold-in mode: {mode!r}")
    n_in = np.diff(input_csr.indptr)
    n_out = np.diff(holdout_csr.indptr)
    users = np.nonzero((n_in > 0) & (n_out > 0))[0]
    if max_users:
        users = users[:max_users]
    if len(users) == 0:
        return {**{m: 0.0 for m in metrics}, "n_users": 0}
    dev = engine.device
    totals = {m: 0.0 for m in metrics}
    for b0 in range(0, len(users), batch_size):
        batch = users[b0:b0 + batch_size]
        rated, rmask = padded_user_lists(input_csr, batch)
        vals = np.zeros_like(rated, dtype=np.float32)
        for b, u in enumerate(batch):
            lo, hi = input_csr.indptr[u], input_csr.indptr[u + 1]
            vals[b, :hi - lo] = input_csr.data[lo:hi]
        if mode == "implicit":
            p_rows, ub = engine.fold_in_implicit(rated, vals, rmask,
                                                 alpha=alpha, reg=reg)
        else:
            p_rows, ub = engine.fold_in(rated, vals, rmask, cfg=cfg)
        _, rec = engine.recommend(p_rows, ub, rated, rmask, k=k)
        rel, relmask = padded_user_lists(holdout_csr, batch)
        rec = torch.from_numpy(np.asarray(rec)).to(dev, torch.int64)
        rel = torch.from_numpy(rel).to(dev, torch.int64)
        relmask = torch.from_numpy(relmask).to(dev)
        for m in metrics:
            totals[m] += float(torch.sum(fns[m](rec, rel, relmask)))
    return {**{m: totals[m] / len(users) for m in metrics},
            "n_users": int(len(users))}
