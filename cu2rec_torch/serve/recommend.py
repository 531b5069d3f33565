"""Serving helpers: full-catalog scoring, ranked recommendations, and the
ranking eval (recall@k, NDCG@k).

Replaces the reference's CPU scoring + ``std::sort`` serving path
(predict.cu:17-29, 49-70): scoring a block of users against the whole
catalog is one ``P_u @ Q.T``, and rated items are masked by a scatter-min
before ``torch.topk``.  ``ranking_eval`` is the implicit trainers' metric,
its users and their lists built once a run (``prepare_ranking``);
``foldin_ranking_eval`` scores the serving engine's fold-in the same way.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cu2rec_torch.models.state import MFModel
from cu2rec_torch.ops.model import score_catalog
from cu2rec_torch.ops.topk import mask_rated, ndcg_at_k, recall_at_k
from cu2rec_torch.utils.timing import count, span


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


class RankingBatch(NamedTuple):
    """One batch of ``ranking_eval``'s users on the model's device."""
    users: torch.Tensor          # (B,) int64 user ids
    rated: torch.Tensor          # (B, R) int32 padded train items, masked
    rated_mask: torch.Tensor     # (B, R) bool
    relevant: torch.Tensor       # (B, R') int64 padded held-out items
    relevant_mask: torch.Tensor  # (B, R') bool


class RankingPlan(NamedTuple):
    """``ranking_eval``'s users and their lists, built once
    (``prepare_ranking``) for the ``batch_size`` and ``max_users`` kept."""
    batch_size: int
    max_users: int | None
    n_users: int
    batches: tuple[RankingBatch, ...]


def _ranked_users(test_csr, max_users):
    """The first ``max_users`` users with held-out items."""
    users = np.nonzero(np.diff(test_csr.indptr) > 0)[0]
    return users[:max_users] if max_users else users


def _ranking_batches(train_csr, test_csr, users, batch_size, device):
    """Each ``batch_size`` of ``users`` with its train lists (to mask) and
    held-out lists, padded to the batch's longest and uploaded to
    ``device`` as the batch is reached."""
    def put(x):
        return torch.from_numpy(x).to(device)

    for b0 in range(0, len(users), batch_size):
        batch = users[b0:b0 + batch_size]
        rated, rmask = padded_user_lists(train_csr, batch)
        rel, relmask = padded_user_lists(test_csr, batch)
        yield RankingBatch(users=put(batch.astype(np.int64)), rated=put(rated),
                           rated_mask=put(rmask),
                           relevant=put(rel.astype(np.int64)),
                           relevant_mask=put(relmask))


def prepare_ranking(train_csr, test_csr, batch_size: int = 1024,
                    max_users: int | None = None, device=None) -> RankingPlan:
    """Every batch that ``ranking_eval`` reads of the CSRs, uploaded once
    to ``device`` and held there."""
    count("eval.plans")
    with span("eval.plan"):
        users = _ranked_users(test_csr, max_users)
        return RankingPlan(
            batch_size=batch_size, max_users=max_users, n_users=len(users),
            batches=tuple(_ranking_batches(train_csr, test_csr, users,
                                           batch_size, device)))


def ranking_eval(model: MFModel, train_csr, test_csr, k: int = 10,
                 batch_size: int = 1024, max_users: int | None = None,
                 metrics: tuple = ("recall", "ndcg"),
                 plan: RankingPlan | None = None) -> dict:
    """Mean top-k ranking metrics over test users (the first ``max_users``
    with held-out items): recommend k items unrated in train, score them
    against the held-out test items.  Returns ``{metric: mean}`` for
    ``recall`` (hit fraction) and/or ``ndcg`` (binary relevance).

    ``plan`` (``prepare_ranking`` of the same CSRs, ``batch_size`` and
    ``max_users``) holds the batches on the model's device; without one
    each batch is built and uploaded as it is reached, so one batch's
    lists are on the device at a time.  Each batch's sums stay on the
    device until one read at the end, and are added on the host in batch
    order."""
    fns = {"recall": recall_at_k, "ndcg": ndcg_at_k}
    unknown = set(metrics) - fns.keys()
    if unknown:
        raise ValueError(f"unknown ranking metric(s): {sorted(unknown)}")
    if plan is None:
        users = _ranked_users(test_csr, max_users)
        n_users = len(users)
        batches = _ranking_batches(train_csr, test_csr, users, batch_size,
                                   model.device)
    elif (plan.batch_size, plan.max_users) != (batch_size, max_users):
        raise ValueError(
            f"plan of batch_size={plan.batch_size}, max_users="
            f"{plan.max_users} given to an eval of batch_size={batch_size}, "
            f"max_users={max_users}")
    else:
        n_users, batches = plan.n_users, plan.batches
    if n_users == 0 or not metrics:
        return {m: 0.0 for m in metrics}
    sums = []
    for b in batches:
        _, rec = _topk_users(model.P[b.users], model.user_bias[b.users],
                             model.Q, model.item_bias, model.global_bias,
                             b.rated, b.rated_mask, k)
        sums.append(torch.stack([
            torch.sum(fns[m](rec, b.relevant, b.relevant_mask))
            for m in metrics]))
    totals = {m: 0.0 for m in metrics}
    for row in torch.stack(sums).tolist():
        for m, v in zip(metrics, row):
            totals[m] += v
    return {m: totals[m] / n_users for m in metrics}


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
