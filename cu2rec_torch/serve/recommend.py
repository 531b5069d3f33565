"""Serving helpers: full-catalog scoring and ranked recommendations.

Replaces the reference's CPU scoring + ``std::sort`` serving path
(predict.cu:17-29, 49-70): scoring a block of users against the whole
catalog is one ``P_u @ Q.T``, and rated items are masked by a scatter-min
before ``torch.topk``.
"""

from __future__ import annotations

import numpy as np
import torch

from cu2rec_torch.models.state import MFModel
from cu2rec_torch.ops.model import score_catalog
from cu2rec_torch.ops.topk import mask_rated


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
