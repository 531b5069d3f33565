"""Top-K recommendation ops.

Replaces the reference's CPU ``std::sort`` over all items
(predict.cu:49-63) with masked ``torch.topk`` on the device.  Rated items
are excluded by a scatter-min to the ``NEG_INF`` sentinel.  ``recall_at_k``
and ``ndcg_at_k`` score a top-k list against held-out items.
"""

from __future__ import annotations

import numpy as np
import torch

# The mask sentinel; callers drop entries whose score is below -1e30.
NEG_INF = np.float32(-3.0e38)
_POS_HUGE = 3.0e38


def mask_rated(scores: torch.Tensor, rated_items: torch.Tensor,
               rated_mask: torch.Tensor) -> torch.Tensor:
    """Set scores of rated items to ``NEG_INF``.

    ``scores`` (B, I); ``rated_items`` (B, R) padded item ids with validity
    ``rated_mask`` (B, R).  Padding entries write +huge, which the min
    turns into a no-op, so a repeated id is harmless."""
    cols = torch.where(rated_mask, rated_items, 0).to(torch.int64)
    src = torch.where(rated_mask, float(NEG_INF), _POS_HUGE).to(scores.dtype)
    return scores.scatter_reduce(1, cols, src, reduce="amin")


def topk_scores(scores: torch.Tensor, k: int):
    """(values, item_ids) of the top-k per row."""
    return torch.topk(scores, k, dim=-1)


def _hits(recommended, relevant_items, relevant_mask) -> torch.Tensor:
    """(B, K, R): recommendation k is held-out item r."""
    hits = recommended[:, :, None] == relevant_items[:, None, :]
    return hits & relevant_mask[:, None, :]


def recall_at_k(recommended: torch.Tensor, relevant_items: torch.Tensor,
                relevant_mask: torch.Tensor) -> torch.Tensor:
    """Per-user recall@k.

    ``recommended`` (B, K) item ids; ``relevant_items`` (B, R) padded
    held-out item ids with validity ``relevant_mask``."""
    hits = _hits(recommended, relevant_items, relevant_mask)
    n_hit = torch.sum(torch.any(hits, dim=1), dim=-1)
    n_rel = torch.clamp(torch.sum(relevant_mask, dim=-1), min=1)
    return n_hit / n_rel


def ndcg_at_k(recommended: torch.Tensor, relevant_items: torch.Tensor,
              relevant_mask: torch.Tensor) -> torch.Tensor:
    """Per-user binary-relevance NDCG@k: DCG = Σ_j rel_j / log2(j+2) over
    the recommendation list, over the ideal DCG for the user's held-out
    count (clipped at k).  Users with no held-out items score 0."""
    hits = _hits(recommended, relevant_items, relevant_mask)
    rel = torch.any(hits, dim=-1).to(torch.float32)            # (B, K)
    K = recommended.shape[1]
    pos = torch.arange(K, dtype=torch.float32, device=recommended.device)
    disc = 1.0 / torch.log2(pos + 2.0)
    dcg = torch.sum(rel * disc, dim=-1)
    n_rel = torch.sum(relevant_mask, dim=-1)                   # (B,)
    ideal = torch.sum(torch.where(pos[None, :] < n_rel[:, None],
                                  disc[None, :], 0.0), dim=-1)
    return torch.where(ideal > 0, dcg / torch.clamp(ideal, min=1e-9), 0.0)
