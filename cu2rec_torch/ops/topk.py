"""Top-K recommendation ops.

Replaces the reference's CPU ``std::sort`` over all items
(predict.cu:49-63) with masked ``torch.topk`` on the device.  Rated items
are excluded by a scatter-min to the ``NEG_INF`` sentinel.
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
