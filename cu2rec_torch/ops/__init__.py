from cu2rec_torch.ops.loss import (
    error_sums, evaluate, metrics_from_errors, pairwise_errors,
)
from cu2rec_torch.ops.model import predict_pairs, score_catalog
from cu2rec_torch.ops.sgd import (
    Hyper, apply_item_deltas, elect_winners, rotated_priority, sample_items,
    sgd_step, win_mask,
)
from cu2rec_torch.ops.topk import mask_rated, ndcg_at_k, recall_at_k, \
    topk_scores

__all__ = [
    "Hyper", "sample_items", "elect_winners", "win_mask", "sgd_step",
    "apply_item_deltas", "rotated_priority", "evaluate", "pairwise_errors",
    "error_sums", "metrics_from_errors", "predict_pairs", "score_catalog",
    "topk_scores", "mask_rated", "recall_at_k", "ndcg_at_k",
]
