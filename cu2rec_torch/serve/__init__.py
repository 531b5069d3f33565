from cu2rec_torch.serve.foldin import fold_in_user
from cu2rec_torch.serve.recommend import (
    foldin_ranking_eval, padded_user_lists, predict_all_items, ranked_items,
    ranking_eval, recall_at_k_eval, recommend_users,
)

__all__ = ["fold_in_user", "predict_all_items", "recommend_users",
           "ranked_items", "recall_at_k_eval", "ranking_eval",
           "foldin_ranking_eval", "padded_user_lists"]
