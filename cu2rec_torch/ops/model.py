"""Prediction ops.

``get_prediction`` (reference util.cu:199-204) generalized to batches: the
full-catalog score of a block of users is one matrix product ``P_u @ Q.T``
plus broadcast biases — replacing predict.cu's CPU scoring loop
(predict.cu:17-29).
"""

from __future__ import annotations

import torch


def predict_pairs(P, Q, user_bias, item_bias, global_bias, users, items):
    """r̂ for (user, item) pairs."""
    return (global_bias + user_bias[users] + item_bias[items]
            + torch.sum(P[users] * Q[items], dim=-1))


def score_catalog(p_rows, ub_rows, Q, item_bias, global_bias):
    """Full-catalog scores for a block of users: (B, I), in float32.

    ``p_rows`` (B, F), ``ub_rows`` (B,).
    """
    scores = torch.matmul(p_rows.to(torch.float32), Q.to(torch.float32).T)
    return (scores + global_bias + ub_rows[:, None]
            + item_bias[None, :].to(torch.float32))
