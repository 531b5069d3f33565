"""Plain reference of the serving cell: what a served biased-MF model must
answer.  Plain torch, float64, on any device; it imports nothing of the
port.

* ``recommend`` of a known user u: the k items of highest score
  ``μ + b_u + b_i + p_u·q_i`` among the items u has not rated in train.
* explicit ``fold_in`` of a new user (cu2rec's ``predict``, sgd.cu with
  the items frozen): the user's row [p | b] starts from Normal(0, 1/F)
  and takes ``iterations`` SGD steps; at step t it draws one of its rated
  items, position ``min(trunc(u01·n), n − 1)`` with u01 the counter hash
  of (key, t, slot), and moves towards it:
  ``p += lr(e q − λ_P p)``, ``b += lr(e − λ_b b)``, ``e = r − μ − b − b_i
  − p·q``.  The draw keys on the request's slot in its batch, and the
  first row on the same slot (a CPU ``torch.Generator`` seeded with the
  key, 16 values drawn a slot), so the reference computes the fold-in of
  every slot the request could have held.  Then the top k of the unrated
  items.
* implicit ``fold_in`` (iALS): the row x solving
  ``(YᵀY + Σ α r q qᵀ + λ I) x = Σ (1 + α r) q`` over the rated items,
  scored as ``μ + b_i + x·q`` (no user bias) over the unrated items.

A response is judged by its items and scores: ``score_gap``, the widest
difference between a returned score and the reference's score of that
item; ``rank_gap``, the widest distance by which the reference's score of
a returned item lies below the reference's k-th best, or a returned score
above the one before it (0 when the items are the reference's top k in
the answer's own order; a rated item returned reads ``MISSING``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.mf_sgd import uniform

MISSING = 1e30


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 bits of mantissa), as float64."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    bias = 0xFFF + ((b >> 13) & 1)
    return ((b + bias) & ~0x1FFF).view(torch.float32).to(torch.float64)


def scores(p, ub, Q, ib, mu: float, tf32_inputs: bool = False):
    """(B, I) scores of user rows ``p`` (B, F) with biases ``ub`` (B,)."""
    if tf32_inputs:
        p, Q = tf32(p), tf32(Q)
    return mu + ub[:, None] + ib[None, :] + p @ Q.T


def judge(s: torch.Tensor, excluded, items, got) -> tuple[float, float]:
    """(score_gap, rank_gap) of one response, judged by the row of ``s``
    (S, I), the reference's scores of each candidate user row, that fits
    it best: ``excluded`` the ids it may not return, ``items`` and ``got``
    the response's ids and scores.  ``rank_gap`` is the widest distance by
    which a returned item's reference score lies below the reference's
    k-th best, or by which a returned score exceeds the one before it."""
    s = s.clone()
    if len(excluded):
        s[:, torch.as_tensor(excluded, device=s.device,
                             dtype=torch.int64)] = -math.inf
    k = len(items)
    kth = torch.topk(s, k, dim=1).values[:, -1:]
    it = torch.as_tensor(items, device=s.device, dtype=torch.int64)
    mine = s[:, it]                                     # (S, k)
    if not bool(torch.isfinite(mine).all()):
        return MISSING, MISSING
    got = torch.as_tensor(got, device=s.device, dtype=torch.float64)
    score = (got[None, :] - mine).abs().amax(1)
    order = float((got[1:] - got[:-1]).clamp(min=0).max()) if k > 1 else 0.0
    rank = (kth - mine).clamp(min=0).amax(1).clamp(min=order)
    b = int(torch.argmin(score + rank))
    return float(score[b]), float(rank[b])


def init_rows(seed_key, n_slots: int, F: int) -> torch.Tensor:
    """The fold-in's first rows [p | b] of slots 0..n_slots-1: Normal
    draws of a CPU generator seeded with the 64-bit key, 16 values a
    block, divided by F."""
    k0, k1 = seed_key
    gen = torch.Generator().manual_seed((k0 << 32) | k1)
    draw = torch.randn((n_slots, -(-(F + 1) // 16) * 16), generator=gen)
    return draw[:, :F + 1].to(torch.float64) / F


def explicit_rows(Q, ib, mu: float, items, ratings, seed_key,
                  iterations: int, hp: dict, n_slots: int, device):
    """The fold-in's rows [p | b] (n_slots, F + 1) of one request for
    every slot it could have held."""
    F = Q.shape[1]
    rows = init_rows(seed_key, n_slots, F).to(device)
    it = torch.as_tensor(items, dtype=torch.int64, device=device)
    r = torch.as_tensor(ratings, dtype=torch.float32,
                        device=device).to(torch.float64)
    n = it.shape[0]
    slots = torch.arange(n_slots, device=device)
    q_all, bi_all = Q[it], ib[it]
    for t in range(iterations):
        u01 = uniform(seed_key[1], t, slots)
        pos = torch.minimum((u01 * n).to(torch.int64),
                            torch.tensor(n - 1, device=device))
        q, bi, rr = q_all[pos], bi_all[pos], r[pos]
        p, b = rows[:, :F], rows[:, F]
        e = rr - (mu + b + bi + (p * q).sum(1))
        p = p + hp["lr"] * (e[:, None] * q - hp["P_reg"] * p)
        b = b + hp["lr"] * (e - hp["ub_reg"] * b)
        rows = torch.cat([p, b[:, None]], 1)
    return rows


def implicit_row(Q, items, strengths, alpha: float, reg: float,
                 tf32_inputs: bool = False):
    """The iALS fold-in's row x (F,) of one request."""
    F = Q.shape[1]
    Y = tf32(Q) if tf32_inputs else Q
    it = torch.as_tensor(items, dtype=torch.int64, device=Q.device)
    c = alpha * torch.as_tensor(strengths, dtype=torch.float32,
                                device=Q.device).to(torch.float64)
    q = Y[it]
    G = Y.T @ Y + (q * c[:, None]).T @ q \
        + reg * torch.eye(F, dtype=torch.float64, device=Q.device)
    rhs = ((1.0 + c)[:, None] * q).sum(0)
    return torch.linalg.solve(G, rhs)


def rated_of(indptr: np.ndarray, indices: np.ndarray, u: int) -> np.ndarray:
    return indices[indptr[u]:indptr[u + 1]]
