"""BPR-MF: Bayesian Personalized Ranking on the packed tables.

Pairwise ranking for implicit feedback (Rendle et al., UAI 2009).  Each
sampled triple (u, i⁺, j⁻) takes a gradient step on

    x_uij = p_u · (q_i − q_j) + b_i − b_j,     loss = −log σ(x_uij) + reg.

As in the TPU package's ``ops/bpr.py``, each side samples its own triples,
so every pass is a dense map over one table plus row gathers:

  * user pass: every user u samples i⁺ ~ rated(u) and j⁻ ~ Uniform(catalog)
    and updates its own row;
  * item-positive pass: every item y samples a rater u ~ raters(y) and a
    negative j⁻, and takes y's positive gradient;
  * item-negative pass: every item y samples a user v ~ Uniform(users) and
    v's positive i⁺ ~ rated(v), and takes y's negative gradient.

Every draw is a pure function of (seed, iteration, position) on the
counter stream of ``ops/sgd.py``, each stream separated by a threefry
``fold_in`` of the key, so the draws are bit-identical to the TPU
package's.  That package fetched the sampled ids through its TPU gather
layout (``gather_1d``, ``fetch_pairs``, ``pair_pack``); here they are plain
indexing.  The step has no Pallas original: on CPU tensors it is the
plain torch of ``bpr_step_reference``, on CUDA tensors kernel K6
(``ops/cuda_bpr.py``), which draws the same ids in registers.  Score:
p_u · q_y + b_y (user and global bias stay zero).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cu2rec_torch.ops.packed import PackedModel, _reg_vectors
from cu2rec_torch.ops.sgd import (
    Hyper, _take, counter_uniform, fold_in, sample_items, sample_positions,
)
from cu2rec_torch.utils.timing import count, span


def _uniform_ids(key, iteration, n_draws: int, n_range: int, tag: int,
                 offset: int = 0, device=None) -> torch.Tensor:
    """Counter-stream uniform ids in [0, n_range), one draw a position;
    ``tag`` separates the streams by folding into the key."""
    k = fold_in(key, tag)
    pos = torch.arange(n_draws, dtype=torch.int64, device=device) + offset
    u01 = counter_uniform(k, iteration, pos)
    n = torch.tensor(n_range, dtype=torch.int32, device=device)
    # A float32 product, truncated, as the TPU package computes it.
    return torch.minimum((u01 * n).to(torch.int32), n - 1).to(torch.int64)


class BPRDraws(NamedTuple):
    """Every id one BPR iteration samples (int64), and which draws are
    real (a row or item with ratings to sample from)."""

    i_pos: torch.Tensor   # (U,) each user's positive
    has_u: torch.Tensor
    j_neg: torch.Tensor   # (U,) each user's negative
    u_of_y: torch.Tensor  # (I,) each item's rater
    has_y: torch.Tensor
    jn_y: torch.Tensor    # (I,) each item's negative for its rater
    v: torch.Tensor       # (I,) each item's uniform user
    iv: torch.Tensor      # (I,) that user's positive
    has_v: torch.Tensor


def bpr_draws(dev, key, iteration: int) -> BPRDraws:
    """The sampled ids of iteration ``iteration`` from a ``DeviceRatings``
    built with ``item_major=True``."""
    if dev.it_indptr is None:
        raise ValueError("BPR needs item-major arrays: build DeviceRatings "
                         "with item_major=True")
    U, I = dev.n_users, dev.n_items
    d = dev.indptr.device
    i_pos, _r, has_u = sample_items(key, iteration, dev.indptr, dev.indices,
                                    dev.data)
    j_neg = _uniform_ids(key, iteration, U, I, tag=1, device=d)
    pos, has_y = sample_positions(key, iteration, dev.it_indptr,
                                  user_offset=U)
    if dev.it_order is not None:
        u_of_y = _take(dev.row_ids, _take(dev.it_order, pos).to(torch.int64))
    else:
        u_of_y = _take(dev.it_users, pos)
    jn_y = _uniform_ids(key, iteration, I, I, tag=2, offset=U, device=d)
    v = _uniform_ids(key, iteration, I, U, tag=3, offset=U + I, device=d)
    indptr = dev.indptr.to(torch.int64)
    start_v = indptr[:-1][v]
    len_v = (indptr[1:] - indptr[:-1]).to(torch.int32)[v]
    u01 = counter_uniform(fold_in(key, 4), iteration,
                          torch.arange(I, dtype=torch.int64, device=d)
                          + 2 * U)
    pos_v = start_v + torch.minimum((u01 * len_v).to(torch.int32),
                                    (len_v - 1).clamp(min=0))
    iv = _take(dev.indices, pos_v)
    return BPRDraws(i_pos, has_u, j_neg, u_of_y.to(torch.int64), has_y, jn_y,
                    v, iv.to(torch.int64), len_v > 0)


def bpr_step(pm: PackedModel, dev, hp: Hyper, key,
             iteration: int) -> PackedModel:
    """One BPR iteration: kernel K6 on CUDA tables (``ops/cuda_bpr.py``,
    one launch that draws the same ids), or raises; its plain version
    ``bpr_step_reference`` on CPU tables."""
    if pm.T_u.device.type == "cpu":
        return bpr_step_reference(pm, dev, hp, key, iteration)
    from cu2rec_torch.ops.cuda_bpr import bpr_step_cuda
    T_u, T_i = bpr_step_cuda(pm.T_u, pm.T_i, dev, hp, key, iteration,
                             n_factors=pm.n_factors)
    count("bpr.card_steps")
    return PackedModel(T_u=T_u, T_i=T_i, global_bias=pm.global_bias,
                       n_factors=pm.n_factors)


def bpr_step_reference(pm: PackedModel, dev, hp: Hyper, key,
                       iteration: int) -> PackedModel:
    """One BPR iteration in plain torch, on either device: the dense user
    pass and the dense (positive and negative) item pass, every read of
    the pre-step tables."""
    # Float32 arithmetic on float32 or bf16 tables, stored back in the
    # table dtype (bpr.py:74-82, 99, 136 there).
    dt = pm.T_u.dtype
    T_u, T_i = pm.T_u.to(torch.float32), pm.T_i.to(torch.float32)
    W = T_u.shape[1]
    F = pm.n_factors
    lr = hp.learning_rate
    with span("bpr.draws"):
        s = bpr_draws(dev, key, iteration)
    factor, biascol, reg_u, reg_i = _reg_vectors(hp, F, W, T_u.device)

    def ihat(rows):
        # factors kept, bias column → 1: ∂x/∂(row) for the side that owns
        # the bias term; padding columns → 0.
        return rows * factor + biascol

    # ---- user pass: u updates p_u from (i⁺ ~ rated(u), j⁻ ~ catalog) ----
    t_i = T_i[s.i_pos]                                      # (U, W)
    t_j = T_i[s.j_neg]
    diff = ihat(t_i) - ihat(t_j)       # bias columns cancel → factors only
    x_u = torch.sum(T_u * diff, dim=-1) + t_i[:, F] - t_j[:, F]
    e_u = torch.where(s.has_u, torch.sigmoid(-x_u), 0.0)
    du = lr * (e_u[:, None] * diff - reg_u * T_u)
    T_u_new = torch.where(s.has_u[:, None], T_u + du, T_u).to(dt)

    # ---- item-positive pass: y updates from (u ~ raters(y), j⁻) --------
    w_rows = T_u[s.u_of_y]                                  # (I, W)
    uhat = ihat(w_rows)
    t_jy = T_i[s.jn_y]
    x_pos = (torch.sum(w_rows * factor * (T_i - t_jy), dim=-1)
             + T_i[:, F] - t_jy[:, F])
    e_pos = torch.where(s.has_y, torch.sigmoid(-x_pos), 0.0)
    di_pos = lr * (e_pos[:, None] * uhat - reg_i * T_i)

    # ---- item-negative pass: y updates from (v ~ users, i⁺ ~ rated(v)) --
    v_rows = T_u[s.v]
    t_iv = T_i[s.iv]
    x_neg = (torch.sum(v_rows * factor * (t_iv - T_i), dim=-1)
             + t_iv[:, F] - T_i[:, F])
    e_neg = torch.where(s.has_v, torch.sigmoid(-x_neg), 0.0)
    di_neg = (-lr) * e_neg[:, None] * ihat(v_rows)   # reg applied in pos

    T_i_new = (T_i + torch.where(s.has_y[:, None], di_pos, 0.0)
               + torch.where(s.has_v[:, None], di_neg, 0.0)).to(dt)
    return PackedModel(T_u=T_u_new, T_i=T_i_new,
                       global_bias=pm.global_bias, n_factors=F)


def bpr_run_steps(pm: PackedModel, dev, hp: Hyper, key, start_iter: int,
                  n_steps: int) -> PackedModel:
    """``n_steps`` iterations from ``start_iter``, a host loop of steps."""
    count("bpr.steps", int(n_steps))
    with span("bpr.run_steps"):
        for i in range(int(n_steps)):
            pm = bpr_step(pm, dev, hp, key, int(start_iter) + i)
    return pm


class AUCPlan(NamedTuple):
    """The sampled AUC's pairs on the model's device: (n,) int64 user,
    held-out positive and uniform negative ids, drawn for ``n_pairs`` and
    ``seed``."""
    n_pairs: int
    seed: int
    users: torch.Tensor
    pos: torch.Tensor
    neg: torch.Tensor


def _auc_pairs(train_csr, test_csr, n_pairs, seed, device) -> AUCPlan:
    """The same NumPy draws as the TPU package (``n_pairs`` held-out
    ratings, then as many catalog negatives, from ``default_rng(seed)``),
    uploaded to ``device``."""
    if test_csr.nnz == 0:
        users = pos = neg = np.empty(0, np.int64)
    else:
        rng = np.random.default_rng(seed)
        sel = rng.integers(0, test_csr.nnz, size=min(n_pairs, test_csr.nnz))
        users = test_csr.row_ids[sel]
        pos = test_csr.indices[sel]
        neg = rng.integers(0, train_csr.n_items, size=len(sel))

    def ids(x):
        return torch.from_numpy(np.asarray(x, np.int64)).to(device)

    return AUCPlan(n_pairs=n_pairs, seed=seed, users=ids(users),
                   pos=ids(pos), neg=ids(neg))


def prepare_auc(train_csr, test_csr, n_pairs: int = 100_000, seed: int = 0,
                device=None) -> AUCPlan:
    """The pairs ``auc_eval`` scores, drawn once and held on ``device``."""
    count("eval.plans")
    with span("eval.plan"):
        return _auc_pairs(train_csr, test_csr, n_pairs, seed, device)


def auc_eval(model, train_csr, test_csr, n_pairs: int = 100_000,
             seed: int = 0, plan: AUCPlan | None = None) -> float:
    """Sampled pairwise AUC: P(score(u, i⁺) > score(u, j)) over held-out
    positives i⁺ and uniform catalog negatives j, the same NumPy draws as
    the TPU package; scored on the model's device, read back once.
    ``plan`` (``prepare_auc`` of the same CSRs, ``n_pairs`` and ``seed``)
    holds the pairs on that device; without one they are drawn here."""
    if plan is None:
        plan = _auc_pairs(train_csr, test_csr, n_pairs, seed, model.device)
    elif (plan.n_pairs, plan.seed) != (n_pairs, seed):
        raise ValueError(
            f"plan of n_pairs={plan.n_pairs}, seed={plan.seed} given to an "
            f"eval of n_pairs={n_pairs}, seed={seed}")
    if len(plan.users) == 0:
        return 0.5
    P = model.P.to(torch.float32)
    Q = model.Q.to(torch.float32)
    ib = model.item_bias.to(torch.float32)
    pu = P[plan.users]
    s_pos = torch.sum(pu * Q[plan.pos], dim=-1) + ib[plan.pos]
    s_neg = torch.sum(pu * Q[plan.neg], dim=-1) + ib[plan.neg]
    return float(torch.mean((s_pos > s_neg).to(torch.float32)))
