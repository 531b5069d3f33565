"""Pure-NumPy reference trainers for numerical cross-checks.

Two twins:

* :func:`reference_step` — the exact mathematical twin of one
  vectorized SGD step (``ops/sgd.py``, ``ops/packed.py``) given the *same*
  sampled batch, for checks of the step to float tolerance.  The reference
  CUDA code could not be tested this way — its races made exact values
  unreproducible (test_sgd.cu:132-133 only asserts "no NaNs");
  determinism-by-construction is what makes this twin possible.

* :func:`sequential_train` — capability twin of the reference's CPU
  baseline binary ``mf_sequential.cu`` ("works and behaves the same way,
  just does everything in CPU", mf_sequential.cu:1-2): per iteration, each
  user in order samples one random item and updates all four components *in
  place* (updates visible to later users within the same iteration, no
  collision election — sequential execution has no collisions).  Powers the
  ``mf_cpu`` CLI.
"""

from __future__ import annotations

import numpy as np

from cu2rec_torch.data.csr import CSRRatings


def reference_step(P, Q, ub, ib, mu, items, ratings, has, prio,
                   lr, P_reg, Q_reg, ub_reg, ib_reg,
                   *, train_items=True, collision="first_wins"):
    """NumPy twin of one vectorized SGD iteration. All inputs numpy."""
    P = P.copy(); Q = Q.copy(); ub = ub.copy(); ib = ib.copy()
    n_users, _ = P.shape
    n_items = Q.shape[0]

    q = Q[items]
    ib_g = ib[items]
    pred = mu + ub + ib_g + np.sum(P * q, axis=-1)
    err = np.where(has, ratings - pred, 0.0).astype(np.float32)

    # winner election: min priority per item
    best = np.full(n_items, np.iinfo(np.int32).max, dtype=np.int64)
    cand = np.where(has, prio, np.iinfo(np.int32).max)
    np.minimum.at(best, items, cand)
    win = has & (best[items] == cand)

    P_new = np.where(has[:, None], P + lr * (err[:, None] * q - P_reg * P), P)
    ub_new = np.where(has, ub + lr * (err - ub_reg * ub), ub)

    if train_items:
        dq = lr * (err[:, None] * P - Q_reg * q)
        dib = lr * (err - ib_reg * ib_g)
        if collision == "first_wins":
            dq = np.where(win[:, None], dq, 0.0)
            dib = np.where(win, dib, 0.0)
        elif collision == "mean":
            counts = np.zeros(n_items, dtype=np.float32)
            np.add.at(counts, items, has.astype(np.float32))
            denom = np.maximum(counts, 1.0)[items]
            dq = np.where(has[:, None], dq / denom[:, None], 0.0)
            dib = np.where(has, dib / denom, 0.0)
        np.add.at(Q, items, dq.astype(np.float32))
        np.add.at(ib, items, dib.astype(np.float32))

    return P_new.astype(np.float32), Q, ub_new.astype(np.float32), ib


def sequential_train(train_csr: CSRRatings, test_csr: CSRRatings, cfg,
                     global_bias: float, seed: int | None = None,
                     verbose: bool = True):
    """Sequential CPU trainer (mf_sequential.cu twin).

    Differences preserved deliberately: no LR plateau decay (the reference's
    plateau logic lives only in the GPU loop, training.cu:100-155 vs
    mf_sequential.cu) and in-place sequential updates.  Unlike
    mf_sequential.cu:109-112 (a fresh nondeterministically-seeded mt19937
    per update), sampling here is seeded and reproducible.
    """
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    F = cfg.n_factors
    U, I = train_csr.n_users, train_csr.n_items
    init = lambda *shape: rng.normal(0.0, 1.0 / F, size=shape).astype(np.float32)
    P, Q = init(U, F), init(I, F)
    ub, ib = init(U), init(I)
    lr = cfg.learning_rate
    losses = {}

    indptr, indices, data = (train_csr.indptr, train_csr.indices,
                             train_csr.data)

    def eval_split(csr):
        rows = csr.row_ids
        pred = (global_bias + ub[rows] + ib[csr.indices]
                + np.sum(P[rows] * Q[csr.indices], axis=-1))
        err = csr.data - pred
        n = max(len(err), 1)
        return (float(np.sqrt(np.sum(err * err) / n)),
                float(np.sum(np.abs(err)) / n))

    for i in range(cfg.total_iterations):
        for u in range(U):
            lo, hi = indptr[u], indptr[u + 1]
            if lo == hi:
                continue
            j = rng.integers(lo, hi)
            y = indices[j]
            e = (data[j] - (global_bias + ub[u] + ib[y] + P[u] @ Q[y]))
            p_old = P[u].copy()
            q_old = Q[y].copy()
            P[u] = p_old + lr * (e * q_old - cfg.P_reg * p_old)
            Q[y] = q_old + lr * (e * p_old - cfg.Q_reg * q_old)
            ub[u] += lr * (e - cfg.user_bias_reg * ub[u])
            ib[y] += lr * (e - cfg.item_bias_reg * ib[y])
        if (i + 1) % cfg.check_error == 0 or i == 0 \
                or (i + 1) == cfg.total_iterations:
            train_rmse, train_mae = eval_split(train_csr)
            test_rmse, test_mae = eval_split(test_csr)
            if verbose:
                print(f"TRAIN: Iteration {i + 1} CPU "
                      f"MAE: {train_mae:f} RMSE: {train_rmse:f}")
                print(f"TEST: Iteration {i + 1} CPU "
                      f"MAE: {test_mae:f} RMSE: {test_rmse:f}")
            losses[i + 1] = test_rmse
    return {"p": P, "q": Q, "user_bias": ub, "item_bias": ib,
            "global_bias": np.array([global_bias], dtype=np.float32)}, losses
