"""iALS training loop — implicit-feedback weighted MF (see ``ops/ials.py``).

The loop contract of the other trainers (per-sweep metrics through
MetricsLogger, a losses dict, an MFModel out), with the implicit task's
metrics: sampled AUC, recall@k and NDCG@k over held-out positives.  The
returned MFModel has zero biases and zero global bias, so the serving stack
works unchanged: score(u, i) = x_u · y_i.  Each eval record carries the
two half sweeps' times (``half_sweep_ms``).
"""

from __future__ import annotations

import time

import torch

from cu2rec_torch.data.csr import CSRRatings
from cu2rec_torch.models.state import MFModel, init_model
from cu2rec_torch.ops.bpr import auc_eval, prepare_auc
from cu2rec_torch.ops.ials import ials_half_sweep
from cu2rec_torch.serve.recommend import prepare_ranking, ranking_eval
from cu2rec_torch.train.als import sweep_chunks
from cu2rec_torch.utils.config import Config
from cu2rec_torch.utils.device import resolve_device
from cu2rec_torch.utils.metrics import MetricsLogger
from cu2rec_torch.utils.timing import elapsed_ms, fetch_barrier, mark


def train_ials(train_csr: CSRRatings, test_csr: CSRRatings, cfg: Config,
               alpha: float = 40.0,
               model: MFModel | None = None,
               logger: MetricsLogger | None = None,
               recall_k: int = 10,
               recall_users: int = 2048,
               mesh=None,
               device=None):
    """Train implicit weighted MF for ``cfg.total_iterations`` sweeps, on
    the CUDA device unless ``device="cpu"``.

    ``cfg.P_reg`` is the user side's ridge λ (``Q_reg`` the item side's);
    ``alpha`` the confidence slope c = 1 + α·r.  Any observed pair is a
    positive.  ``mesh``: the solves row-sharded over the grid, as in
    ``train_als``.
    """
    dev = resolve_device(mesh.device if mesh is not None and device is None
                         else device)
    logger = logger or MetricsLogger()
    F = cfg.n_factors
    recall_k = min(recall_k, train_csr.n_items)
    if model is None:
        # Drawn in the config's table dtype; the sweeps then keep float32
        # tables, as the TPU package's do.
        model = init_model(train_csr.n_users, train_csr.n_items, F, 0.0,
                           seed=cfg.seed, dtype=cfg.dtype, device=dev)
    X = model.P.to(dev, torch.float32)
    Y = model.Q.to(dev, torch.float32)
    user_chunks, item_chunks = sweep_chunks(train_csr, F, dev, mesh)
    auc_plan = prepare_auc(train_csr, test_csr, seed=cfg.seed, device=dev)
    rank_plan = prepare_ranking(train_csr, test_csr, max_users=recall_users,
                                device=dev)

    def as_model(X, Y) -> MFModel:
        zeros = torch.zeros
        return MFModel(P=X, Q=Y,
                       user_bias=zeros(train_csr.n_users, device=dev),
                       item_bias=zeros(train_csr.n_items, device=dev),
                       global_bias=zeros((), device=dev))

    losses: dict[int, float] = {}
    start = time.perf_counter()
    for sweep in range(min(cfg.cur_iterations, cfg.total_iterations) + 1,
                       cfg.total_iterations + 1):
        t0 = mark(dev)
        X = ials_half_sweep(X, Y, user_chunks, alpha, cfg.P_reg,
                            row_sharding=mesh)
        t1 = mark(dev)
        Y = ials_half_sweep(Y, X, item_chunks, alpha, cfg.Q_reg,
                            row_sharding=mesh)
        t2 = mark(dev)
        mdl = as_model(X, Y)
        m = ranking_eval(mdl, train_csr, test_csr, k=recall_k,
                         max_users=recall_users, plan=rank_plan)
        rec = m["recall"]
        auc = auc_eval(mdl, train_csr, test_csr, seed=cfg.seed,
                       plan=auc_plan)
        objective = 1.0 - rec
        logger.log_eval_implicit(sweep, algo="ials", auc=auc,
                                 recall_at_k=rec, ndcg_at_k=m["ndcg"],
                                 k=recall_k, objective=objective,
                                 line_prefix="IALS sweep",
                                 extras={"half_sweep_ms": [
                                     elapsed_ms(t0, t1),
                                     elapsed_ms(t1, t2)]})
        losses[sweep] = objective
        cfg.cur_iterations += 1

    fetch_barrier(X)
    logger.log_time(cfg.total_iterations, time.perf_counter() - start)
    return as_model(X, Y), losses
