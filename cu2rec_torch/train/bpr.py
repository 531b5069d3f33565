"""BPR training loop — pairwise-ranking MF (see ``ops/bpr.py``).

Iteration-based like the SGD trainer: an eval at iteration 1, every
``check_error`` iterations and at the last, each a sampled AUC, recall@k
and NDCG@k over held-out positives (``log_eval_implicit``); the losses dict
carries the minimized objective 1 − recall@k.  The returned MFModel has
zero user and global bias and a trained item bias: score(u, y) = p_u · q_y
+ b_y.
"""

from __future__ import annotations

import time

import torch

from cu2rec_torch.data.csr import CSRRatings, to_device
from cu2rec_torch.models.state import (
    MFModel, init_model, table_dtype, with_dtype,
)
from cu2rec_torch.ops.bpr import auc_eval, bpr_run_steps
from cu2rec_torch.ops.packed import pack, unpack
from cu2rec_torch.ops.sgd import Hyper, prng_key
from cu2rec_torch.serve.recommend import ranking_eval
from cu2rec_torch.utils.config import Config
from cu2rec_torch.utils.device import resolve_device
from cu2rec_torch.utils.metrics import MetricsLogger
from cu2rec_torch.utils.timing import fetch_barrier


def train_bpr(train_csr: CSRRatings, test_csr: CSRRatings, cfg: Config,
              model: MFModel | None = None,
              logger: MetricsLogger | None = None,
              recall_k: int = 10,
              recall_users: int = 2048,
              mesh=None, n_devices: int = 0,
              device=None):
    """Train BPR-MF for ``cfg.total_iterations`` iterations on one device
    (CUDA unless ``device="cpu"``).

    One iteration = one pairwise update a user row + one positive and one
    negative update an item row.  ``cfg.learning_rate`` and the four reg
    fields apply as in the SGD trainer.  A resumed run trains only the
    iterations past ``cfg.cur_iterations``.  With ``mesh`` (or
    ``n_devices`` > 1 ranks, a dp grid) every rank of the grid calls this
    and the users shard over it (``parallel/bpr.py``, the same draws as on
    one device); the device is the mesh's.
    """
    dtype = table_dtype(cfg.dtype)
    sharded = mesh is not None or (n_devices and n_devices > 1)
    if sharded and mesh is None:
        from cu2rec_torch.parallel.sharded import make_mesh
        mesh = make_mesh(n_devices, 1, device)
    dev = resolve_device(mesh.device if sharded else device)
    logger = logger or MetricsLogger()
    F = cfg.n_factors
    recall_k = min(recall_k, train_csr.n_items)
    if model is None:
        model = init_model(train_csr.n_users, train_csr.n_items, F, 0.0,
                           seed=cfg.seed, dtype=dtype, device=dev)
        # BPR has no user or global bias in its score.
        model = MFModel(P=model.P, Q=model.Q,
                        user_bias=torch.zeros_like(model.user_bias),
                        item_bias=torch.zeros_like(model.item_bias),
                        global_bias=torch.zeros((), device=dev))
    hp = Hyper.from_config(cfg)
    key = prng_key(cfg.seed)
    engine = None
    if sharded:
        from cu2rec_torch.parallel.bpr import ShardedBPR
        engine = ShardedBPR(train_csr, cfg, mesh=mesh, model=model)
    else:
        train_dev = to_device(train_csr, dev, item_major=True)
        pm = pack(with_dtype(model.to(dev), dtype))

    check = max(1, cfg.check_error)
    start_at = min(cfg.cur_iterations, cfg.total_iterations)
    points = sorted({p for p in
                     {1, *range(check, cfg.total_iterations + 1, check),
                      cfg.total_iterations} if p > start_at})
    losses: dict[int, float] = {}
    done = start_at
    start = time.perf_counter()
    for point in points:
        seg = point - done
        t0 = time.perf_counter()
        if engine is not None:
            engine.run(hp, key, done, seg)
            fetch_barrier(engine.T_u)
        else:
            pm = bpr_run_steps(pm, train_dev, hp, key, done, seg)
            fetch_barrier(pm.T_u)
        dt_seg = time.perf_counter() - t0
        done = point
        m = engine.model() if engine is not None else unpack(pm)
        auc = auc_eval(m, train_csr, test_csr, seed=cfg.seed)
        rk = ranking_eval(m, train_csr, test_csr, k=recall_k,
                          max_users=recall_users)
        rec = rk["recall"]
        ups = train_csr.n_users * seg / dt_seg if dt_seg > 0 else None
        objective = 1.0 - rec
        logger.log_eval_implicit(point, algo="bpr", auc=auc,
                                 recall_at_k=rec, ndcg_at_k=rk["ndcg"],
                                 k=recall_k, objective=objective,
                                 learning_rate=cfg.learning_rate,
                                 updates_per_s=ups,
                                 line_prefix="BPR iteration")
        losses[point] = objective
        cfg.cur_iterations = point

    logger.log_time(cfg.total_iterations, time.perf_counter() - start)
    return (engine.model() if engine is not None else unpack(pm)), losses
