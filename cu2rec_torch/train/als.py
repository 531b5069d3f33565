"""ALS training loop — the second optimizer family (see ``ops/als.py``).

The familiar loop contract: per-sweep train/test RMSE and MAE (kernel K0b
on the card) through the same MetricsLogger, one "iteration" being one
full sweep (a user half sweep, then an item half sweep), a losses dict
keyed by sweep, an MFModel out.  There is no learning rate and no plateau
schedule: each half sweep solves its subproblem exactly.  Each eval record
carries the two half sweeps' times (``half_sweep_ms``), from CUDA events
on the card.
"""

from __future__ import annotations

import time

import torch

from cu2rec_torch.data.csr import CSRRatings, to_device, transpose_csr
from cu2rec_torch.models.state import (
    MFModel, init_model, table_dtype, with_dtype,
)
from cu2rec_torch.ops.als import (
    als_half_sweep, bucket_csr, prepare_chunks, prepare_chunks_device,
)
from cu2rec_torch.ops.loss import evaluate_packed
from cu2rec_torch.ops.packed import PackedModel, pack, unpack
from cu2rec_torch.train.trainer import _subsample_dev
from cu2rec_torch.utils.config import Config
from cu2rec_torch.utils.device import resolve_device
from cu2rec_torch.utils.metrics import MetricsLogger
from cu2rec_torch.utils.timing import elapsed_ms, fetch_barrier, mark

# Above this many ratings the bucket slices are extracted on the device.
DEVICE_BUCKETS_ABOVE = 5_000_000


def sweep_chunks(csr: CSRRatings, n_factors: int, device,
                 device_buckets: bool | None = None, row_sharding=None):
    """(user chunks, item chunks) of a training CSR for the half sweeps:
    extracted on the device from the uploaded flat CSR above
    ``DEVICE_BUCKETS_ABOVE`` ratings (or with ``device_buckets``), else
    bucketed on the host and uploaded; with ``row_sharding`` this rank's
    share of them."""
    if device_buckets is None:
        device_buckets = csr.nnz > DEVICE_BUCKETS_ABOVE
    it_indptr, it_rows, it_vals = transpose_csr(csr)
    sides = ((csr.indptr, csr.indices, csr.data, csr.n_users),
             (it_indptr, it_rows, it_vals, csr.n_items))
    if device_buckets:
        def up(x, dtype):
            return torch.from_numpy(x).to(device, dtype)

        return tuple(prepare_chunks_device(
            up(ind, torch.int32), up(dat, torch.float32), ip, n_factors, n,
            csr.nnz, row_sharding=row_sharding)
            for ip, ind, dat, n in sides)
    return tuple(prepare_chunks(bucket_csr(ip, ind, dat), n_factors, n,
                                row_sharding, device=device)
                 for ip, ind, dat, n in sides)


def train_als(train_csr: CSRRatings, test_csr: CSRRatings, cfg: Config,
              global_bias: float,
              model: MFModel | None = None,
              logger: MetricsLogger | None = None,
              weight_by_degree: bool = True,
              mesh=None,
              device_buckets: bool | None = None,
              solver: str = "auto",
              device=None):
    """Train by ALS for ``cfg.total_iterations`` sweeps, on the CUDA device
    unless ``device="cpu"``.  Returns ``(model, losses)``, losses mapping
    each sweep to its test RMSE.  A resumed run (``cfg.cur_iterations``
    sweeps done) runs only the remaining sweeps.  With ``mesh`` (a
    ``parallel.sharded.Mesh``; every rank of it calls this) the ridge
    solves are row-sharded over the whole grid, each rank solving its share
    with K1, the counterpart table replicated; the device is the mesh's."""
    dtype = table_dtype(cfg.dtype)
    dev = resolve_device(mesh.device if mesh is not None and device is None
                         else device)
    logger = logger or MetricsLogger()
    F = cfg.n_factors
    if model is None:
        model = init_model(train_csr.n_users, train_csr.n_items, F,
                           global_bias, seed=cfg.seed, dtype=dtype,
                           device=dev)
    pm = pack(with_dtype(model.to(dev), dtype))
    mu = float(global_bias)

    train_dev = to_device(train_csr, dev)
    train_eval_dev = train_dev
    if cfg.train_eval_sample and train_csr.nnz > cfg.train_eval_sample:
        train_eval_dev = _subsample_dev(train_csr, cfg.train_eval_sample,
                                        cfg.seed, dev)
    if cfg.test_eval_sample and test_csr.nnz > cfg.test_eval_sample:
        test_eval_dev = _subsample_dev(test_csr, cfg.test_eval_sample,
                                       cfg.seed + 1, dev)
    else:
        test_eval_dev = to_device(test_csr, dev)
    user_chunks, item_chunks = sweep_chunks(train_csr, F, dev,
                                            device_buckets, mesh)

    losses: dict[int, float] = {}
    n_sweeps = cfg.total_iterations
    start = time.perf_counter()
    for sweep in range(min(cfg.cur_iterations, n_sweeps) + 1, n_sweeps + 1):
        t0 = mark(dev)
        T_u = als_half_sweep(pm.T_u, pm.T_i, user_chunks, mu, cfg.P_reg,
                             cfg.user_bias_reg, F,
                             weight_by_degree=weight_by_degree,
                             row_sharding=mesh, solver=solver)
        t1 = mark(dev)
        T_i = als_half_sweep(pm.T_i, T_u, item_chunks, mu, cfg.Q_reg,
                             cfg.item_bias_reg, F,
                             weight_by_degree=weight_by_degree,
                             row_sharding=mesh, solver=solver)
        t2 = mark(dev)
        pm = PackedModel(T_u=T_u, T_i=T_i, global_bias=pm.global_bias,
                         n_factors=F)
        train_rmse, train_mae = evaluate_packed(pm, train_eval_dev)
        test_rmse, test_mae = evaluate_packed(pm, test_eval_dev)
        logger.log_eval(sweep, train_mae=train_mae, train_rmse=train_rmse,
                        test_mae=test_mae, test_rmse=test_rmse,
                        learning_rate=0.0,
                        extras={"half_sweep_ms": [elapsed_ms(t0, t1),
                                                  elapsed_ms(t1, t2)]})
        losses[sweep] = test_rmse
        cfg.cur_iterations += 1

    fetch_barrier(pm.T_u)
    logger.log_time(n_sweeps, time.perf_counter() - start)
    return unpack(pm), losses
