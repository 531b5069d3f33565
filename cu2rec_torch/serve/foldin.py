"""Fold-in: partial fit of a new user against frozen item tables.

Reference behavior (predict.cu:103-126): set ``is_train=false`` (freezing
Q/item_bias, sgd.cu:61,70), remap the new user's ratings to user id 0, build
a 1×n_items CSR, and run the normal training loop so only the single P row
and user bias learn.  Same here, through ``SingleChipEngine``: on the card
each iteration is K0a's user kernel alone (``train_items=False``), on
tables of the config's dtype (bf16 included).
"""

from __future__ import annotations

import numpy as np

from cu2rec_torch.data.csr import csr_from_arrays
from cu2rec_torch.models.state import init_model
from cu2rec_torch.train.trainer import SingleChipEngine, train_with_engine
from cu2rec_torch.utils.config import Config
from cu2rec_torch.utils.metrics import MetricsLogger


def fold_in_user(Q, item_bias, global_bias: float,
                 rated_items: np.ndarray, ratings: np.ndarray,
                 cfg: Config, verbose: bool = False, device=None):
    """Learn (p_row, user_bias) for one new user with Q/item_bias frozen.

    Returns (model, losses): a 1-user MFModel whose P[0]/user_bias[0] are
    the folded-in row (the reference returns the same via train() on the
    1-row CSR, predict.cu:126)."""
    cfg = cfg.replace(is_train=False, cur_iterations=0)
    n_items = Q.shape[0]
    order = np.argsort(rated_items, kind="stable")
    csr = csr_from_arrays(
        users=np.zeros(len(rated_items), dtype=np.int32),
        items=np.asarray(rated_items, dtype=np.int32)[order],
        data=np.asarray(ratings, dtype=np.float32)[order],
        n_users=1, n_items=n_items)
    engine = SingleChipEngine(csr, csr, cfg, device=device)
    model = init_model(1, n_items, cfg.n_factors, global_bias,
                       seed=cfg.seed, dtype=cfg.dtype, Q=Q,
                       item_bias=item_bias, device=engine.device)
    logger = MetricsLogger(verbose=verbose)
    return train_with_engine(engine, cfg, engine.prepare(model), logger)
