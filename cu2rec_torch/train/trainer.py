"""Training orchestration — the equivalent of reference training.cu.

Reference loop shape (training.cu:107-170): one ``sgd_update`` kernel launch
per iteration, driven from the host, with RMSE/MAE evaluated on the first
iteration, every ``check_error`` iterations and the last one
(training.cu:118), and a learning-rate plateau scheduler (patience
decrement when validation RMSE worsens; multiply LR by
``learning_rate_decay`` at zero; training.cu:145-155).

Here too the host drives each iteration: a segment between eval points is a
loop of step launches (K0a on the card, ``ops/packed.py``) that nothing
synchronizes until the eval (K0b) reads its sums.  The eval cadence,
plateau scheduling, metric lines, resume from ``cur_iterations`` and
periodic checkpoints are the TPU package's host contract, unchanged.

The loop is engine-agnostic: ``SingleChipEngine`` runs one device (the
packed step, or with ``packed=False`` the plain unpacked step), and
``parallel.sharded.ShardedEngine`` the same semantics over a grid of
ranks.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cu2rec_torch.data.csr import (
    CSRRatings, DeviceRatings, normalize_csr_dims, to_device,
)
from cu2rec_torch.models.state import (
    MFModel, init_model, table_dtype, with_dtype,
)
from cu2rec_torch.ops.loss import evaluate_packed, evaluate_unpacked
from cu2rec_torch.ops.packed import (
    PackedModel, check_collision, pack, packed_run_steps, packed_width,
    unpack,
)
from cu2rec_torch.ops.sgd import (
    Hyper, apply_item_deltas, elect_winners, prng_key, rotated_priority,
    sample_items, sgd_step, win_mask,
)
from cu2rec_torch.utils.config import Config
from cu2rec_torch.utils.device import resolve_device
from cu2rec_torch.utils.metrics import MetricsLogger
from cu2rec_torch.utils.timing import fetch_barrier, span


def single_step(model: MFModel, dev: DeviceRatings, hp: Hyper, key,
                iteration: int, *, train_items: bool = True,
                collision: str = "first_wins",
                rotation: int = 250) -> MFModel:
    """One SGD iteration over unpacked tables, plain torch on either
    device (the TPU package's ``single_step``)."""
    n_users, n_items = model.n_users, model.n_items
    items, ratings, has = sample_items(key, iteration, dev.indptr,
                                       dev.indices, dev.data)
    prio = rotated_priority(n_users, iteration, 0, n_users, rotation,
                            items.device)
    best, cand = elect_winners(items, has, prio, n_items)
    win = win_mask(best, items, cand, has)
    P, ub, dq, dib = sgd_step(
        model.P, model.Q, model.user_bias, model.item_bias,
        model.global_bias, items, ratings, has, win, hp,
        train_items=train_items, collision=collision)
    Q, ib = model.Q, model.item_bias
    if train_items:
        Q, ib = apply_item_deltas(Q, ib, items, dq, dib)
    return MFModel(P=P, Q=Q, user_bias=ub, item_bias=ib,
                   global_bias=model.global_bias)


def run_steps(model: MFModel, dev: DeviceRatings, hp: Hyper, key,
              start_iter: int, n_steps: int, train_items: bool = True,
              collision: str = "first_wins") -> MFModel:
    """``n_steps`` unpacked iterations from ``start_iter``."""
    for i in range(int(n_steps)):
        model = single_step(model, dev, hp, key, int(start_iter) + i,
                            train_items=train_items, collision=collision)
    return model


def _subsample_dev(csr: CSRRatings, n_sample: int, seed: int,
                   device=None) -> DeviceRatings:
    """Random rating subsample as a DeviceRatings (train-eval speedup); the
    same NumPy draw as the TPU package, so both pick the same ratings.
    ``indptr`` is None on purpose: the subsample cannot be sampled from."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    sel = np.sort(rng.choice(csr.nnz, size=n_sample, replace=False))

    def put(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(dev)

    return DeviceRatings(
        indptr=None, indices=put(csr.indices[sel], np.int32),
        data=put(csr.data[sel], np.float32),
        row_ids=put(csr.row_ids[sel], np.int32), nnz=n_sample,
        n_users=csr.n_users, n_items=csr.n_items)


class SingleChipEngine:
    """One device: the packed tables, the step and the eval.

    The engine's state is a :class:`PackedModel` (factors and bias in one row
    per user/item); ``prepare``/``finalize`` convert from/to the public
    ``MFModel``.  With ``packed=False`` the state is the ``MFModel`` itself
    and the step the plain unpacked one (``run_steps``: first_wins and
    mean, as in the TPU package).  It runs on the CUDA device unless
    ``device="cpu"``.
    """

    def __init__(self, train_csr: CSRRatings, test_csr: CSRRatings,
                 cfg: Config, packed: bool = True, device=None):
        self.packed = packed
        self.dtype = table_dtype(cfg.dtype)
        if cfg.is_train:
            check_collision(cfg.collision_policy)
        self.device = resolve_device(device)
        # Align dimensions so that evaluation of either split indexes the
        # same parameter tables.
        n_users = max(train_csr.n_users, test_csr.n_users)
        n_items = max(train_csr.n_items, test_csr.n_items)
        train_csr = normalize_csr_dims(train_csr, n_users, n_items)
        test_csr = normalize_csr_dims(test_csr, n_users, n_items)
        self.n_users = n_users
        self.n_items = n_items
        twin = cfg.collision_policy == "twin"
        # The TPU package's rule: drop the (user, rating) mirror when the
        # sampling structures and step tables near 6 GiB.  Both layouts give
        # the same steps.
        W = packed_width(cfg.n_factors)
        est = 28 * (train_csr.nnz + test_csr.nnz) + 6 * 4 * W * n_users
        lean = twin and est > (6 << 30)
        with span("engine.build"):
            self.train_dev = to_device(train_csr, self.device,
                                       item_major=twin, lean=lean)
            self.test_dev = to_device(test_csr, self.device)
            self.train_eval_dev = self.train_dev
            if cfg.train_eval_sample and \
                    train_csr.nnz > cfg.train_eval_sample:
                self.train_eval_dev = _subsample_dev(
                    train_csr, cfg.train_eval_sample, cfg.seed, self.device)
            self.test_eval_dev = self.test_dev
            if cfg.test_eval_sample and test_csr.nnz > cfg.test_eval_sample:
                self.test_eval_dev = _subsample_dev(
                    test_csr, cfg.test_eval_sample, cfg.seed + 1,
                    self.device)
        self.cfg = cfg
        self.key = prng_key(cfg.seed)

    def init_model(self, n_users: int, n_items: int, global_bias: float,
                   Q=None, item_bias=None) -> PackedModel:
        with span("model.init"):
            return self.prepare(init_model(
                n_users, n_items, self.cfg.n_factors, global_bias,
                seed=self.cfg.seed, dtype=self.dtype, Q=Q,
                item_bias=item_bias, device=self.device))

    def prepare(self, model: MFModel) -> PackedModel:
        """Pack a model on the engine's device, in the config's table dtype
        (a resumed float32 checkpoint is cast back to it), grown to the
        engine's normalized dimensions (a model built from the train split
        alone may have fewer users or items than max(train, test))."""
        with span("model.init.pack"):
            model = with_dtype(model.to(self.device), self.dtype)
            du = max(self.n_users - model.n_users, 0)
            di = max(self.n_items - model.n_items, 0)
            if du or di:
                pad = torch.nn.functional.pad
                model = MFModel(P=pad(model.P, (0, 0, 0, du)),
                                Q=pad(model.Q, (0, 0, 0, di)),
                                user_bias=pad(model.user_bias, (0, du)),
                                item_bias=pad(model.item_bias, (0, di)),
                                global_bias=model.global_bias)
            return pack(model) if self.packed else model

    def run(self, state, hp: Hyper, start_iter: int, n_steps: int):
        runner = packed_run_steps if self.packed else run_steps
        return runner(state, self.train_dev, hp, self.key, start_iter,
                      n_steps, bool(self.cfg.is_train),
                      self.cfg.collision_policy)

    def evaluate(self, state, split: str):
        dev = self.train_eval_dev if split == "train" else self.test_eval_dev
        if self.packed:
            return evaluate_packed(state, dev)
        return evaluate_unpacked(state, dev)

    def finalize(self, state) -> MFModel:
        return unpack(state) if self.packed else state


def eval_segments(total_iterations: int, check_error: int, start: int = 0):
    """Segment lengths between the reference's eval points
    (training.cu:118: eval after iteration i when (i+1)%check_error==0,
    i==0, or i is last).  Yields (n_steps, eval_iteration_1based).

    ``start`` skips completed work (resume: a run checkpointed at
    cur_iterations=4500/5000 trains only the remaining 500)."""
    points = sorted({1, total_iterations} | {
        j for j in range(check_error, total_iterations + 1, check_error)})
    prev = start
    for p in points:
        if p <= start:
            continue
        yield p - prev, p
        prev = p


def _hyper(cfg: Config, lr: float) -> Hyper:
    return Hyper.from_config(cfg.replace(learning_rate=lr))


def _clone_state(state):
    """A copy of an engine's state (a ``PackedModel``, an ``MFModel`` or a
    tuple of blocks) that a throwaway run may change."""
    if isinstance(state, PackedModel):
        return PackedModel(T_u=state.T_u.clone(), T_i=state.T_i.clone(),
                           global_bias=state.global_bias,
                           n_factors=state.n_factors)
    if isinstance(state, MFModel):
        return MFModel(P=state.P.clone(), Q=state.Q.clone(),
                       user_bias=state.user_bias.clone(),
                       item_bias=state.item_bias.clone(),
                       global_bias=state.global_bias)
    return tuple(t.clone() for t in state)


def _warmup(engine, cfg: Config, state) -> None:
    """Build the kernels and run each program once, on a throwaway copy,
    before the timer starts: the analogue of the reference's timer
    excluding setup (training.cu:18-19)."""
    with span("trainer.warmup"):
        throwaway = _clone_state(state)
        hp = _hyper(cfg, float(cfg.learning_rate))
        throwaway = engine.run(throwaway, hp, 0, 1)
        throwaway = engine.run(throwaway, hp, 1, 1)
        engine.evaluate(throwaway, "train")
        engine.evaluate(throwaway, "test")


def train_with_engine(engine, cfg: Config, model: PackedModel,
                      logger: MetricsLogger | None = None,
                      warmup: bool = True,
                      checkpoint_path: str | None = None,
                      checkpoint_every: int = 0):
    """The host loop: eval cadence + LR plateau + metrics.

    ``checkpoint_path`` + ``checkpoint_every`` (in eval points) write
    resumable checkpoints mid-run.  Returns ``(MFModel, losses)``."""
    with span("trainer.job"):
        logger = logger or MetricsLogger()
        lr = float(cfg.learning_rate)
        patience = cfg.patience
        last_validation_rmse = float("inf")
        validation_rmse = float("inf")
        losses: dict[int, float] = {}

        total = cfg.total_iterations
        start_iter = cfg.cur_iterations
        if start_iter >= total and start_iter > 0:
            # Nothing left to train (resume of a completed run).
            model = engine.finalize(model)
            logger.log_time(0, 0.0)
            return model, losses
        if warmup:
            _warmup(engine, cfg, model)
        start_time = time.perf_counter()
        for n_steps, eval_iter in eval_segments(total, cfg.check_error,
                                                start=start_iter):
            hp = _hyper(cfg, lr)
            seg_t0 = time.perf_counter()
            model = engine.run(model, hp, cfg.cur_iterations, n_steps)
            cfg.cur_iterations += n_steps

            train_rmse, train_mae = engine.evaluate(model, "train")
            seg_dt = time.perf_counter() - seg_t0  # the eval's read waits
            last_validation_rmse = validation_rmse
            validation_rmse, validation_mae = engine.evaluate(model, "test")
            n_users = getattr(engine, "n_users", 0)
            logger.log_eval(eval_iter, train_mae=train_mae,
                            train_rmse=train_rmse, test_mae=validation_mae,
                            test_rmse=validation_rmse, learning_rate=lr,
                            updates_per_s=round(n_users * n_steps / seg_dt, 1)
                            if n_users else None)
            losses[eval_iter] = validation_rmse

            if checkpoint_path and checkpoint_every and \
                    (len(losses) % checkpoint_every == 0):
                from cu2rec_torch.utils.checkpoint import save_checkpoint
                save_checkpoint(checkpoint_path, engine.finalize(model), cfg)

            # LR plateau decay (training.cu:145-155).
            if last_validation_rmse < validation_rmse:
                patience -= 1
            if patience <= 0:
                patience = cfg.patience
                lr *= cfg.learning_rate_decay
                cfg.learning_rate = lr
                logger.log_lr_decay(lr)

        with span("trainer.finalize"):
            model = engine.finalize(model)
        fetch_barrier(model.P)
        elapsed = time.perf_counter() - start_time
        logger.log_time(total, elapsed)
        return model, losses


def train(train_csr: CSRRatings, test_csr: CSRRatings, cfg: Config,
          global_bias: float,
          model: MFModel | None = None,
          logger: MetricsLogger | None = None,
          engine=None,
          checkpoint_path: str | None = None,
          checkpoint_every: int = 0,
          device=None):
    """Full training — the main ``train`` overload of the reference
    (training.cu:21-204).

    Initializes the model unless one is given (the fold-in path passes
    pre-trained Q/item_bias, training.cu:206-217).  Returns ``(model,
    losses)``, ``losses`` mapping 1-based eval iterations to validation
    RMSE (training.cu:29,158).
    """
    engine = engine or SingleChipEngine(train_csr, test_csr, cfg,
                                        device=device)
    if model is None:
        state = engine.init_model(engine.n_users, engine.n_items,
                                  global_bias)
    else:
        state = engine.prepare(model)
    return train_with_engine(engine, cfg, state, logger,
                             checkpoint_path=checkpoint_path,
                             checkpoint_every=checkpoint_every)
