"""Serving engine on one GPU: batched recommendations and batched fold-in
against a frozen catalog — the reference's ``predict`` binary
(predict.cu:103-132) as a long-lived service.

The one-device counterpart of the TPU package's ``ShardedServingEngine``
(serve/engine.py there), with the same methods, padding and results:

  * the catalog lives once on the device, as the packed item table
    (factors + bias per row, ops/packed.py);
  * ``recommend`` scores a user batch against the catalog in item chunks
    with a running top-k merge, so the live score tile is bounded whatever
    the batch size;
  * ``fold_in`` learns (p_row, user_bias) for a batch of new users against
    the frozen catalog (is_train=false semantics, sgd.cu:61,70): per
    iteration each user samples one of its ratings from the counter-based
    stream keyed by batch slot, and only the user rows update;
  * ``fold_in_implicit`` solves the iALS normal equations for a batch of
    new users exactly, with kernel K1 (ops/cuda_linalg.py);
  * batches are padded to powers of two, as in the TPU package, and
    ``_programs`` records each padded signature the first time it runs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cu2rec_torch.models.state import MFModel
from cu2rec_torch.ops.ials import _solve_ials_bucket, gramian
from cu2rec_torch.ops.packed import _reg_vectors, pack
from cu2rec_torch.ops.sgd import Hyper, _key_words, counter_uniform, prng_key
from cu2rec_torch.ops.topk import _POS_HUGE, NEG_INF
from cu2rec_torch.utils.config import Config
from cu2rec_torch.utils.device import resolve_device


def _pow2_pad(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ServingEngine:
    """Long-lived serving state on one device (``n_ip`` = 1 item shard)."""

    n_ip = 1

    def __init__(self, model: MFModel, device=None,
                 chunk_items: int | None = None):
        # ``chunk_items`` overrides the auto-sized catalog chunk width C in
        # the scoring scan (testing/tuning knob; must be >= any k served).
        # None → the ~512 MB-tile formula in _recommend.
        self.device = resolve_device(device)
        self.chunk_items = chunk_items
        self.n_items = model.n_items
        self.F = model.n_factors
        self.mu = float(model.global_bias)
        pm = pack(model)
        self.W = pm.width
        self.T_i = pm.T_i.to(self.device)
        # Known-user tables stay on the host (numpy): a request's row lookup
        # is a host gather, and the device sees only the padded batch.
        self.P = _host(model.P).astype(np.float32)
        self.user_bias = _host(model.user_bias).astype(np.float32)
        self._programs: dict = {}

    def _note(self, key) -> None:
        self._programs.setdefault(key, True)

    def _to_dev(self, x, dtype=torch.float32) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, dtype)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device,
                                                            dtype)

    # -- recommendation ---------------------------------------------------
    def _recommend(self, pr, ub, rated, rmask, k: int):
        """Masked top-k over the catalog for a padded batch: a scan over
        item chunks of width C with a running top-k merge, so peak memory is
        one (B, C) tile + the (B, k) carry."""
        B = pr.shape[0]
        F, I = self.F, self.n_items
        C = min(I, max(k, self.chunk_items if self.chunk_items
                       else max(8192, (128 << 20) // max(B, 1) // 128 * 128)))
        n_chunks = -(-I // C)
        k_loc = min(k, C)
        rated = self._to_dev(rated, torch.int64)
        rmask = self._to_dev(rmask, torch.bool)
        neg = float(NEG_INF)
        vals = torch.full((B, k), neg, dtype=torch.float32,
                          device=self.device)
        idx = torch.zeros((B, k), dtype=torch.int64, device=self.device)
        for c in range(n_chunks):
            # Clamped start: the last chunk overlaps its predecessor
            # instead of padding; the overlap is masked so each item scores
            # in exactly one chunk.
            c0 = min(c * C, I - C)
            Tc = self.T_i[c0:c0 + C]
            sc = pr @ Tc[:, :F].to(torch.float32).T
            sc = (sc + self.mu + ub[:, None]
                  + Tc[:, F].to(torch.float32)[None, :])
            if c0 < c * C:
                sc[:, :c * C - c0] = neg
            loc = rated - c0
            in_chunk = rmask & (loc >= 0) & (loc < C)
            cols = loc.clamp(0, C - 1)
            sc.scatter_reduce_(1, cols, torch.where(in_chunk, neg, _POS_HUGE),
                               reduce="amin")
            v, i = torch.topk(sc, k_loc, dim=1)
            i = i + c0
            if k_loc < k:
                v = torch.nn.functional.pad(v, (0, k - k_loc), value=neg)
                i = torch.nn.functional.pad(i, (0, k - k_loc))
            vals, mpos = torch.topk(torch.cat([vals, v], dim=1), k, dim=1)
            idx = torch.gather(torch.cat([idx, i], dim=1), 1, mpos)
        return vals, idx

    @staticmethod
    def _pad_rows(p_rows, ub_rows):
        """Host-pad user rows/biases to the pow2 batch signature."""
        p_rows = np.asarray(p_rows, np.float32)
        ub_rows = np.asarray(ub_rows, np.float32)
        B = p_rows.shape[0]
        Bp = _pow2_pad(B)
        pp = np.zeros((Bp, p_rows.shape[1]), np.float32)
        ubp = np.zeros(Bp, np.float32)
        pp[:B] = p_rows
        ubp[:B] = ub_rows
        return pp, ubp

    @staticmethod
    def _pad_rated(rated_items, rated_mask, Bp: int):
        """Host-pad rated lists to a pow2 (Bp, Rp) signature."""
        rated_items = _host(rated_items)
        rated_mask = _host(rated_mask)
        if rated_items.ndim == 1:  # one rated item per user → (B, 1)
            rated_items = rated_items[:, None]
            rated_mask = rated_mask[:, None]
        B, R = rated_items.shape
        Rp = _pow2_pad(max(R, 1))
        rated = np.zeros((Bp, Rp), np.int32)
        rmask = np.zeros((Bp, Rp), bool)
        rated[:B, :R] = rated_items
        rmask[:B, :R] = rated_mask
        return rated, rmask

    def recommend_padded(self, p_rows, ub_rows, rated_items, rated_mask,
                         k: int = 10):
        """Dispatch one scoring batch; returns UNTRIMMED (Bp, k) device
        tensors (scores, item ids) without waiting for the device.

        ``p_rows``/``ub_rows`` are numpy arrays or device tensors already
        padded to a pow2 batch (the fold-in output)."""
        Bp = int(np.shape(p_rows)[0])
        if Bp != _pow2_pad(Bp):
            raise ValueError(f"p_rows batch {Bp} not pow2-padded")
        rated, rmask = self._pad_rated(rated_items, rated_mask, Bp)
        self._note(("rec", Bp, int(rated.shape[1]), k, self.chunk_items))
        return self._recommend(self._to_dev(p_rows), self._to_dev(ub_rows),
                               rated, rmask, k)

    def recommend(self, p_rows, ub_rows, rated_items, rated_mask,
                  k: int = 10):
        """Top-k unrated items for a batch given explicit user rows.
        Returns host arrays (scores (B,k), item ids (B,k))."""
        B = int(np.shape(p_rows)[0])
        pp, ubp = self._pad_rows(_host(p_rows), _host(ub_rows))
        vals, idx = self.recommend_padded(pp, ubp, rated_items,
                                          rated_mask, k=k)
        return _host(vals)[:B], _host(idx)[:B]

    def _known_rows(self, user_ids, train_csr):
        """Host-side lookup: pow2-padded P rows, biases, rated lists."""
        from cu2rec_torch.serve.recommend import padded_user_lists
        uids = np.asarray(user_ids)
        rated, rmask = padded_user_lists(train_csr, uids)
        pp, ubp = self._pad_rows(self.P[uids], self.user_bias[uids])
        return pp, ubp, rated, rmask

    def recommend_known_padded(self, user_ids, train_csr, k: int = 10):
        """Hot-path variant: dispatch only, UNTRIMMED (Bp, k) device out."""
        pp, ubp, rated, rmask = self._known_rows(user_ids, train_csr)
        return self.recommend_padded(pp, ubp, rated, rmask, k=k)

    def recommend_known(self, user_ids, train_csr, k: int = 10):
        """Top-k for existing users (rated-in-train items masked)."""
        B = int(np.shape(user_ids)[0])
        vals, idx = self.recommend_known_padded(user_ids, train_csr, k=k)
        return _host(vals)[:B], _host(idx)[:B]

    # -- fold-in ----------------------------------------------------------
    def _fold_in(self, T_u, items, vals, lens, hp: Hyper, key,
                 n_steps: int):
        """``n_steps`` fold-in SGD iterations of the packed (Bp, W) user
        rows ``T_u`` against the frozen catalog."""
        F, W = self.F, self.W
        items = self._to_dev(items, torch.int64)
        vals = self._to_dev(vals)
        lens = self._to_dev(lens, torch.int64)
        factor, biascol, reg_u, _ = _reg_vectors(hp, F, W, self.device)
        has = lens > 0
        last = (lens - 1).clamp(min=0)
        slots = torch.arange(T_u.shape[0], device=self.device)
        lr = hp.learning_rate
        for t in range(n_steps):
            u01 = counter_uniform(key, t, slots)
            idx = torch.minimum((u01 * lens).to(torch.int64), last)
            it_b = torch.gather(items, 1, idx[:, None])[:, 0]
            rat_b = torch.gather(vals, 1, idx[:, None])[:, 0]
            row_i = self.T_i[it_b].to(torch.float32)
            ihat = row_i * factor + biascol
            pred = self.mu + torch.sum(T_u * ihat, dim=-1) + row_i[:, F]
            err = torch.where(has, rat_b - pred, 0.0)
            du = lr * (err[:, None] * ihat - reg_u * T_u)
            T_u = torch.where(has[:, None], T_u + du, T_u)
        return T_u

    def fold_in(self, rated_items, ratings, mask, cfg: Config | None = None,
                key=None, init_rows=None):
        """Batched fold-in: learn (p_row, user_bias) for B new users with
        the catalog frozen.  Returns host arrays (P_rows (B, F), ub (B,)).

        Per-slot sample streams are counter-based on the batch slot, so a
        batch of one reproduces the single-user path exactly.
        ``init_rows=(P0 (B,F), ub0 (B,))`` overrides the seeded
        Normal(0, 1/F) initialization (util.cu:124-132)."""
        B = int(np.shape(rated_items)[0])
        T_u = _host(self.fold_in_padded(rated_items, ratings, mask, cfg=cfg,
                                        key=key, init_rows=init_rows))
        return T_u[:B, :self.F], T_u[:B, self.F]

    def fold_in_padded(self, rated_items, ratings, mask,
                       cfg: Config | None = None, key=None,
                       init_rows=None):
        """Hot-path variant: dispatch only; returns the UNTRIMMED packed
        (Bp, W) user table as a device tensor.  ``key`` is a pair of key
        words (``ops.sgd.prng_key``); default ``prng_key(cfg.seed)``."""
        cfg = cfg or Config()
        B, D = np.shape(rated_items)
        Bp, Dp = _pow2_pad(B), _pow2_pad(D)
        # Compact each row's VALID entries to the front (stable): the
        # sampler draws positions 0..len-1, so a hole in the mask must not
        # leave a masked entry inside the sampled prefix.
        m = _host(mask).astype(bool)
        order = np.argsort(~m, axis=1, kind="stable")
        rated_c = np.take_along_axis(_host(rated_items).astype(np.int32),
                                     order, axis=1)
        ratings_c = np.take_along_axis(_host(ratings).astype(np.float32),
                                       order, axis=1)
        items = np.zeros((Bp, Dp), np.int32)
        vals = np.zeros((Bp, Dp), np.float32)
        lens = np.zeros(Bp, np.int32)
        items[:B, :D] = rated_c
        vals[:B, :D] = ratings_c
        lens[:B] = m.sum(axis=1)
        key = prng_key(cfg.seed) if key is None else _key_words(key)
        if init_rows is not None:
            P0, ub0 = init_rows
            T_u0 = np.zeros((Bp, self.W), np.float32)
            T_u0[:B, :self.F] = _host(P0)
            T_u0[:B, self.F] = _host(ub0)
            T_u0 = self._to_dev(T_u0)
        else:
            T_u0 = self._default_init(Bp, key)
        self._note(("fold", Bp, Dp))
        return self._fold_in(T_u0, items, vals, lens, Hyper.from_config(cfg),
                             key, int(cfg.total_iterations))

    def _default_init(self, Bp: int, key):
        """Normal(0, 1/F) rows from a CPU ``torch.Generator`` seeded with
        the 64-bit key — the same draw on every device.  Each row draws a
        multiple of 16 values (torch's CPU normal transform works in blocks
        of 16), so row b's draw does not depend on Bp and a batch of one
        reproduces the big-batch init."""
        F, W = self.F, self.W
        k0, k1 = key
        gen = torch.Generator().manual_seed((k0 << 32) | k1)
        draw = torch.randn((Bp, -(-(F + 1) // 16) * 16), generator=gen)
        T = torch.zeros((Bp, W), dtype=torch.float32)
        T[:, :F + 1] = draw[:, :F + 1] / F
        self._note(("init", Bp))
        return T.to(self.device)

    # -- implicit (iALS) fold-in ------------------------------------------
    def _implicit_gramian(self):
        """G = YᵀY over the catalog, computed once per engine (the catalog
        is frozen) and shared by every implicit fold-in solve."""
        G = self._programs.get(("igram",))
        if G is None:
            G = gramian(self.T_i[:, :self.F])
            self._programs[("igram",)] = G
        return G

    def fold_in_implicit(self, rated_items, strengths, mask,
                         alpha: float = 40.0, reg: float = 0.1):
        """Exact one-shot fold-in for implicit (iALS) catalogs: solves the
        user half-sweep normal equations for B new users against the frozen
        item factors.  Returns host arrays (P_rows (B, F), ub zeros (B,)) —
        iALS scores carry no biases, so the rows drop straight into
        ``recommend``."""
        B = int(np.shape(rated_items)[0])
        rows = _host(self.fold_in_implicit_padded(
            rated_items, strengths, mask, alpha=alpha, reg=reg))
        return rows[:B], np.zeros(B, np.float32)

    def fold_in_implicit_padded(self, rated_items, strengths, mask,
                                alpha: float = 40.0, reg: float = 0.1):
        """Hot-path variant of ``fold_in_implicit``: dispatch only; returns
        the UNTRIMMED (Bp, F) rows as a device tensor.  The solve is K1 on
        a CUDA device (``ops.als._ridge_finish``)."""
        B, D = np.shape(rated_items)
        Bp, Dp = _pow2_pad(B), _pow2_pad(D)
        items = np.zeros((Bp, Dp), np.int32)
        vals = np.zeros((Bp, Dp), np.float32)
        m = np.zeros((Bp, Dp), bool)
        items[:B, :D] = _host(rated_items)
        vals[:B, :D] = _host(strengths)
        m[:B, :D] = _host(mask)
        G = self._implicit_gramian()
        self._note(("ifold", Bp, Dp))
        return _solve_ials_bucket(
            self.T_i[:, :self.F], G, self._to_dev(items, torch.int64),
            self._to_dev(vals), self._to_dev(m, torch.bool),
            float(np.float32(alpha)), float(np.float32(reg)), solver="auto")

    def fold_in_implicit_and_recommend_padded(self, rated_items, strengths,
                                              mask, alpha: float = 40.0,
                                              reg: float = 0.1,
                                              k: int = 10):
        """Implicit hot path: exact ridge fold-in + masked scoring,
        dispatch only, (Bp, k) device out."""
        rows = self.fold_in_implicit_padded(rated_items, strengths, mask,
                                            alpha=alpha, reg=reg)
        Bp = int(rows.shape[0])
        return self.recommend_padded(
            rows, torch.zeros(Bp, device=self.device), rated_items, mask,
            k=k)

    def fold_in_and_recommend_padded(self, rated_items, ratings, mask,
                                     cfg: Config | None = None,
                                     k: int = 10):
        """Hot path: fold-in + scoring, dispatch only, (Bp, k) device out."""
        T_u = self.fold_in_padded(rated_items, ratings, mask, cfg=cfg)
        return self.recommend_padded(T_u[:, :self.F], T_u[:, self.F],
                                     rated_items, mask, k=k)

    def fold_in_and_recommend(self, rated_items, ratings, mask,
                              cfg: Config | None = None, k: int = 10):
        """The full predict-binary journey for a batch of new users."""
        B = int(np.shape(rated_items)[0])
        vals, idx = self.fold_in_and_recommend_padded(
            rated_items, ratings, mask, cfg=cfg, k=k)
        return _host(vals)[:B], _host(idx)[:B]

    # -- benchmarking ------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def bench_qps(self, batch_size: int = 512, k: int = 10,
                  n_batches: int = 20, seed: int = 0):
        """Measured recommend throughput (users/s) on random user rows."""
        rng = np.random.default_rng(seed)
        p = rng.normal(0, 1.0 / self.F,
                       (batch_size, self.F)).astype(np.float32)
        ub = rng.normal(0, 0.1, batch_size).astype(np.float32)
        rated = rng.integers(0, self.n_items,
                             (batch_size, 32)).astype(np.int32)
        rmask = np.ones((batch_size, 32), bool)
        pp, ubp = self._pad_rows(p, ub)
        self.recommend_padded(pp, ubp, rated, rmask, k=k)  # warm-up
        self._sync()
        t0 = time.perf_counter()
        for _ in range(n_batches):
            self.recommend_padded(pp, ubp, rated, rmask, k=k)
        self._sync()
        dt = time.perf_counter() - t0
        return batch_size * n_batches / dt
