"""Serving engines: batched recommendations and batched fold-in against a
frozen, item-sharded catalog — the reference's ``predict`` binary
(predict.cu:103-132) as a long-lived service.

The TPU package's ``ShardedServingEngine`` (serve/engine.py there), with the
same methods, padding and results:

  * the catalog lives once, as the packed item table (factors + bias per
    row, ops/packed.py), zero-padded to a multiple of ``n_ip`` rows and cut
    into ``n_ip`` item blocks, shard s holding rows [s·I_loc, (s+1)·I_loc);
  * ``recommend`` scores a user batch against each shard's block in item
    chunks with a running top-k merge (the live score tile is bounded
    whatever the batch size), then merges the shards' (B, k) candidates by
    global id into one top-k — the merge the reference did with a CPU
    ``std::sort`` (predict.cu:61);
  * ``fold_in`` learns (p_row, user_bias) for a batch of new users against
    the frozen catalog (is_train=false semantics, sgd.cu:61,70): per
    iteration each user samples one of its ratings from the counter-based
    stream keyed by batch slot, and only the user rows update
    (``fold_in_steps``; on the card all iterations are one launch of
    kernel K0c, ops/cuda_foldin.py).  Over several shards the rows of
    every rated item are assembled once a fold-in, each shard writing the
    rows it owns (zero elsewhere) and their sum completing them;
  * ``fold_in_implicit`` solves the iALS normal equations for a batch of
    new users exactly: the Gramian is the shards' YᵀY summed, the rated
    rows are assembled as in ``fold_in``, and kernel K1 solves
    (ops/cuda_linalg.py);
  * batches are padded to powers of two, as in the TPU package, and
    ``_programs`` records each padded signature the first time it runs.

The shards are held in one of two ways, behind one shard body:

  * one process, a device for each shard (``devices=[...]``, devices may
    repeat): the shards' candidates and partial rows move to the first
    (lead) device as device-to-device copies, where they are joined in
    shard order;
  * a ``torch.distributed`` rank for each shard (``mesh=make_mesh(1,
    n_ip)``, parallel/sharded.py): each rank holds its block only, the
    candidates are assembled over the ``ip`` axis (``Axis.assemble_``,
    exact) and the partial rows and Grams summed over it (``Axis.sum_``);
    every rank returns the same result.

``ServingEngine`` is the one-shard case on one device.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cu2rec_torch.models.state import MFModel
from cu2rec_torch.ops.als import _ridge_finish
from cu2rec_torch.ops.ials import gramian, ials_rows_system
from cu2rec_torch.ops.packed import _reg_vectors, pack
from cu2rec_torch.ops.sgd import Hyper, _key_words, counter_uniform, prng_key
from cu2rec_torch.ops.topk import _POS_HUGE, NEG_INF
from cu2rec_torch.utils.config import Config
from cu2rec_torch.utils.device import resolve_device


# A packed fold-in request: (Bp, Dp) ids, ratings and mask in one byte
# buffer, each from byte a·Bp·Dp to b·Bp·Dp: (a, b, torch dtype, NumPy
# dtype).
REQUEST_LAYOUT = ((0, 4, torch.int32, np.int32),
                  (4, 8, torch.float32, np.float32),
                  (8, 9, torch.bool, np.bool_))


def _pow2_pad(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def chunk_width(n_rows: int, B: int, k: int, override: int | None) -> int:
    """The catalog chunk width C of a scan over ``n_rows`` items: the live
    (B, C) score tile stays under ~512 MB (C ≥ 8192), never below k, unless
    ``override`` sets it."""
    return min(n_rows, max(k, override if override
                           else max(8192, (128 << 20) // max(B, 1) // 128
                                    * 128)))


def shard_topk(pr, ub, mu: float, Y, ib, offset: int, n_real: int, rated,
               rmask, k: int, C: int):
    """One item block's masked top-k: ``(vals, ids)`` (B, k), ids global.

    ``Y`` (I_loc, F) and ``ib`` (I_loc,) are the block's factors and
    biases, its first row the global item ``offset``; global ids at or past
    ``n_real`` are padding and score ``NEG_INF``, as do the ``rated`` items
    (B, R) the block holds where ``rmask``.  The block is scanned in chunks
    of C rows with a running top-k merge; the last chunk starts early
    (clamped) rather than past the block, and its overlap is masked.  A
    block of fewer than k rows pads its candidates with ``NEG_INF`` and id
    0."""
    B = pr.shape[0]
    I_loc = Y.shape[0]
    n_chunks = -(-I_loc // C)
    k_loc = min(k, C)
    pad_from = n_real - offset            # first local padding row
    neg = float(NEG_INF)
    vals = torch.full((B, k), neg, dtype=torch.float32, device=pr.device)
    idx = torch.zeros((B, k), dtype=torch.int64, device=pr.device)
    for c in range(n_chunks):
        c0 = min(c * C, I_loc - C)
        sc = pr @ Y[c0:c0 + C].to(torch.float32).T
        sc = (sc + mu + ub[:, None]
              + ib[c0:c0 + C].to(torch.float32)[None, :])
        if c0 < c * C:
            sc[:, :c * C - c0] = neg
        if pad_from < c0 + C:
            sc[:, max(pad_from - c0, 0):] = neg
        loc = rated - offset - c0
        in_chunk = rmask & (loc >= 0) & (loc < C)
        cols = loc.clamp(0, C - 1)
        sc.scatter_reduce_(1, cols, torch.where(in_chunk, neg, _POS_HUGE),
                           reduce="amin")
        v, i = torch.topk(sc, k_loc, dim=1)
        i = i + (offset + c0)
        if k_loc < k:
            v = torch.nn.functional.pad(v, (0, k - k_loc), value=neg)
            i = torch.nn.functional.pad(i, (0, k - k_loc))
        vals, idx = merge_topk(torch.cat([vals, v], dim=1),
                               torch.cat([idx, i], dim=1), k)
    return vals, idx


def merge_topk(vals, ids, k: int):
    """The top k of candidate scores ``vals`` (B, n) and their ``ids``:
    a stable descending sort, so that equal scores keep their candidates'
    order (earlier chunks and lower shards first)."""
    vals, pos = torch.sort(vals, dim=1, descending=True, stable=True)
    return vals[:, :k], torch.gather(ids, 1, pos[:, :k])


def assemble_topk(vals, ids, axis, index: int, k: int):
    """The top k over the ranks of ``axis`` of each rank's (B, k)
    candidates (``index`` this rank's place): a zero-filled (2, B, n·k)
    buffer of 4-byte words, scores as their bits and ids as int32, each
    rank writing its slot, assembled exactly over the axis."""
    B = vals.shape[0]
    buf = torch.zeros((2, B, axis.size * k), dtype=torch.int32,
                      device=vals.device)
    buf[0, :, index * k:(index + 1) * k] = vals.contiguous().view(
        torch.int32)
    buf[1, :, index * k:(index + 1) * k] = ids.to(torch.int32)
    axis.assemble_(buf)
    return merge_topk(buf[0].view(torch.float32), buf[1].to(torch.int64), k)


def compact_ratings(index, vals, mask):
    """Each slot's masked-in positions moved to the front in their order
    (a stable compaction): ``(index, vals, lens)``, index and vals gathered
    to (Bp, Dp), position p < lens[b] of slot b holding the column of the
    p-th set entry of ``mask[b]``."""
    mask = mask.to(torch.bool)
    order = torch.sort((~mask).to(torch.uint8), dim=1, stable=True).indices
    return (torch.gather(index, 1, order), torch.gather(vals, 1, order),
            mask.sum(dim=1))


def fold_in_steps(T_u, table, index, vals, mask, mu: float, hp: Hyper,
                  key, n_steps: int, F: int) -> torch.Tensor:
    """``n_steps`` fold-in SGD iterations of the packed (Bp, W) float32
    user rows ``T_u`` against a frozen row table: the plain version of
    kernel K0c (``ops/cuda_foldin.py``), the body of the TPU package's
    ``ShardedServingEngine._foldin_program`` loop.

    ``table`` (R, W) float32 or bf16, its rows read as float32; ``index``
    (Bp, Dp) integer, slot b's column d naming the row
    ``table[index[b, d]]``; ``vals`` (Bp, Dp) float32 ratings; ``mask``
    (Bp, Dp) bool, the valid columns of each slot in the request's order,
    holes allowed (masked-out entries are never read as rows).  The valid
    columns are compacted to the front (``compact_ratings``), as the TPU
    package compacts them on the host, so that slot b has ``len`` valid
    positions.  At iteration t slot b draws position
    ``min(⌊u·len⌋, len − 1)``, u = ``counter_uniform(key, t, b)``, and
    takes one SGD step of its row towards the sampled row (the item side
    frozen); a slot with ``len`` 0 is left unchanged.  Returns new rows;
    ``T_u`` is not changed."""
    W = T_u.shape[1]
    device = T_u.device
    index, vals, lens = compact_ratings(index.to(torch.int64), vals, mask)
    factor, biascol, reg_u, _ = _reg_vectors(hp, F, W, device)
    has = lens > 0
    last = (lens - 1).clamp(min=0)
    slots = torch.arange(T_u.shape[0], device=device)
    lr = hp.learning_rate
    for t in range(n_steps):
        u01 = counter_uniform(key, t, slots)
        idx = torch.minimum((u01 * lens).to(torch.int64), last)
        # An empty slot reads row 0: its column 0 may hold anything.
        it_b = torch.where(has, torch.gather(index, 1, idx[:, None])[:, 0],
                           0)
        rat_b = torch.gather(vals, 1, idx[:, None])[:, 0]
        row_i = table[it_b].to(torch.float32)
        ihat = row_i * factor + biascol
        pred = mu + torch.sum(T_u * ihat, dim=-1) + row_i[:, F]
        err = torch.where(has, rat_b - pred, 0.0)
        du = lr * (err[:, None] * ihat - reg_u * T_u)
        T_u = torch.where(has[:, None], T_u + du, T_u)
    return T_u if n_steps > 0 else T_u.clone()


class ShardedServingEngine:
    """Long-lived serving state over an item-sharded catalog: one process
    with a device for each shard (``devices``; default every CUDA device),
    or a rank for each shard (``mesh``, the ``ip`` axis of
    ``parallel.sharded.make_mesh``)."""

    def __init__(self, model: MFModel, devices=None, mesh=None,
                 chunk_items: int | None = None):
        # ``chunk_items`` overrides the auto-sized catalog chunk width C in
        # the scoring scan (testing/tuning knob; must be >= any k served).
        # None → the ~512 MB-tile formula of ``chunk_width``.
        if mesh is not None and devices is not None:
            raise ValueError("give the engine devices or a mesh, not both")
        self.mesh = mesh
        if mesh is not None:
            self.n_ip = mesh.n_ip
            held = {mesh.ip_index: mesh.device}
        else:
            if devices is None:
                devices = [torch.device("cuda", i)
                           for i in range(max(torch.cuda.device_count(), 1))]
            devs = [resolve_device(d) for d in devices]
            if not devs:
                raise ValueError("the engine needs at least one device")
            self.n_ip = len(devs)
            held = dict(enumerate(devs))
        self.device = next(iter(held.values()))   # the lead device
        self.chunk_items = chunk_items
        self.n_items = model.n_items
        self.F = model.n_factors
        self.mu = float(model.global_bias)
        pm = pack(model)
        self.W = pm.width
        self.I_pad = -(-self.n_items // self.n_ip) * self.n_ip
        self.I_loc = self.I_pad // self.n_ip
        T_i = torch.nn.functional.pad(
            pm.T_i, (0, 0, 0, self.I_pad - self.n_items))
        # (global offset of the block's first row, the block on its device)
        self.shards = [(s * self.I_loc, T_i[s * self.I_loc:(s + 1)
                                            * self.I_loc].to(d).contiguous())
                       for s, d in held.items()]
        # Known-user tables stay on the host (numpy): a request's row lookup
        # is a host gather, and the device sees only the padded batch.
        self.P = _host(model.P).astype(np.float32)
        self.user_bias = _host(model.user_bias).astype(np.float32)
        self._programs: dict = {}

    @property
    def T_i(self) -> torch.Tensor:
        """The packed block of the first shard this process holds (the
        whole catalog when ``n_ip`` = 1)."""
        return self.shards[0][1]

    @property
    def devices(self) -> list:
        """The device of each shard this process holds, in shard order."""
        return [T.device for _, T in self.shards]

    def _note(self, key) -> None:
        self._programs.setdefault(key, True)

    def _to_dev(self, x, dtype=torch.float32) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, dtype)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device,
                                                            dtype)

    def _sum(self, parts) -> torch.Tensor:
        """The shards' partial tensors summed on the lead device (over the
        ``ip`` axis in rank mode), in shard order.  Where one shard alone
        writes an element, the sum is that shard's bits."""
        if self.mesh is not None:
            return self.mesh.ip.sum_(parts[0])
        out = parts[0].to(self.device)
        for p in parts[1:]:
            out = out + p.to(self.device)
        return out

    def _rows(self, ids, F: int | None = None) -> torch.Tensor:
        """float32 rows (the first ``F`` columns, or all W) of the global
        item ``ids`` (any shape, on the lead device), assembled over the
        shards: each writes the rows it owns, zero elsewhere."""
        parts = []
        for off, T in self.shards:
            T = T if F is None else T[:, :F]
            if self.n_ip == 1:
                parts.append(T[ids].to(torch.float32))
                continue
            loc = ids.to(T.device) - off
            owned = (loc >= 0) & (loc < self.I_loc)
            rows = T[loc.clamp(0, self.I_loc - 1)].to(torch.float32)
            parts.append(torch.where(owned[..., None], rows, 0.0))
        return self._sum(parts)

    # -- recommendation ---------------------------------------------------
    def _recommend(self, pr, ub, rated, rmask, k: int):
        """Masked top-k over the catalog for a padded batch: each shard's
        block scanned (``shard_topk``), then the shards' candidates merged
        by global id."""
        C = chunk_width(self.I_loc, pr.shape[0], k, self.chunk_items)
        rated = self._to_dev(rated, torch.int64)
        rmask = self._to_dev(rmask, torch.bool)
        parts = []
        for off, T in self.shards:
            d = T.device
            parts.append(shard_topk(
                pr.to(d), ub.to(d), self.mu, T[:, :self.F], T[:, self.F],
                off, self.n_items, rated.to(d), rmask.to(d), k, C))
        if self.mesh is not None:
            return assemble_topk(*parts[0], self.mesh.ip,
                                 self.mesh.ip_index, k)
        if len(parts) == 1:
            return parts[0]
        return merge_topk(torch.cat([v.to(self.device) for v, _ in parts], 1),
                          torch.cat([i.to(self.device) for _, i in parts], 1),
                          k)

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
        tensors (scores, item ids) on the lead device without waiting for
        the device.

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
    def _fold_in(self, T_u, items, vals, valid, hp: Hyper, key,
                 n_steps: int):
        """``n_steps`` fold-in SGD iterations of the packed (Bp, W) user
        rows ``T_u`` against the frozen catalog, the request's (Bp, Dp)
        ``items``, ``vals`` and ``valid`` mask in its own column order:
        ``fold_in_steps`` on the CPU, kernel K0c (one launch) on the card.
        One shard samples its block by item id; over several, the rows of
        every rated item are assembled once (``_rows``: one sum over the
        shards, or one all_reduce over ``ip``) and the fold-in samples that
        (Bp·Dp, W) table by position."""
        from cu2rec_torch.ops.cuda_foldin import fold_in_cuda

        Bp, Dp = items.shape
        if self.n_ip == 1:
            table, index = self.T_i, items
        else:
            table = self._rows(items).reshape(Bp * Dp, self.W)
            index = torch.arange(Bp * Dp, dtype=torch.int32,
                                 device=self.device).reshape(Bp, Dp)
        run = fold_in_cuda if T_u.device.type == "cuda" else fold_in_steps
        return run(T_u, table, index, vals, valid, self.mu, hp, key,
                   n_steps, self.F)

    def fold_in(self, rated_items, ratings, mask, cfg: Config | None = None,
                key=None, init_rows=None):
        """Batched fold-in: learn (p_row, user_bias) for B new users with
        the catalog frozen.  Returns host arrays (P_rows (B, F), ub (B,)).

        Per-slot sample streams are counter-based on the batch slot, so a
        batch of one reproduces the single-user path exactly.
        ``init_rows=(P0 (B,F), ub0 (B,))`` overrides the seeded
        Normal(0, 1/F) initialization (util.cu:124-132)."""
        B = int(np.shape(rated_items)[0])
        T_u = self._download(self.fold_in_padded(
            rated_items, ratings, mask, cfg=cfg, key=key,
            init_rows=init_rows))[:B, :self.F + 1].copy()
        return T_u[:, :self.F], T_u[:, self.F]

    def fold_in_padded(self, rated_items, ratings, mask,
                       cfg: Config | None = None, key=None,
                       init_rows=None):
        """Hot-path variant: dispatch only; returns the UNTRIMMED packed
        (Bp, W) user table as a device tensor.  ``key`` is a pair of key
        words (``ops.sgd.prng_key``); default ``prng_key(cfg.seed)``.

        The request goes to the device as it arrives, masked entries in
        place: its ids, ratings and mask are padded into one host buffer
        (pinned on the card) and copied once; the fold-in finds each
        slot's valid columns itself (``fold_in_steps``, K0c)."""
        cfg = cfg or Config()
        rated = _host(rated_items)
        m = _host(mask).astype(bool, copy=False)
        B, D = rated.shape
        Bp, Dp = _pow2_pad(B), _pow2_pad(D)
        # K0c reads the catalog at the masked-in ids unchecked: hold them
        # here, on the host, before any launch (masked entries may hold
        # anything, so only a request with an id out of range is gathered).
        if rated.size and (rated.min() < 0 or rated.max() >= self.n_items):
            live = rated[m]
            if live.size and (live.min() < 0
                              or live.max() >= self.n_items):
                raise ValueError(f"fold-in item ids must lie in [0, "
                                 f"{self.n_items}); got {live.min()}.."
                                 f"{live.max()}")
        items, vals, valid = self._upload(
            self._pack_request(rated, _host(ratings), m, Bp, Dp), Bp, Dp)
        key = prng_key(cfg.seed) if key is None else _key_words(key)
        if init_rows is not None:
            P0, ub0 = init_rows
            T_u0 = self._host_empty((Bp, self.W), torch.float32).zero_()
            T_u0.numpy()[:B, :self.F] = _host(P0)
            T_u0.numpy()[:B, self.F] = _host(ub0)
            T_u0 = T_u0.to(self.device, non_blocking=True)
        else:
            T_u0 = self._default_init(Bp, key)
        self._note(("fold", Bp, Dp))
        return self._fold_in(T_u0, items, vals, valid, Hyper.from_config(cfg),
                             key, int(cfg.total_iterations))

    def _host_empty(self, shape, dtype) -> torch.Tensor:
        """A host tensor for a copy to or from the lead device: pinned when
        that is a CUDA device, so that the copy runs without the host."""
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    @staticmethod
    def _request_views(buf, Bp: int, Dp: int):
        """The (Bp, Dp) int32 ids, float32 ratings and bool mask that
        ``_pack_request`` lays out in one byte buffer."""
        n = Bp * Dp
        return tuple(buf[a * n:b * n].view(dtype).view(Bp, Dp)
                     for a, b, dtype, _ in REQUEST_LAYOUT)

    def _pack_request(self, rated, ratings, m, Bp: int, Dp: int):
        """A fold-in request's (B, D) ids, ratings and mask, padded to
        (Bp, Dp) (masked out) in one host byte buffer."""
        B, D = rated.shape
        n = Bp * Dp
        buf = self._host_empty(REQUEST_LAYOUT[-1][1] * n, torch.uint8)
        raw = buf.numpy()
        for (a, b, _, dtype), src in zip(REQUEST_LAYOUT, (rated, ratings, m)):
            view = raw[a * n:b * n].view(dtype).reshape(Bp, Dp)
            view[:B, :D] = src
            view[:B, D:] = 0
            view[B:] = 0
        return buf

    def _upload(self, buf, Bp: int, Dp: int):
        """The packed request on the lead device: one copy, which does not
        wait for the host from a pinned buffer."""
        return self._request_views(buf.to(self.device, non_blocking=True),
                                   Bp, Dp)

    def _download(self, x: torch.Tensor) -> np.ndarray:
        """``x`` on the host: one copy into pinned memory from a CUDA
        device, then a wait for the device's stream."""
        if x.device.type != "cuda":
            return _host(x)
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x, non_blocking=True)
        torch.cuda.current_stream(x.device).synchronize()
        return out.numpy()

    def _default_init(self, Bp: int, key):
        """Normal(0, 1/F) rows from a CPU ``torch.Generator`` seeded with
        the 64-bit key — the same draw on every device — drawn into a host
        tensor (pinned for a CUDA device) and copied to the lead device.
        Each row draws a multiple of 16 values (torch's CPU normal
        transform works in blocks of 16), so row b's draw does not depend
        on Bp and a batch of one reproduces the big-batch init."""
        F, W = self.F, self.W
        k0, k1 = key
        gen = torch.Generator().manual_seed((k0 << 32) | k1)
        draw = torch.randn((Bp, -(-(F + 1) // 16) * 16), generator=gen)
        T = self._host_empty((Bp, W), torch.float32)
        T[:, :F + 1] = draw[:, :F + 1] / F
        T[:, F + 1:] = 0.0
        self._note(("init", Bp))
        return T.to(self.device, non_blocking=True)

    # -- implicit (iALS) fold-in ------------------------------------------
    def _implicit_gramian(self):
        """G = YᵀY over the catalog, the shards' block Grams summed (the
        padding rows are zero), computed once per engine (the catalog is
        frozen) and shared by every implicit fold-in solve."""
        G = self._programs.get(("igram",))
        if G is None:
            G = self._sum([gramian(T[:, :self.F]) for _, T in self.shards])
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
        the UNTRIMMED (Bp, F) rows as a device tensor on the lead device.
        The solve is K1 on a CUDA device (``ops.als._ridge_finish``), on
        the lead device or on every rank."""
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
        q = self._rows(self._to_dev(items, torch.int64), self.F)
        return _ridge_finish(*ials_rows_system(
            q, G, self._to_dev(vals), self._to_dev(m, torch.bool),
            float(np.float32(alpha)), float(np.float32(reg))))

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
        for d in {d for d in self.devices if d.type == "cuda"}:
            torch.cuda.synchronize(d)

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


class ServingEngine(ShardedServingEngine):
    """Long-lived serving state on one device (one item shard)."""

    def __init__(self, model: MFModel, device=None,
                 chunk_items: int | None = None):
        super().__init__(model, devices=[device], chunk_items=chunk_items)
