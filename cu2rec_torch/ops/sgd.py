"""SGD hyperparameters and the counter-based sampling stream.

The stream is the TPU package's ``counter_uniform`` (ops/sgd.py there),
reproduced bit for bit: the uniform draw for slot ``u`` at iteration ``t``
is a pure function of (key, t, u) — two chained murmur3 finalizer rounds —
so a batch of one reproduces the big-batch draws, and the fold-in samples
the same positions in both packages.

Torch on the CPU has no ``>>`` on uint32, so the arithmetic runs in int64
on values masked to 32 bits.  A 32-bit × 32-bit product can reach 2^64 and
would overflow signed int64; ``_mul32`` splits the constant into 16-bit
halves so that no partial product exceeds 2^48.

``fold_in`` derives a stream's key from the seed's as the TPU package's
threefry ``fold_in`` does (BPR separates its draws so); a key is two Python
integers on the host, so it computes in Python integers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF


class Hyper(NamedTuple):
    """Fold-in/SGD hyperparameter scalars, rounded to float32 as the TPU
    package's traced scalars are."""

    learning_rate: float
    P_reg: float
    Q_reg: float
    user_bias_reg: float
    item_bias_reg: float

    @classmethod
    def from_config(cls, cfg) -> "Hyper":
        return cls(*(float(np.float32(v)) for v in (
            cfg.learning_rate, cfg.P_reg, cfg.Q_reg,
            cfg.user_bias_reg, cfg.item_bias_reg)))


def prng_key(seed: int) -> tuple[int, int]:
    """The two 32-bit key words of a threefry ``PRNGKey(seed)`` as the TPU
    package makes it (64-bit integers off): ``(0, seed mod 2^32)`` for any
    integer seed, negative or above 2^32."""
    return 0, int(seed) & _M32


def _key_words(key) -> tuple[int, int]:
    """Key words from a ``prng_key`` pair, or any length-2 array/tensor of
    the words (e.g. the key data of a threefry key)."""
    if isinstance(key, torch.Tensor):
        key = key.tolist()
    k0, k1 = (int(k) for k in np.asarray(key).reshape(-1)[:2])
    return k0 & _M32, k1 & _M32


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


# Threefry-2x32's rotations: rounds 1-4 of each group of eight, then 5-8.
_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry_2x32(key, count) -> tuple[int, int]:
    """The 20-round Threefry-2x32 block cipher (Salmon et al. 2011) of one
    block ``count`` = (x0, x1) under ``key`` = (k0, k1), in Python integers
    masked to 32 bits: the TPU package's random-key arithmetic."""
    k0, k1 = _key_words(key)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (int(count[0]) + ks[0]) & _M32
    x1 = (int(count[1]) + ks[1]) & _M32
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def fold_in(key, data: int) -> tuple[int, int]:
    """A new key from ``key`` and a 32-bit integer ``data``: Threefry-2x32
    of the block (0, data), as the TPU package's ``fold_in`` of a threefry
    key computes it.  ``fold_in(prng_key(42), 1)`` is (64467757,
    2916123636)."""
    return threefry_2x32(key, (0, int(data) & _M32))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for int64 ``x`` in [0, 2^32) and a 32-bit constant,
    without any partial product above 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return ((x * lo) + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer: full-avalanche 32-bit integer mix (int64 lanes
    holding uint32 values)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def counter_uniform(key, iteration, uids: torch.Tensor) -> torch.Tensor:
    """Uniform [0,1) float32 as a pure function of (key, iteration, id).

    ``key`` is a ``prng_key`` pair; ``iteration`` an int (or 0-d tensor);
    ``uids`` an integer tensor of slot/user ids.
    """
    k0, k1 = _key_words(key)
    it = int(iteration) & _M32
    u = uids.to(torch.int64) & _M32
    inner = int(_fmix32(torch.tensor(it ^ k1, dtype=torch.int64)))
    h = _fmix32(u ^ inner ^ k0)
    h = _fmix32((h + 0x9E3779B9) & _M32)
    # 24 high bits → exact float32 in [0, 1)
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


INT32_MAX = 2 ** 31 - 1


def sample_positions(key, iteration, indptr: torch.Tensor,
                     user_offset: int = 0):
    """Per-row sampled CSR position (the curand draw of sgd.cu:31-37):
    ``(pos, has)``, both (n,), bit-equal to the TPU package's stream.

    A pure function of (key, iteration, global row id): row ``r`` draws
    with id ``r + user_offset`` (the twin item stream passes the user
    count).  ``pos`` is int64; rows with no ratings have ``has`` False and
    ``pos`` = their (empty) start."""
    start = indptr[:-1].to(torch.int64)
    length = (indptr[1:].to(torch.int64) - start).to(torch.int32)
    n = start.shape[0]
    uids = torch.arange(n, dtype=torch.int64, device=indptr.device) + \
        int(user_offset)
    u01 = counter_uniform(key, iteration, uids)
    # float32 product, truncated: the TPU package's (u01 * len).astype(int32)
    off = torch.minimum((u01 * length).to(torch.int32),
                        (length - 1).clamp(min=0))
    return start + off.to(torch.int64), length > 0


def _take(flat: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``flat[pos]`` with positions clamped into range: an empty row's
    position may equal ``len(flat)``; its value is masked by ``has``."""
    if flat.shape[0] == 0:
        return torch.zeros(pos.shape, dtype=flat.dtype, device=flat.device)
    return flat[pos.clamp(max=flat.shape[0] - 1)]


def sample_items(key, iteration, indptr: torch.Tensor, indices: torch.Tensor,
                 data: torch.Tensor, user_offset: int = 0):
    """One sampled (item, rating) per row of a CSR: ``(items, ratings,
    has)``.  ``items`` is int64; entries of rows without ratings are
    meaningless and masked by ``has``."""
    pos, has = sample_positions(key, iteration, indptr, user_offset)
    return _take(indices, pos).to(torch.int64), _take(data, pos), has


def rotated_priority(n_users_global: int, iteration: int, user_offset: int,
                     n_local: int, rotation: int = 250,
                     device=None) -> torch.Tensor:
    """Election priority of each local user at ``iteration`` (int64 values
    in [0, U)): the reference's ``start_user += 250`` rotation
    (training.cu:95-98; sgd.cu:27)."""
    start_user = start_user_of(iteration, n_users_global, rotation)
    uids = torch.arange(n_local, dtype=torch.int64, device=device) + \
        int(user_offset)
    return (uids - start_user) % n_users_global


def start_user_of(iteration: int, n_users: int, rotation: int = 250) -> int:
    """``(iteration * rotation) % n_users`` with the product wrapped to
    int32 first, as the TPU package's traced int32 arithmetic does."""
    prod = (int(iteration) * rotation + 2 ** 31) % 2 ** 32 - 2 ** 31
    return prod % n_users


def elect_winners(items: torch.Tensor, has: torch.Tensor, prio: torch.Tensor,
                  n_items: int):
    """Deterministic first-writer-wins election (replaces the racy
    ``early_bird`` flag of sgd.cu:47-50): the user of least priority among
    those who sampled item ``y`` wins ``y``.  Returns ``(best, cand)``:
    the per-item least priority (int32, ``INT32_MAX`` where nobody
    sampled the item) and each user's candidate priority."""
    cand = torch.where(has, prio.to(torch.int32),
                       torch.full_like(prio, INT32_MAX, dtype=torch.int32))
    best = torch.full((n_items,), INT32_MAX, dtype=torch.int32,
                      device=cand.device)
    idx = torch.where(has, items, torch.zeros_like(items))
    best.scatter_reduce_(0, idx, cand, reduce="amin")
    return best, cand


def win_mask(best: torch.Tensor, items: torch.Tensor, cand: torch.Tensor,
             has: torch.Tensor) -> torch.Tensor:
    idx = torch.where(has, items, torch.zeros_like(items))
    return has & (best[idx] == cand)


def sgd_step(P, Q, user_bias, item_bias, global_bias, items, ratings, has,
             win, hp: Hyper, *, train_items: bool = True,
             collision: str = "first_wins", q_rows=None,
             item_bias_rows=None):
    """One SGD update over unpacked tables given each user's sampled
    (item, rating): the TPU package's unpacked ``sgd_step``.

    Every read is of the pre-step tables (sgd.cu reads the error and every
    ``P_old``/``Q_old`` before its writes land), in float32 whatever the
    table dtype.  Returns ``(P, user_bias, dq, dib)``: the user side
    updated, and the item side's delta for each sampled row (zero for a
    losing user under first_wins; under mean divided by the item's count),
    in the table dtype, for ``apply_item_deltas``.  ``q_rows`` and
    ``item_bias_rows`` pass pre-gathered item rows; by default they are
    gathered from ``Q`` and ``item_bias`` here."""
    lr = hp.learning_rate
    dt = P.dtype
    idx = torch.where(has, items, torch.zeros_like(items))
    q = Q[idx] if q_rows is None else q_rows
    ib_g = item_bias[idx] if item_bias_rows is None else item_bias_rows
    Pf, qf = P.to(torch.float32), q.to(torch.float32)
    ubf, ibf = user_bias.to(torch.float32), ib_g.to(torch.float32)
    pred = global_bias + ubf + ibf + torch.sum(Pf * qf, dim=-1)
    err = torch.where(has, ratings - pred, 0.0)

    hasf = has[:, None]
    P_new = torch.where(hasf, Pf + lr * (err[:, None] * qf - hp.P_reg * Pf),
                        Pf).to(dt)
    ub_new = torch.where(has, ubf + lr * (err - hp.user_bias_reg * ubf),
                         ubf).to(dt)
    if not train_items:
        # Fold-in: Q and item_bias frozen (sgd.cu:61, 70).
        return P_new, ub_new, torch.zeros_like(q), torch.zeros_like(ib_g)

    dq = lr * (err[:, None] * Pf - hp.Q_reg * qf)
    dib = lr * (err - hp.item_bias_reg * ibf)
    if collision == "first_wins":
        dq = torch.where(win[:, None], dq, 0.0)
        dib = torch.where(win, dib, 0.0)
    elif collision == "mean":
        counts = torch.zeros(Q.shape[0], dtype=torch.float32,
                             device=Q.device)
        counts.index_add_(0, idx, has.to(torch.float32))
        denom = torch.clamp(counts, min=1.0)[idx]
        dq = torch.where(hasf, dq / denom[:, None], 0.0)
        dib = torch.where(has, dib / denom, 0.0)
    else:
        raise ValueError(f"unknown collision policy: {collision}")
    return P_new, ub_new, dq.to(dt), dib.to(dt)


def apply_item_deltas(Q, item_bias, items, dq, dib):
    """The per-row item deltas added into the tables: the TPU package's
    ``Q.at[items].add(dq)``, whose adds XLA on the CPU makes in the order
    of the rows, rounding to the table dtype after each
    (``ops/packed.py::scatter_add_in_order``; ``index_add_`` keeps no
    order on the card).  Under first_wins at most one row an item is
    nonzero, which equals the reference's winner overwrite."""
    from cu2rec_torch.ops.packed import scatter_add_in_order

    rows = torch.cat([dq, dib[:, None]], dim=1)
    out = scatter_add_in_order(
        torch.cat([Q, item_bias[:, None]], dim=1), items, rows)
    return out[:, :-1].contiguous(), out[:, -1].contiguous()
