"""Plain reference of the BPR cell: matrix factorization trained by
Bayesian Personalized Ranking (Rendle, Freudenthaler, Gantner and
Schmidt-Thieme, UAI 2009) on implicit interactions, evaluated by a sampled
AUC.  Plain torch, float64 tables, on any device; it imports nothing of the
port.

The score of item y for user u is p_u · q_y + b_y.  A triple (u, i, j) of a
user, an item the user interacted with and another item gives

    x_uij = p_u · (q_i − q_j) + b_i − b_j,
    loss  = −log σ(x_uij) + λ_P ‖p_u‖² / 2 + λ_Q ‖q‖² / 2 + λ_b b² / 2,

and a step of rate η moves each row against the gradient, with
e = σ(−x_uij): p_u += η (e (q_i − q_j) − λ_P p_u); q_i += η (e p_u −
λ_Q q_i), b_i += η (e − λ_b b_i); q_j −= η e p_u, b_j −= η e.

**The one departure from the paper.**  LearnBPR draws one triple uniformly
and updates the user's and both items' rows from it.  Here, as in the port
and in the TPU package, each pass draws its own triples and every update of
an iteration reads the tables as they were before it:

* the user pass: every user u with interactions draws i from them and j
  uniformly from the catalog, and updates p_u (and its bias, held at zero);
* the item-positive pass: every item y with raters draws a rater u and a
  uniform j, and takes y's positive update, with its regulariser;
* the item-negative pass: every item y draws a uniform user v and an item
  i of v's, and takes y's negative update (no regulariser).

The draws are frozen copies of the port's streams: the counter hash of
``mf_sgd.py`` under a key (two 32-bit words, ``(0, seed mod 2^32)``), each
stream's key separated by a threefry-2x32 ``fold_in`` of a tag, and each
stream's rule for turning a uniform u01 into a position or an id (a float32
product, truncated).  The AUC is the share of sampled pairs (a held-out
interaction against a uniform item) that the user's scores order right,
over the pairs NumPy's ``default_rng(seed)`` draws, as the port draws them.

Nothing here uses a matrix product, so no TF32 can enter; TF32 is switched
off all the same.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.mf_sgd import M32, _fmix32
from benchmark.reference.mf_sgd import init_tables as sgd_init_tables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


# -- keys and the counter stream ----------------------------------------------

def key_of(seed: int) -> tuple[int, int]:
    return 0, int(seed) & M32


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def fold_in(key, data: int) -> tuple[int, int]:
    """Threefry-2x32 (20 rounds, Salmon et al. 2011) of the block (0,
    data) under ``key``: the key of a stream."""
    k0, k1 = (int(k) & M32 for k in key)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = ks[0], ((int(data) & M32) + ks[1]) & M32
    for i in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def uniform(key, iteration: int, ids: torch.Tensor) -> torch.Tensor:
    """u01 (float32, 24 bits) of each id at ``iteration`` under ``key``."""
    k0, k1 = key
    inner = int(_fmix32(torch.tensor((int(iteration) & M32) ^ k1,
                                     dtype=torch.int64)))
    h = _fmix32((ids.to(torch.int64) & M32) ^ inner ^ k0)
    h = _fmix32((h + 0x9E3779B9) & M32)
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


def _ids(n: int, offset: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device) + int(offset)


def uniform_ids(key, iteration: int, n: int, n_range: int, offset: int,
                device) -> torch.Tensor:
    """``n`` ids uniform in [0, n_range): the stream's ids ``offset`` ..
    ``offset + n - 1``, u01 times the range in float32, truncated."""
    u01 = uniform(key, iteration, _ids(n, offset, device))
    prod = (u01 * torch.tensor(n_range, dtype=torch.int32,
                               device=device)).to(torch.int32)
    return torch.clamp(prod, max=n_range - 1).to(torch.int64)


def positions(key, iteration: int, start: torch.Tensor, length: torch.Tensor,
              offset: int):
    """(position, has) of one draw in each row [start, start + length):
    ``start + min(trunc(u01 · length), length − 1)``, the row's stream id
    its index plus ``offset``."""
    u01 = uniform(key, iteration, _ids(start.shape[0], offset, start.device))
    length = length.to(torch.int32)
    off = torch.minimum((u01 * length).to(torch.int32),
                        (length - 1).clamp(min=0))
    return start.to(torch.int64) + off.to(torch.int64), length > 0


def _at(flat: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``flat[pos]`` where an empty row's position may be past the end."""
    return flat[pos.clamp(max=max(flat.shape[0] - 1, 0))].to(torch.int64)


def draws(key, iteration: int, csr, it_csr, n_items: int) -> dict:
    """Every id iteration ``iteration`` samples from the user-major ``csr``
    and the item-major ``it_csr`` (``mf_als.transpose``: each item's
    raters in user order), by the five streams:

    * the users' items: the base key, user u's id u, a position in its row;
    * the users' uniform items: ``fold_in(key, 1)``, ids u;
    * the items' raters: the base key, item y's id U + y, a position in the
      item's raters in user order;
    * the items' uniform items: ``fold_in(key, 2)``, ids U + y;
    * the items' uniform users: ``fold_in(key, 3)``, ids U + I + y; and
      that user's item: ``fold_in(key, 4)``, ids 2U + y, a position in the
      user's row."""
    indptr, indices = csr[0].to(torch.int64), csr[1]
    it_ptr, it_rows = it_csr[0].to(torch.int64), it_csr[1]
    U, I = indptr.shape[0] - 1, n_items
    dev = indices.device
    lens = indptr[1:] - indptr[:-1]
    pos, has_u = positions(key, iteration, indptr[:-1], lens, 0)
    pos_y, has_y = positions(key, iteration, it_ptr[:-1],
                             it_ptr[1:] - it_ptr[:-1], U)
    v = uniform_ids(fold_in(key, 3), iteration, I, U, U + I, dev)
    pos_v, has_v = positions(fold_in(key, 4), iteration, indptr[:-1][v],
                             lens[v], 2 * U)
    return {"i_pos": _at(indices, pos), "has_u": has_u,
            "j_neg": uniform_ids(fold_in(key, 1), iteration, U, I, 0, dev),
            "u_of_y": _at(it_rows, pos_y), "has_y": has_y,
            "jn_y": uniform_ids(fold_in(key, 2), iteration, I, I, U, dev),
            "v": v, "iv": _at(indices, pos_v), "has_v": has_v}


# -- init ---------------------------------------------------------------------

def init_tables(n_users: int, n_items: int, n_factors: int, seed: int):
    """(P, Q, user bias, item bias) in float32 on the CPU: the SGD cell's
    draw (``mf_sgd.init_tables``), both biases then set to zero, since the
    score has no user bias and the item bias starts at zero."""
    P, Q, ub, ib = sgd_init_tables(n_users, n_items, n_factors, seed)
    return P, Q, torch.zeros_like(ub), torch.zeros_like(ib)


# -- one iteration ------------------------------------------------------------

def step(tables, csr, it_csr, hp, key, iteration: int,
         skip_users: torch.Tensor | None = None,
         item_negative: bool = True):
    """The tables after one iteration (new tensors), every read of the
    tables before it.  ``hp`` has ``lr``, ``P_reg``, ``Q_reg``, ``ub_reg``,
    ``ib_reg`` (``mf_sgd.Hyper``).  ``skip_users`` (bool) leaves those users
    out of the user pass, and ``item_negative=False`` leaves the
    item-negative pass out: planted faults."""
    P, Q, ub, ib = tables
    s = draws(key, iteration, csr, it_csr, Q.shape[0])
    has_u = s["has_u"]
    if skip_users is not None:
        has_u = has_u & ~skip_users
    lr = hp.lr

    # The user pass.
    i, j = s["i_pos"], s["j_neg"]
    d = Q[i] - Q[j]
    e = torch.where(has_u, torch.sigmoid(-((P * d).sum(1) + ib[i] - ib[j])),
                    0.0)
    P_new = torch.where(has_u[:, None],
                        P + lr * (e[:, None] * d - hp.P_reg * P), P)
    ub_new = torch.where(has_u, ub - lr * hp.ub_reg * ub, ub)

    # The item-positive pass.
    w, jy = P[s["u_of_y"]], s["jn_y"]
    e = torch.where(s["has_y"], torch.sigmoid(
        -((w * (Q - Q[jy])).sum(1) + ib - ib[jy])), 0.0)
    dq = torch.where(s["has_y"][:, None],
                     lr * (e[:, None] * w - hp.Q_reg * Q), 0.0)
    db = torch.where(s["has_y"], lr * (e - hp.ib_reg * ib), 0.0)

    # The item-negative pass.
    if item_negative:
        pv, iv = P[s["v"]], s["iv"]
        e = torch.where(s["has_v"], torch.sigmoid(
            -((pv * (Q[iv] - Q)).sum(1) + ib[iv] - ib)), 0.0)
        dq = dq - lr * e[:, None] * pv
        db = db - lr * e
    return P_new, Q + dq, ub_new, ib + db


# -- the eval -----------------------------------------------------------------

def auc_pairs(test, n_items: int, seed: int, n_pairs: int = 100_000):
    """(users, held-out items, uniform items) of the AUC's pairs, int64
    NumPy arrays: ``default_rng(seed)`` draws the test interactions, then
    the uniform items.  ``test`` has host ``indptr`` and ``indices``."""
    nnz = int(test.indices.shape[0])
    if nnz == 0:
        return tuple(np.zeros(0, np.int64) for _ in range(3))
    rng = np.random.default_rng(seed)
    sel = rng.integers(0, nnz, size=min(n_pairs, nnz))
    rows = np.repeat(np.arange(len(test.indptr) - 1), np.diff(test.indptr))
    neg = rng.integers(0, n_items, size=len(sel)).astype(np.int32)
    return (rows[sel].astype(np.int64), test.indices[sel].astype(np.int64),
            neg.astype(np.int64))


def auc(tables, pairs) -> float:
    """The share of pairs whose held-out item scores above the uniform
    item, in float64."""
    P, Q, _ub, ib = (t.to(torch.float64) for t in tables)
    if len(pairs[0]) == 0:
        return 0.5
    u, i, j = (torch.from_numpy(a).to(P.device) for a in pairs)
    pu = P[u]
    s_pos = (pu * Q[i]).sum(1) + ib[i]
    s_neg = (pu * Q[j]).sum(1) + ib[j]
    return float((s_pos > s_neg).to(torch.float64).mean())

