"""Plain reference of the SGD cells: biased matrix factorization trained by
cu2rec's sampled SGD, one update a user per iteration, first writer wins on
each item, evaluated by RMSE.  Plain torch, float64 tables, on any device;
it imports nothing of the port.

It follows the semantics that cu2rec defines (``sgd.cu``, ``training.cu``)
as the port makes them deterministic:

* init: every table Normal(0, 1/F), drawn in float32 from
  ``torch.Generator().manual_seed(seed)`` on the CPU in the order P, Q,
  user bias, item bias;
* the draw of user ``u`` at iteration ``t``: a counter hash of (key, t, u)
  to a uniform u01 in [0, 1) with 24 bits, the sampled position
  ``start + min(trunc(u01 * len), len - 1)`` (the product in float32);
* the item update's writer: of the users who sampled an item, the one of
  least priority ``(u - start_user) mod U``, ``start_user = (t * 250)
  mod U`` with the product wrapped to 32 signed bits (cu2rec's rotation);
* each update reads the tables as they were before the iteration.

Below each function is what it follows; the counter hash is a frozen copy
of the stream the port and the TPU package share.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
ROTATION = 250
INT32_MAX = 2 ** 31 - 1


# -- init ---------------------------------------------------------------------

def init_tables(n_users: int, n_items: int, n_factors: int, seed: int):
    """(P, Q, user_bias, item_bias) in float32 on the CPU."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32) \
            / float(n_factors)

    P = normal((n_users, n_factors))
    Q = normal((n_items, n_factors))
    return P, Q, normal((n_users,)), normal((n_items,))


# -- the sampling stream ------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return ((x * lo) + (((x * hi) & 0xFFFF) << 16)) & M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def uniform(seed: int, iteration: int, ids: torch.Tensor) -> torch.Tensor:
    """u01 of each id at ``iteration`` under the key of ``seed``: the key's
    words are (0, seed mod 2^32)."""
    k0, k1 = 0, int(seed) & M32
    inner = int(_fmix32(torch.tensor((int(iteration) & M32) ^ k1,
                                     dtype=torch.int64)))
    h = _fmix32((ids.to(torch.int64) & M32) ^ inner ^ k0)
    h = _fmix32((h + 0x9E3779B9) & M32)
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


def sample(seed: int, iteration: int, indptr: torch.Tensor,
           indices: torch.Tensor, data: torch.Tensor):
    """(item, rating, has) of each user's draw at ``iteration``."""
    start = indptr[:-1].to(torch.int64)
    length = (indptr[1:].to(torch.int64) - start).to(torch.int32)
    uids = torch.arange(start.shape[0], dtype=torch.int64,
                        device=indptr.device)
    u01 = uniform(seed, iteration, uids)
    off = torch.minimum((u01 * length).to(torch.int32),
                        (length - 1).clamp(min=0))
    pos = (start + off.to(torch.int64)).clamp(max=max(indices.shape[0] - 1,
                                                      0))
    has = length > 0
    items = torch.where(has, indices[pos].to(torch.int64), 0)
    return items, data[pos], has


def start_user(iteration: int, n_users: int) -> int:
    prod = (int(iteration) * ROTATION + 2 ** 31) % 2 ** 32 - 2 ** 31
    return prod % n_users


# -- one iteration ------------------------------------------------------------

class Hyper:
    """The step's scalars, each rounded to float32 as the configuration's
    values are when they reach the device."""

    def __init__(self, cfg: dict):
        def f32(x):
            return float(np.float32(x))

        self.lr = f32(cfg["learning_rate"])
        self.P_reg, self.Q_reg = f32(cfg["P_reg"]), f32(cfg["Q_reg"])
        self.ub_reg = f32(cfg["user_bias_reg"])
        self.ib_reg = f32(cfg["item_bias_reg"])


def step(tables, mu: float, csr, hp: Hyper, seed: int, iteration: int,
         skip_users: torch.Tensor | None = None):
    """The tables after one iteration (new tensors).  ``skip_users``, a
    bool mask, leaves those users out of the iteration altogether (their
    draw, their update and their bid for an item): a planted fault."""
    P, Q, ub, ib = tables
    U = P.shape[0]
    items, r, has = sample(seed, iteration, *csr)
    if skip_users is not None:
        has = has & ~skip_users
    r = r.to(P.dtype)
    q, bi = Q[items], ib[items]
    err = torch.where(has, r - (mu + ub + bi + (P * q).sum(1)), 0.0)
    P_new = torch.where(has[:, None],
                        P + hp.lr * (err[:, None] * q - hp.P_reg * P), P)
    ub_new = torch.where(has, ub + hp.lr * (err - hp.ub_reg * ub), ub)

    # The writer of each item: least priority among the users who drew it.
    s = start_user(iteration, U)
    prio = (torch.arange(U, device=P.device) - s) % U
    best = torch.full((Q.shape[0],), INT32_MAX, dtype=torch.int64,
                      device=P.device)
    best.scatter_reduce_(0, items[has], prio[has], reduce="amin")
    has_w = best != INT32_MAX
    w = torch.where(has_w, (best + s) % U, 0)
    pw, bw, rw = P[w], ub[w], r[w]
    err_w = torch.where(has_w, rw - (mu + bw + ib + (pw * Q).sum(1)), 0.0)
    Q_new = torch.where(has_w[:, None],
                        Q + hp.lr * (err_w[:, None] * pw - hp.Q_reg * Q), Q)
    ib_new = torch.where(has_w, ib + hp.lr * (err_w - hp.ib_reg * ib), ib)
    return P_new, Q_new, ub_new, ib_new


# -- the eval -----------------------------------------------------------------

def rmse(tables, mu: float, csr) -> float:
    """RMSE of the tables over the ratings of a CSR, in float64, in chunks
    of ratings whose gathered rows stay near 256 MiB."""
    P, Q, ub, ib = (t.to(torch.float64) for t in tables)
    chunk = max(1 << 16, (1 << 28) // (8 * P.shape[1]))
    indptr, indices, data = csr
    users = torch.repeat_interleave(
        torch.arange(indptr.shape[0] - 1, device=indices.device),
        (indptr[1:] - indptr[:-1]).to(torch.int64))
    sse = torch.zeros((), dtype=torch.float64, device=indices.device)
    for lo in range(0, indices.shape[0], chunk):
        u = users[lo:lo + chunk]
        i = indices[lo:lo + chunk].to(torch.int64)
        e = data[lo:lo + chunk].to(torch.float64) - (
            mu + ub[u] + ib[i] + (P[u] * Q[i]).sum(1))
        sse += (e * e).sum()
    return math.sqrt(float(sse) / max(indices.shape[0], 1))


def to_csr(split, device):
    """(indptr, indices, data) tensors of a host split on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (split.indptr, split.indices, split.data))
