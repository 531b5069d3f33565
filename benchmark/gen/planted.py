"""Planted-model ratings drawn on the card from a seed: the benchmark's own
generator of every configuration's data.

It draws what ``cu2rec_torch/data/synth.py::generate_planted`` draws, the
same model and noise, rewritten in torch so that it runs on the card in a
few large calls instead of in NumPy on the host:

    r(u, i) = mu + b*_u + b*_i + p*_u . q*_i + eps,   eps ~ N(0, noise)

with lognormal user activity and power-law item popularity (item 0 the most
popular).  The streams differ from the NumPy ones; the distributions are
the same.  The ratings are split into train and test by a random
permutation, each side is sorted by (user, item) on the card, and the two
sides come back as host CSR arrays, the port's input type.

A seed gives the same arrays on every run: every draw comes from one
``torch.Generator`` on the device, and every sort is stable.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Ratings a chunk of the rating draw: bounds the (chunk, rank) gathers.
CHUNK = 1 << 22


@dataclass
class Split:
    """One side of the split as host CSR arrays, sorted by (user, item)."""

    indptr: np.ndarray    # (n_users + 1,) int32
    indices: np.ndarray   # (nnz,) int32 item ids
    data: np.ndarray      # (nnz,) float32 ratings
    n_users: int
    n_items: int

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of a seed.  Any integer
    seed, also one above 2**32, maps to a 63-bit state."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(stream)) % (1 << 63))
    return g


def draw_ratings(sizes: dict, planted: dict, seed: int, device):
    """(users, items, ratings) on ``device``: ``n_ratings`` draws over
    ``n_users`` x ``n_items`` from the planted model of ``planted``."""
    U, I, R = sizes["n_users"], sizes["n_items"], sizes["n_ratings"]
    F = planted["rank"]
    g = generator(seed, 0, device)

    def normal(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=device) * std

    s = (planted["signal_std"] ** 2 / F) ** 0.25
    P, Q = normal(U, F, std=s), normal(I, F, std=s)
    ub = normal(U, std=planted["bias_std"][0])
    ib = normal(I, std=planted["bias_std"][1])
    # Lognormal user activity: users drawn by inverse CDF of their weights.
    w_u = torch.exp(normal(U, std=planted["user_sigma"])).to(torch.float64)
    cdf = torch.cumsum(w_u / w_u.sum(), 0)
    u01 = torch.rand(R, generator=g, device=device, dtype=torch.float64)
    users = torch.searchsorted(cdf, u01).clamp_(max=U - 1).to(torch.int32)
    del cdf, u01, w_u
    # Power-law popularity: numpy's power(a) is U(0,1)^(1/a).
    x = torch.rand(R, generator=g, device=device)
    items = (I * x.pow(1.0 / planted["item_power"])).to(torch.int32)
    items.clamp_(max=I - 1)
    del x
    ratings = torch.empty(R, dtype=torch.float32, device=device)
    for lo in range(0, R, CHUNK):
        hi = min(lo + CHUNK, R)
        u, i = users[lo:hi].long(), items[lo:hi].long()
        ratings[lo:hi] = (planted["mu"] + ub[u] + ib[i]
                          + (P[u] * Q[i]).sum(1)
                          + normal(hi - lo, std=planted["noise"]))
    return users, items, ratings


def _side(users, items, ratings, sel, U: int, I: int) -> Split:
    u, i, r = users[sel], items[sel], ratings[sel]
    key = u.long() * I + i.long()
    order = torch.sort(key, stable=True).indices
    u, i, r = u[order], i[order], r[order]
    indptr = torch.zeros(U + 1, dtype=torch.int64, device=u.device)
    indptr[1:] = torch.cumsum(torch.bincount(u.long(), minlength=U), 0)
    return Split(indptr=indptr.to(torch.int32).cpu().numpy(),
                 indices=i.cpu().numpy(), data=r.cpu().numpy(),
                 n_users=U, n_items=I)


def planted_split(cfg: dict, seed: int, device) -> tuple[Split, Split]:
    """(train, test) of a configuration's planted ratings from ``seed``.
    The test side holds ``test_ratings`` ratings where the configuration
    gives that count, else ``test_share`` of them."""
    sizes = cfg["sizes"]
    U, I, R = sizes["n_users"], sizes["n_items"], sizes["n_ratings"]
    users, items, ratings = draw_ratings(sizes, cfg["planted"], seed, device)
    n_test = sizes.get("test_ratings")
    if n_test is None:
        n_test = int(R * sizes["test_share"])
    perm = torch.randperm(R, generator=generator(seed, 1, device),
                          device=device)
    test = _side(users, items, ratings, perm[:n_test], U, I)
    train = _side(users, items, ratings, perm[n_test:], U, I)
    return train, test
