"""Planted-model synthetic ratings — scale and quality validation data.

The port's own copy of the TPU package's ``data/synth.py``: pure NumPy on
the same ``default_rng`` calls in the same order, so every array is
bit-identical to the TPU package's for the same arguments.  Ratings are
drawn from a planted biased-MF model, the model family the trainers fit
(reference util.cu:199-204):

    r(u,i) = mu + b*_u + b*_i + p*_u · q*_i + eps,   eps ~ N(0, noise)

so the Bayes-optimal test RMSE is known (``noise``).  Degrees follow a
power-law item popularity and lognormal user activity (MovieLens/Netflix
shapes).  ``generate_planted_implicit`` is the implicit-feedback twin: the
signal is in which pairs are observed, and its ceiling is the oracle AUC.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cu2rec_torch.data import native


@dataclass
class PlantedData:
    users: np.ndarray      # (R,) int32, 0-based
    items: np.ndarray      # (R,) int32, 0-based
    ratings: np.ndarray    # (R,) float32
    noise_floor: float     # Bayes test RMSE (== noise unless clipped)
    mu: float
    P: np.ndarray          # planted (U, F)
    Q: np.ndarray          # planted (I, F)
    user_bias: np.ndarray
    item_bias: np.ndarray


def generate_planted(n_users: int, n_items: int, n_ratings: int,
                     n_factors: int = 20, noise: float = 0.30,
                     seed: int = 0, mu: float = 3.6,
                     signal_std: float = 0.5,
                     bias_std: tuple[float, float] = (0.35, 0.45),
                     item_power: float = 0.3,
                     user_sigma: float = 1.0,
                     clip: tuple[float, float] | None = None,
                     chunk: int = 1 << 24) -> PlantedData:
    """Draw ``n_ratings`` (user, item, rating) triplets from a planted
    biased-MF model.

    ``signal_std`` targets the std of the p·q term (factor scale
    (signal_std²/F)^(1/4)); ``item_power`` is the ``rng.power`` shape of
    item popularity (0.3 ≈ MovieLens head concentration); ``user_sigma``
    the lognormal shape of user activity.  ``clip`` censors ratings to a
    range, which makes the floor unknown (NaN).
    """
    rng = np.random.default_rng(seed)
    F = n_factors
    s = (signal_std ** 2 / F) ** 0.25
    P = rng.normal(0, s, (n_users, F)).astype(np.float32)
    Q = rng.normal(0, s, (n_items, F)).astype(np.float32)
    ub = rng.normal(0, bias_std[0], n_users).astype(np.float32)
    ib = rng.normal(0, bias_std[1], n_items).astype(np.float32)

    # Degree structure: lognormal user activity × power-law item popularity.
    w_u = rng.lognormal(0.0, user_sigma, n_users)
    cdf_u = np.cumsum(w_u / w_u.sum())
    users = np.searchsorted(cdf_u, rng.random(n_ratings)).astype(np.int32)
    users = np.minimum(users, n_users - 1)
    items = (n_items * rng.power(item_power, n_ratings)).astype(np.int32)
    items = np.minimum(items, n_items - 1)

    ratings = np.empty(n_ratings, dtype=np.float32)
    for lo in range(0, n_ratings, chunk):
        hi = min(lo + chunk, n_ratings)
        u, i = users[lo:hi], items[lo:hi]
        r = (mu + ub[u] + ib[i] + np.einsum("rf,rf->r", P[u], Q[i])
             + rng.normal(0, noise, hi - lo).astype(np.float32))
        ratings[lo:hi] = r
    floor = noise
    if clip is not None:
        ratings = np.clip(ratings, clip[0], clip[1])
        floor = float("nan")
    return PlantedData(users=users, items=items, ratings=ratings,
                       noise_floor=floor, mu=mu, P=P, Q=Q,
                       user_bias=ub, item_bias=ib)


def generate_planted_implicit(n_users: int, n_items: int, n_ratings: int,
                              n_factors: int = 20, seed: int = 0,
                              signal_std: float = 2.0,
                              bias_std: float = 0.45,
                              user_sigma: float = 1.0,
                              chunk_users: int = 2048,
                              oracle_samples: int = 200_000):
    """Implicit-feedback planted model: each user's observed items are drawn
    from a per-user softmax over the planted affinity

        a(u, i) = p*_u · q*_i + b*_i,      i ~ softmax_i a(u, ·)

    with every observation rated 1.0.  The ceiling is the oracle AUC,
    P(a(u, i⁺) > a(u, j)) for i⁺ from the model and j uniform, scored by the
    planted parameters and estimated by Monte Carlo.

    Returns ``(PlantedData, oracle_auc)``.  Repeated (u, i) draws are
    deduplicated (first draw kept), so there can be fewer than
    ``n_ratings`` pairs; ``noise_floor`` is NaN.
    """
    rng = np.random.default_rng(seed)
    F = n_factors
    s = (signal_std ** 2 / F) ** 0.25
    P = rng.normal(0, s, (n_users, F)).astype(np.float32)
    Q = rng.normal(0, s, (n_items, F)).astype(np.float32)
    ib = rng.normal(0, bias_std, n_items).astype(np.float32)

    w_u = rng.lognormal(0.0, user_sigma, n_users)
    counts = rng.multinomial(n_ratings, w_u / w_u.sum())
    users = np.repeat(np.arange(n_users, dtype=np.int32),
                      counts).astype(np.int32)

    items = np.empty(n_ratings, dtype=np.int32)
    oracle_hits = 0
    oracle_tot = 0
    per_chunk_oracle = max(1, oracle_samples // max(1, n_users // chunk_users))
    pos = 0
    for lo in range(0, n_users, chunk_users):
        hi = min(lo + chunk_users, n_users)
        c = hi - lo
        logits = P[lo:hi] @ Q.T + ib                       # (c, I)
        logits -= logits.max(axis=1, keepdims=True)
        np.exp(logits, out=logits)
        cdf = np.cumsum(logits, axis=1, dtype=np.float64)
        cdf /= cdf[:, -1:]
        n_chunk = int(counts[lo:hi].sum())
        # Per-row categorical sampling: each row's cdf offset into its own
        # unit interval, one flat searchsorted for all rows.
        flat_cdf = (cdf + np.arange(c, dtype=np.float64)[:, None]).ravel()
        rows = np.repeat(np.arange(c), counts[lo:hi])
        u01 = rng.random(n_chunk) + rows
        flat_pos = np.searchsorted(flat_cdf, u01)
        drawn = (flat_pos - rows.astype(np.int64) * n_items).astype(np.int32)
        # A draw of exactly 0.0 lands on the previous row's last entry
        # (drawn == -1): clip both ends.
        items[pos:pos + n_chunk] = np.clip(drawn, 0, n_items - 1)
        pos += n_chunk
        # Oracle-AUC Monte Carlo on this chunk's users.
        m = min(per_chunk_oracle, c)
        sel = rng.integers(0, c, size=m)
        su = rng.random(m) + sel
        p_items = np.clip(
            (np.searchsorted(flat_cdf, su) - sel.astype(np.int64) * n_items),
            0, n_items - 1)
        n_items_draw = rng.integers(0, n_items, size=m)
        a = P[lo + sel]
        s_pos = np.einsum("mf,mf->m", a, Q[p_items]) + ib[p_items]
        s_neg = np.einsum("mf,mf->m", a, Q[n_items_draw]) + ib[n_items_draw]
        oracle_hits += int((s_pos > s_neg).sum())
        oracle_tot += m

    # Dedupe repeated (u, i) draws, so that no pair lands on both sides of a
    # later train/test split.
    keys = users.astype(np.int64) * n_items + items
    _, first = np.unique(keys, return_index=True)
    first.sort()
    users, items = users[first], items[first]
    ratings = np.ones(len(users), dtype=np.float32)
    data = PlantedData(users=users, items=items, ratings=ratings,
                       noise_floor=float("nan"), mu=0.0, P=P, Q=Q,
                       user_bias=np.zeros(n_users, np.float32),
                       item_bias=ib)
    return data, oracle_hits / max(1, oracle_tot)


def write_planted_csv(data: PlantedData, path: str) -> None:
    """Write the triplets as a standard ratings CSV (1-based ids, header,
    ratings to three decimals), through the native parallel writer unless
    the native path is off (``data/native.py``; the loop below writes the
    same bytes)."""
    if native.available():
        native.native_write_ratings(path, data.users, data.items,
                                    data.ratings)
        return
    with open(path, "w") as f:
        f.write("userId,itemId,rating\n")
        for u, i, r in zip(data.users, data.items, data.ratings):
            f.write(f"{u + 1},{i + 1},{r:.3f}\n")


def split_arrays(users: np.ndarray, items: np.ndarray, ratings: np.ndarray,
                 train_percent: float, seed: int = 42):
    """Global shuffle split, then each side sorted by (user, item) — the
    CSR builder's precondition.  Returns ((users, items, ratings) train,
    (…) test)."""
    rng = np.random.default_rng(seed)
    n = len(users)
    perm = rng.permutation(n)
    cut = int(n * train_percent)

    def side(sel):
        u, i, r = users[sel], items[sel], ratings[sel]
        order = np.lexsort((i, u))
        return u[order], i[order], r[order]

    return side(perm[:cut]), side(perm[cut:])
