"""Plain reference of the ALS-WR cell: ``mf_als``'s half sweeps computed a
block of rows at a time, so that its memory is bounded by a block and not
by the rows of a side.  Plain torch, float64, on any device; it imports
nothing of the port.

ALS with weighted-λ regularisation (Zhou, Wilkinson, Schreiber and Pan,
"Large-Scale Parallel Collaborative Filtering for the Netflix Prize",
AAIM 2008) fixes one side and solves, for each user u with ratings S_u,

    (X_uᵀ X_u + diag(λ) · n_u) θ_u = X_uᵀ y_u,    n_u = |S_u|,
    X_u = [q_i | 1]_{i ∈ S_u},  y_u = r_ui − μ − b_i,  λ = [λ_P…, λ_bu],

and sets [p_u | b_u] = θ_u; a user with no rating keeps its row.  The item
half sweep is the same with the roles swapped, over the users' new rows.

Departures from the published description:
- the row is [p | b] and the target has μ and b_i taken off: the biases
  are the port's addition (Zhou et al. solve for p_u alone against r_ui),
  and the bias takes its own λ, scaled by n_u like the factors';
- the ratings are planted (``benchmark/gen/planted.py``), not Netflix's.

How it is computed: the rows with ratings (less ``skip_rows``) are taken
in order of degree and cut into blocks of at most ``BLOCK`` elements of
their (B, D, N) design tensor (D the block's largest degree, padded slots
zero) and of their (B, N, N) Grams.  A block's Grams and right-hand sides
are batched products (``torch.bmm``) in float64, the ridge is added, and
``torch.linalg.solve`` solves them, as ``mf_als`` does.  ``tf32_inputs``
rounds every design entry and target to TF32 first (``mf_als.tf32``): the
control.  Only the order of the sums differs from ``mf_als``.
"""

from __future__ import annotations

import torch

from benchmark.reference.mf_als import tf32, transpose

__all__ = ["BLOCK", "half_sweep", "sweep", "tf32", "transpose"]

# Elements of a block's design tensor, and of its Grams (float64: 1 GiB).
BLOCK = 1 << 27


def blocks(deg, N: int, block: int = BLOCK):
    """[lo, hi) ranges over rows sorted by degree (``deg``, ascending),
    each the longest whose (hi − lo) · max(D, N) · N stays within
    ``block``, D = deg[hi − 1]; at least one row each."""
    out, lo, n = [], 0, len(deg)
    while lo < n:
        ok, top = lo + 1, n
        while ok < top:                       # the largest hi that fits
            mid = (ok + top + 1) // 2
            if (mid - lo) * max(int(deg[mid - 1]), N) * N <= block:
                ok = mid
            else:
                top = mid - 1
        out.append((lo, ok))
        lo = ok
    return out


def half_sweep(self_side, other_side, csr, mu: float, factor_reg: float,
               bias_reg: float, tf32_inputs: bool = False,
               skip_rows: torch.Tensor | None = None):
    """(factors, bias) of this side after its half sweep; ``self_side``
    and ``other_side`` are (factors (n, F), bias (n,)) float64.
    ``skip_rows`` (bool) leaves those rows unsolved: a planted fault."""
    P, b = self_side
    Q, c = other_side
    indptr, cols, vals = csr
    F = P.shape[1]
    N = F + 1
    dev = P.device
    f64 = torch.float64
    deg = (indptr[1:] - indptr[:-1]).long()
    has = deg > 0
    if skip_rows is not None:
        has = has & ~skip_rows
    rows = torch.nonzero(has).flatten()
    rows = rows[torch.sort(deg[rows], stable=True).indices]
    deg_sorted = deg[rows].cpu().numpy()
    X_rows = torch.cat([Q, torch.ones((Q.shape[0], 1), dtype=f64,
                                      device=dev)], 1)
    lam = torch.tensor([factor_reg] * F + [bias_reg], dtype=f64, device=dev)
    starts = indptr[:-1].long()
    P_new, b_new = P.clone(), b.clone()
    for lo, hi in blocks(deg_sorted, N, BLOCK):
        r = rows[lo:hi]
        d = deg[r]
        j = torch.arange(int(deg_sorted[hi - 1]), device=dev)
        mask = j[None, :] < d[:, None]
        pos = torch.where(mask, starts[r][:, None] + j[None, :], 0)
        i = cols[pos].long()
        x = X_rows[i] * mask[..., None]
        y = (vals[pos].to(f64) - mu - c[i]) * mask
        if tf32_inputs:
            x, y = tf32(x).to(f64), tf32(y).to(f64)
        G = torch.bmm(x.mT, x) + torch.diag_embed(lam[None, :] *
                                                  d[:, None].to(f64))
        rhs = torch.bmm(x.mT, y[..., None])[..., 0]
        theta = torch.linalg.solve(G, rhs)
        P_new[r] = theta[:, :F]
        b_new[r] = theta[:, F]
    return P_new, b_new


def sweep(tables, mu: float, user_csr, item_csr, regs: dict,
          tf32_inputs: bool = False, skip_users=None):
    """The tables (P, Q, user_bias, item_bias) after one sweep."""
    P, Q, ub, ib = tables
    P, ub = half_sweep((P, ub), (Q, ib), user_csr, mu, regs["P_reg"],
                       regs["user_bias_reg"], tf32_inputs, skip_users)
    Q, ib = half_sweep((Q, ib), (P, ub), item_csr, mu, regs["Q_reg"],
                       regs["item_bias_reg"], tf32_inputs)
    return P, Q, ub, ib
