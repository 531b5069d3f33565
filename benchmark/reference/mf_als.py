"""Plain reference of the ALS cell: biased matrix factorization trained by
alternating least squares, every row solved exactly given the other side.
Plain torch, float64, on any device; it imports nothing of the port.

A user half sweep solves, for each user u with ratings S_u,

    (X_uᵀ X_u + diag(λ) · |S_u|) θ_u = X_uᵀ y_u,
    X_u = [q_i | 1]_{i ∈ S_u},  y_u = r_ui − μ − b_i,  λ = [λ_P…, λ_bu],

and sets [p_u | b_u] = θ_u (the degree-weighted ridge of Zhou et al.);
a user with no rating keeps its row.  The item half sweep is the same
with the roles swapped, over the users' new rows.  The Grams are sums of
outer products over the ratings, in float64; ``tf32=True`` rounds every
design entry and target to TF32 (10 bits of mantissa) first, as a
tensor-core TF32 product would: the control.
"""

from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (round to nearest even on the low 13 bits of
    float32), returned as float32."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    bias = 0xFFF + ((b >> 13) & 1)
    return ((b + bias) & ~0x1FFF).view(torch.float32)


def transpose(indptr, indices, data, n_cols: int):
    """The column-major CSR (indptr over columns, row ids, values) of a
    row-major one, each column's entries in row order."""
    rows = torch.repeat_interleave(
        torch.arange(indptr.shape[0] - 1, device=indices.device),
        (indptr[1:] - indptr[:-1]).long())
    order = torch.sort(indices.long(), stable=True).indices
    ptr = torch.zeros(n_cols + 1, dtype=torch.int64, device=indices.device)
    ptr[1:] = torch.cumsum(torch.bincount(indices.long(),
                                          minlength=n_cols), 0)
    return ptr, rows[order], data[order]


def half_sweep(self_side, other_side, csr, mu: float, factor_reg: float,
               bias_reg: float, tf32_inputs: bool = False,
               skip_rows: torch.Tensor | None = None):
    """(factors, bias) of this side after its half sweep; ``self_side``
    and ``other_side`` are (factors (n, F), bias (n,)) float64.
    ``skip_rows`` (bool) leaves those rows unsolved: a planted fault."""
    P, b = self_side
    Q, c = other_side
    indptr, cols, vals = csr
    R, F = P.shape
    N = F + 1
    dev = P.device
    deg = (indptr[1:] - indptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(R, device=dev), deg)
    G = torch.zeros((R, N * N), dtype=torch.float64, device=dev)
    rhs = torch.zeros((R, N), dtype=torch.float64, device=dev)
    chunk = max(1024, (1 << 30) // (8 * N * N))
    for lo in range(0, cols.shape[0], chunk):
        i = cols[lo:lo + chunk].long()
        x = torch.cat([Q[i], torch.ones((i.shape[0], 1), dtype=Q.dtype,
                                        device=dev)], 1)
        y = vals[lo:lo + chunk].to(torch.float64) - mu - c[i]
        if tf32_inputs:
            x, y = tf32(x).to(torch.float64), tf32(y).to(torch.float64)
        r = rows[lo:lo + chunk]
        G.index_add_(0, r, (x[:, :, None] * x[:, None, :]).reshape(-1, N * N))
        rhs.index_add_(0, r, x * y[:, None])
    lam = torch.tensor([factor_reg] * F + [bias_reg], dtype=torch.float64,
                       device=dev)
    has = deg > 0
    if skip_rows is not None:
        has = has & ~skip_rows
    G = G[has].reshape(-1, N, N) + torch.diag_embed(
        lam[None, :] * deg[has, None].to(torch.float64))
    theta = torch.linalg.solve(G, rhs[has])
    P_new, b_new = P.clone(), b.clone()
    P_new[has] = theta[:, :F]
    b_new[has] = theta[:, F]
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
