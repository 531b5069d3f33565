"""Implicit-feedback ALS (iALS, Hu/Koren/Volinsky 2008).

Preference p_ui = 1 for every observed (u, i), confidence c_ui = 1 + α·r_ui;
a user's factors solve

    ( YᵀY + Yᵀ(C_u − I)Y + λI ) x_u = Σ_{i∈S_u} c_ui y_i

YᵀY (the Gramian) is one (I, F)ᵀ(I, F) product shared by every user; the
per-user correction touches only the user's rated items, on the same
degree-bucketed chunks as explicit ALS (``ops/als.py``), heavy path
included.  Every solve is kernel K1 through ``ops/als._ridge_finish``.
The half sweep is a host loop over chunks, as in ``ops/als.py``.
"""

from __future__ import annotations

import torch

from cu2rec_torch.ops.als import (
    _ridge_finish, _solve_into, assemble_solved, segment_sums, split_chunks,
)


def gramian(T: torch.Tensor) -> torch.Tensor:
    """G = TᵀT in float32."""
    T32 = T.to(torch.float32)
    return T32.T @ T32


def _corrections(T_other, cols, vals, mask, alpha: float):
    """Per slice: Σ (c − 1) q qᵀ and Σ c q over the rated items."""
    q = T_other[cols].to(torch.float32)              # (B, D, F)
    m = mask.to(torch.float32)
    w = alpha * vals * m                              # c − 1, masked
    G = torch.einsum("bdf,bdg->bfg", q * w[..., None], q)
    rhs = torch.einsum("bdf,bd->bf", q, (1.0 + alpha * vals) * m)
    return G, rhs


def _add_reg(G, reg: float) -> torch.Tensor:
    G.diagonal(dim1=-2, dim2=-1).add_(reg)
    return G


def ials_bucket_system(T_other, G_global, cols, vals, mask, alpha: float,
                       reg: float):
    """(G, rhs) of a regular chunk before the solve."""
    G, rhs = _corrections(T_other, cols, vals, mask, alpha)
    return _add_reg(G_global[None] + G, reg), rhs


def _solve_ials_bucket(T_other, G_global, cols, vals, mask, alpha: float,
                       reg: float, solver: str = "auto"):
    return _ridge_finish(*ials_bucket_system(T_other, G_global, cols, vals,
                                             mask, alpha, reg), solver)


def ials_heavy_system(T_other, G_global, cols, vals, mask, seg_start,
                      seg_end, alpha: float, reg: float):
    """(G, rhs) of a heavy chunk: per-segment corrections summed exactly
    by prefix-sum differences (see ``ops/als.segment_sums``)."""
    Gseg, rseg = _corrections(T_other, cols, vals, mask, alpha)
    G, rhs = segment_sums(Gseg, rseg, seg_start, seg_end)
    return _add_reg(G_global[None] + G, reg), rhs


def _solve_ials_heavy(T_other, G_global, cols, vals, mask, seg_start,
                      seg_end, alpha: float, reg: float,
                      solver: str = "auto"):
    """Exact iALS solve for rows of degree > the largest bucket."""
    return _ridge_finish(*ials_heavy_system(T_other, G_global, cols, vals,
                                            mask, seg_start, seg_end, alpha,
                                            reg), solver)


def ials_fold_in(Y, cols, vals, mask, alpha: float, reg: float,
                 solver: str = "auto"):
    """Exact one-shot fold-in for a batch of new implicit users against the
    frozen item factors ``Y`` (I, F):

        x_u = ( YᵀY + Yᵀ(C_u − I)Y + λI )⁻¹ Σ_{i∈S_u} (1 + α·r_ui) y_i

    ``cols/vals/mask``: (B, D) padded rated-item slices (arrays or tensors;
    moved to ``Y``'s device).  Returns (B, F) user factor rows.
    """
    dev = Y.device
    cols = torch.as_tensor(cols, device=dev).to(torch.int64)
    vals = torch.as_tensor(vals, device=dev).to(torch.float32)
    mask = torch.as_tensor(mask, device=dev).to(torch.bool)
    return _solve_ials_bucket(Y, gramian(Y), cols, vals, mask,
                              float(alpha), float(reg), solver=solver)


def ials_half_sweep(T_self, T_other, chunks, alpha: float, reg: float,
                    solver: str = "auto", row_sharding=None):
    """Every row of ``T_self`` (plain (N, F) factors) solved given the
    frozen ``T_other``, from the chunks of ``ops/als.prepare_chunks`` or
    ``prepare_chunks_device``; returns a new table.  Rows with no ratings
    come out unchanged.  ``row_sharding``: as in ``als_half_sweep``, each
    rank solves its chunks' rows and every rank returns the whole table."""
    regs, heavies = split_chunks(chunks)
    return _ials_sweep_body(T_self, T_other, regs, heavies, float(alpha),
                            float(reg), solver, row_sharding)


def _ials_sweep_body(T_self, T_other, regs, heavies, a: float, r: float,
                     solver: str, row_sharding=None):
    G = gramian(T_other)
    T_new, solved = _solve_into(T_self, row_sharding)
    for cols, vals, mask, rows in regs:
        theta = _solve_ials_bucket(T_other, G, cols, vals, mask, a, r,
                                   solver=solver)
        T_new[rows] = theta.to(T_new.dtype)
    for cols, vals, mask, rows, s0, s1, _deg in heavies:
        theta = _solve_ials_heavy(T_other, G, cols, vals, mask, s0, s1, a,
                                  r, solver=solver)
        T_new[rows] = theta.to(T_new.dtype)
    if solved is not None:
        for ch in regs + heavies:
            solved[ch[3]] = 1
    return assemble_solved(T_new, T_self, solved, row_sharding)
