"""Implicit-feedback ALS (iALS, Hu/Koren/Volinsky 2008).

Preference p_ui = 1 for every observed (u, i), confidence c_ui = 1 + α·r_ui;
a user's factors solve

    ( YᵀY + Yᵀ(C_u − I)Y + λI ) x_u = Σ_{i∈S_u} c_ui y_i

YᵀY (the Gramian) is one (I, F)ᵀ(I, F) product shared by every user; the
per-user correction touches only the user's rated items, on the same
degree-bucketed chunks as explicit ALS (``ops/als.py``), heavy path
included.  Each chunk's systems are kernel K4 on the card
(``ops/cuda_gram.py``, YᵀY and the ridge added in its epilogue) and every
solve is kernel K1 through ``ops/als._ridge_finish``.
The half sweep is a host loop over chunks, as in ``ops/als.py``.
"""

from __future__ import annotations

import torch

from cu2rec_torch.ops.als import (
    _ridge_finish, _solve_into, assemble_solved, segment_sums, split_chunks,
)
from cu2rec_torch.ops.cuda_gram import add_global, gather_gram, gram_rows


def gramian(T: torch.Tensor) -> torch.Tensor:
    """G = TᵀT in float32."""
    T32 = T.to(torch.float32)
    return T32.T @ T32


def ials_bucket_system(T_other, G_global, cols, vals, mask, alpha: float,
                       reg: float):
    """(G, rhs) of a regular chunk before the solve: YᵀY plus the
    correction Σ (c − 1) q qᵀ of the rated items, λ on the diagonal, and
    Σ c q."""
    return gather_gram(T_other, cols, vals, mask, G_global.shape[-1],
                       alpha=alpha, G_global=G_global, reg=reg)


def ials_rows_system(q, G_global, vals, mask, alpha: float, reg: float):
    """(G, rhs) of the systems whose rated items' float32 rows ``q``
    (B, D, F) are given, already gathered (an item-sharded catalog
    assembles them over its shards): the serving engines' implicit
    fold-in."""
    B, D, F = q.shape
    return gather_gram(q.reshape(B * D, F), None, vals, mask, F,
                       alpha=alpha, G_global=G_global, reg=reg)


def _solve_ials_bucket(T_other, G_global, cols, vals, mask, alpha: float,
                       reg: float):
    return _ridge_finish(*ials_bucket_system(T_other, G_global, cols, vals,
                                             mask, alpha, reg))


def ials_heavy_system(T_other, G_global, cols, vals, mask, seg_start,
                      seg_end, alpha: float, reg: float):
    """(G, rhs) of a heavy chunk: per-segment corrections summed exactly
    by prefix-sum differences (see ``ops/als.segment_sums``)."""
    Gseg, rseg = gather_gram(T_other, cols, vals, mask, G_global.shape[-1],
                             alpha=alpha)
    G, rhs = segment_sums(Gseg, rseg, seg_start, seg_end)
    return add_global(G, G_global, reg), rhs


def _solve_ials_heavy(T_other, G_global, cols, vals, mask, seg_start,
                      seg_end, alpha: float, reg: float):
    """Exact iALS solve for rows of degree > the largest bucket."""
    return _ridge_finish(*ials_heavy_system(T_other, G_global, cols, vals,
                                            mask, seg_start, seg_end, alpha,
                                            reg))


def ials_fold_in(Y, cols, vals, mask, alpha: float, reg: float):
    """Exact one-shot fold-in for a batch of new implicit users against the
    frozen item factors ``Y`` (I, F):

        x_u = ( YᵀY + Yᵀ(C_u − I)Y + λI )⁻¹ Σ_{i∈S_u} (1 + α·r_ui) y_i

    ``cols/vals/mask``: (B, D) padded rated-item slices (arrays or tensors;
    moved to ``Y``'s device).  Returns (B, F) user factor rows.  Raises
    ValueError, before any launch, where a masked-in id is not in
    [0, I): K4 reads the rows at the ids unchecked.  Masked-out slots may
    hold any id.
    """
    dev = Y.device
    cols = torch.as_tensor(cols, device=dev).to(torch.int64)
    vals = torch.as_tensor(vals, device=dev).to(torch.float32)
    mask = torch.as_tensor(mask, device=dev).to(torch.bool)
    live = cols[mask]
    if live.numel() and (int(live.min()) < 0
                         or int(live.max()) >= Y.shape[0]):
        raise ValueError(f"fold-in item ids must lie in [0, {Y.shape[0]}); "
                         f"got {int(live.min())}..{int(live.max())}")
    cols = torch.where(mask, cols, 0)
    return _solve_ials_bucket(Y, gramian(Y), cols, vals, mask,
                              float(alpha), float(reg))


def ials_half_sweep(T_self, T_other, chunks, alpha: float, reg: float,
                    row_sharding=None):
    """Every row of ``T_self`` (plain (N, F) factors) solved given the
    frozen ``T_other``, from the chunks of ``ops/als.prepare_chunks``;
    returns a new table.  Rows with no ratings come out unchanged.
    ``row_sharding``: as in ``als_half_sweep``, each rank solves its
    chunks' rows and every rank returns the whole table."""
    regs, heavies = split_chunks(chunks)
    return _ials_sweep_body(T_self, T_other, regs, heavies, float(alpha),
                            float(reg), row_sharding)


def _ials_sweep_body(T_self, T_other, regs, heavies, a: float, r: float,
                     row_sharding=None):
    G = gramian(T_other)
    T_other = gram_rows(T_other)     # float32 once a half sweep
    T_new, solved = _solve_into(T_self, row_sharding)
    for cols, vals, mask, rows in regs:
        theta = _solve_ials_bucket(T_other, G, cols, vals, mask, a, r)
        T_new[rows] = theta.to(T_new.dtype)
    for cols, vals, mask, rows, s0, s1, _deg in heavies:
        theta = _solve_ials_heavy(T_other, G, cols, vals, mask, s0, s1, a,
                                  r)
        T_new[rows] = theta.to(T_new.dtype)
    if solved is not None:
        for ch in regs + heavies:
            solved[ch[3]] = 1
    return assemble_solved(T_new, T_self, solved, row_sharding)
