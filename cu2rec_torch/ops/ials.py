"""Implicit-feedback ALS (iALS, Hu/Koren/Volinsky 2008) — the fold-in part.

Preference p_ui = 1 for every observed (u, i), confidence c_ui = 1 + α·r_ui;
a user's factors solve

    ( YᵀY + Yᵀ(C_u − I)Y + λI ) x_u = Σ_{i∈S_u} c_ui y_i

YᵀY (the Gramian) is one (I, F)ᵀ(I, F) product shared by every user; the
per-user correction touches only the user's rated items.  The solve is
kernel K1 through ``ops/als._ridge_finish``.  The half sweeps come with the
training slice.
"""

from __future__ import annotations

import torch

from cu2rec_torch.ops.als import _ridge_finish


def gramian(T: torch.Tensor) -> torch.Tensor:
    """G = TᵀT in float32."""
    T32 = T.to(torch.float32)
    return T32.T @ T32


def _solve_ials_bucket(T_other, G_global, cols, vals, mask, alpha: float,
                       reg: float, solver: str = "auto"):
    q = T_other[cols].to(torch.float32)              # (B, D, F)
    m = mask.to(torch.float32)
    w = alpha * vals * m                              # c − 1, masked
    G = G_global[None] + torch.einsum("bdf,bdg->bfg", q * w[..., None], q)
    rhs = torch.einsum("bdf,bd->bf", q, (1.0 + alpha * vals) * m)
    F = G.shape[-1]
    G = G + torch.eye(F, device=G.device)[None] * reg
    return _ridge_finish(G, rhs, solver)


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
