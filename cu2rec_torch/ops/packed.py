"""Packed tables: factors and bias in one row.

    T_u[u] = [ p_u(F) | b_u | 0-pad → W ]
    T_i[i] = [ q_i(F) | b_i | 0-pad → W ]

One gather fetches an item's factors and its bias.  With ``x̂ = set_col(x,
F, 1)`` the fold-in update of a user row is one expression,

    Δrow_u = lr · (e · t̂_i − reg_u ⊙ row_u)      reg_u = [P_reg…, ub_reg, 0…]

— column F of ``t̂`` being 1 makes the bias update fall out of the factor
formula, and the padding stays zero because its reg is 0.  Same layout and
widths as the TPU package's ``ops/packed.py`` (the SGD step comes with the
training slice).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from cu2rec_torch.models.state import MFModel
from cu2rec_torch.ops.sgd import Hyper


def packed_width(n_factors: int) -> int:
    """Smallest of 64, 128 or a multiple of 128 holding F factors + 1 bias."""
    need = n_factors + 1
    for w in (64, 128):
        if need <= w:
            return w
    return -(-need // 128) * 128


@dataclass
class PackedModel:
    """Packed parameter tables."""

    T_u: torch.Tensor        # (n_users, W)
    T_i: torch.Tensor        # (n_items, W)
    global_bias: torch.Tensor
    n_factors: int

    @property
    def width(self) -> int:
        return self.T_u.shape[1]


def _pack_side(M: torch.Tensor, b: torch.Tensor, W: int) -> torch.Tensor:
    F = M.shape[1]
    row = torch.zeros((M.shape[0], W), dtype=M.dtype, device=M.device)
    row[:, :F] = M
    row[:, F] = b.to(M.dtype)
    return row


def pack(model: MFModel) -> PackedModel:
    F = model.n_factors
    W = packed_width(F)
    return PackedModel(T_u=_pack_side(model.P, model.user_bias, W),
                       T_i=_pack_side(model.Q, model.item_bias, W),
                       global_bias=model.global_bias, n_factors=F)


def unpack(pm: PackedModel) -> MFModel:
    F = pm.n_factors
    return MFModel(P=pm.T_u[:, :F], Q=pm.T_i[:, :F],
                   user_bias=pm.T_u[:, F], item_bias=pm.T_i[:, F],
                   global_bias=pm.global_bias)


def _reg_vectors(hp: Hyper, F: int, W: int, device=None):
    """(factor mask, bias-column mask, reg_u, reg_i), each (W,) float32."""
    col = torch.arange(W, device=device)
    factor = col < F
    biascol = col == F
    zero = torch.zeros((), device=device)
    reg_u = torch.where(factor, hp.P_reg,
                        torch.where(biascol, hp.user_bias_reg, zero))
    reg_i = torch.where(factor, hp.Q_reg,
                        torch.where(biascol, hp.item_bias_reg, zero))
    return (factor.to(torch.float32), biascol.to(torch.float32),
            reg_u.to(torch.float32), reg_i.to(torch.float32))
