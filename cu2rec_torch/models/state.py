"""Model state: the biased matrix-factorization parameter tables.

The model is  r̂(u,i) = μ + b_u + b_i + p_u · q_i  (reference
matrix_factorization/util.cu:199-204).  Here the five tables are the
buffers of an ``nn.Module`` on one device.

Initialization: the reference draws every table from
Normal(mean=0, std=1/n_factors) (util.cu:124-144); ``init_model`` draws the
same distribution from a seeded ``torch.Generator``.  The TPU package draws
from a threefry stream that torch cannot reproduce, so tests that compare
the two packages carry its tables over with ``model_from_numpy``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cu2rec_torch.utils.device import resolve_device

# Table names, in the component-export order of reference mf.cu:83-87.
COMPONENTS = ("p", "q", "user_bias", "item_bias", "global_bias")


class MFModel(nn.Module):
    """Biased-MF parameters: ``P`` (U, F), ``Q`` (I, F), ``user_bias`` (U,),
    ``item_bias`` (I,) and the scalar ``global_bias`` μ, as buffers."""

    def __init__(self, P: torch.Tensor, Q: torch.Tensor,
                 user_bias: torch.Tensor, item_bias: torch.Tensor,
                 global_bias: torch.Tensor):
        super().__init__()
        self.register_buffer("P", P)
        self.register_buffer("Q", Q)
        self.register_buffer("user_bias", user_bias)
        self.register_buffer("item_bias", item_bias)
        self.register_buffer("global_bias", global_bias.reshape(()))

    @property
    def n_users(self) -> int:
        return self.P.shape[0]

    @property
    def n_items(self) -> int:
        return self.Q.shape[0]

    @property
    def n_factors(self) -> int:
        return self.Q.shape[1]

    @property
    def device(self) -> torch.device:
        return self.Q.device


def _normal(gen: torch.Generator, shape, n_factors: int, dtype):
    return (torch.randn(shape, generator=gen, dtype=torch.float32)
            / n_factors).to(dtype)


def init_model(n_users: int, n_items: int, n_factors: int,
               global_bias: float, seed: int = 42,
               dtype=torch.float32, Q=None, item_bias=None,
               device=None) -> MFModel:
    """A freshly initialized model: Normal(0, 1/F) tables drawn on the CPU
    from ``torch.Generator().manual_seed(seed)`` (so the draw is the same
    whatever the device), then moved to ``device``.

    Pass pre-trained ``Q``/``item_bias`` for the fold-in path (reference
    training.cu:206-217, predict.cu:126).
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    P = _normal(gen, (n_users, n_factors), n_factors, dtype)
    Q = (_normal(gen, (n_items, n_factors), n_factors, dtype) if Q is None
         else torch.as_tensor(np.asarray(Q), dtype=dtype)
         .reshape(n_items, n_factors))
    ub = _normal(gen, (n_users,), n_factors, dtype)
    ib = (_normal(gen, (n_items,), n_factors, dtype) if item_bias is None
          else torch.as_tensor(np.asarray(item_bias), dtype=dtype)
          .reshape(n_items))
    return MFModel(P, Q, ub, ib,
                   torch.tensor(global_bias, dtype=torch.float32)).to(dev)


def model_to_numpy(model: MFModel) -> dict[str, np.ndarray]:
    """Device→host copy of all components, keyed by ``COMPONENTS`` (the same
    dict, dtypes and shapes the TPU package's ``model_to_numpy`` returns)."""
    def host(t):
        return t.detach().to("cpu", torch.float32).numpy()

    return {
        "p": host(model.P),
        "q": host(model.Q),
        "user_bias": host(model.user_bias),
        "item_bias": host(model.item_bias),
        "global_bias": host(model.global_bias).reshape(1),
    }


def model_from_numpy(d: dict, device=None) -> MFModel:
    """The weight carry-over: build the port's model from a ``COMPONENTS``
    dict of host arrays — what either package's ``model_to_numpy`` returns,
    or the arrays of an ``.npz`` checkpoint."""
    dev = resolve_device(device)

    def t(name):  # a copy: the model never aliases the caller's arrays
        return torch.from_numpy(np.array(d[name], dtype=np.float32)).to(dev)

    return MFModel(P=t("p"), Q=t("q"), user_bias=t("user_bias"),
                   item_bias=t("item_bias"),
                   global_bias=t("global_bias").reshape(()))
