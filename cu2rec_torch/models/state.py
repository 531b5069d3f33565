"""Model state: the biased matrix-factorization parameter tables.

The model is  r̂(u,i) = μ + b_u + b_i + p_u · q_i  (reference
matrix_factorization/util.cu:199-204).  Here the five tables are the
buffers of an ``nn.Module`` on one device.

Initialization: the reference draws every table from
Normal(mean=0, std=1/n_factors) (util.cu:124-144); ``init_model`` draws the
same distribution with the numbers of ``torch.randn`` from a seeded CPU
``torch.Generator``: on the card with K5 (``ops/cuda_draw.py``), which
gives that generator's draw bit for bit, and on the CPU where the model
lives there or K5 cannot draw it.  The TPU package draws from a threefry
stream that torch cannot reproduce, so tests that compare the two packages
carry its tables over with ``model_from_numpy``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cu2rec_torch.utils.device import resolve_device
from cu2rec_torch.utils.timing import count, span

# Table names, in the component-export order of reference mf.cu:83-87.
COMPONENTS = ("p", "q", "user_bias", "item_bias", "global_bias")
# The table dtypes a config's ``dtype`` names.
TABLE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def table_dtype(dtype) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` ("float32" or "bfloat16"),
    or of a torch dtype among them."""
    if isinstance(dtype, torch.dtype) and dtype in TABLE_DTYPES.values():
        return dtype
    if dtype in TABLE_DTYPES:
        return TABLE_DTYPES[dtype]
    raise ValueError(f"unknown table dtype {dtype!r}: one of "
                     f"{sorted(TABLE_DTYPES)}")


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


def initialize_normal(gen: torch.Generator, shape, n_factors: int,
                      mean: float = 0.0, stddev: float = 1.0,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    """Normal(mean, stddev / n_factors) init (reference util.cu:124-132),
    drawn in float32 from ``gen`` on its own device, then cast to ``dtype``
    and moved to ``device`` (the card unless the caller asks for the
    CPU)."""
    dev = resolve_device(device)
    draw = torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device) / (n_factors / stddev)
    if mean:
        draw = draw + mean
    return draw.to(dev, table_dtype(dtype))


def init_model(n_users: int, n_items: int, n_factors: int,
               global_bias: float, seed: int = 42,
               dtype=torch.float32, Q=None, item_bias=None,
               device=None) -> MFModel:
    """A freshly initialized model on ``device``: Normal(0, 1/F) tables,
    the numbers ``torch.randn`` draws in float32 from
    ``torch.Generator().manual_seed(seed)`` on the CPU in the order P, Q,
    user bias, item bias, bit for bit whatever the device; then cast to
    ``dtype`` (a torch dtype or a config's name; rounded to nearest even),
    as the TPU package does.  The global bias stays float32.

    On the card, where every drawn table has 16 entries or more, K5
    (``ops/cuda_draw.py``) draws them there and nothing crosses from the
    host; its transforms are built and checked against the CPU draw at the
    process's first card draw, and where they cannot be, this raises.  A
    smaller table (torch draws it with other CPU code) is drawn on the CPU
    and moved, as is every table of a CPU model.  The counters
    ``model.init.card_draws`` and ``model.init.cpu_draws`` count a card's
    models each way.

    Pass pre-trained ``Q``/``item_bias`` for the fold-in path (reference
    training.cu:206-217, predict.cu:126).
    """
    from cu2rec_torch.ops import cuda_draw  # ops imports this module

    dev = resolve_device(device)
    dtype = table_dtype(dtype)
    sizes = [("P", n_users * n_factors)]
    if Q is None:
        sizes.append(("Q", n_items * n_factors))
    sizes.append(("user_bias", n_users))
    if item_bias is None:
        sizes.append(("item_bias", n_items))
    plan = cuda_draw.draw_plan(sizes)
    on_card = cuda_draw.draws_on_card(dev)
    with span("model.init.draw"):
        if on_card and cuda_draw.plan_on_card(plan):
            tables = cuda_draw.device_tables(dev)
            count("model.init.card_draws")
            drawn = {e.name: torch.empty(e.n, dtype=dtype, device=dev)
                     for e in plan}
            cuda_draw.normal_draw_cuda(seed, plan, list(drawn.values()),
                                       *tables, n_factors)
        else:
            if on_card:
                count("model.init.cpu_draws")
            gen = torch.Generator().manual_seed(seed)
            drawn = {e.name: initialize_normal(gen, e.n, n_factors,
                                               dtype=dtype, device="cpu")
                     for e in plan}
    P = drawn["P"].view(n_users, n_factors)
    Q = (drawn["Q"].view(n_items, n_factors) if Q is None
         else torch.as_tensor(np.asarray(Q), dtype=dtype)
         .reshape(n_items, n_factors))
    ib = (drawn["item_bias"] if item_bias is None
          else torch.as_tensor(np.asarray(item_bias), dtype=dtype)
          .reshape(n_items))
    with span("model.init.upload"):
        return MFModel(P, Q, drawn["user_bias"], ib,
                       torch.tensor(global_bias,
                                    dtype=torch.float32)).to(dev)


def with_dtype(model: MFModel, dtype) -> MFModel:
    """The model with its four tables in ``dtype`` (rounded to nearest
    even where it narrows); the global bias stays float32.  The model
    itself where its tables are in ``dtype`` already."""
    dtype = table_dtype(dtype)
    if all(t.dtype == dtype for t in (model.P, model.Q, model.user_bias,
                                      model.item_bias)):
        return model
    return MFModel(P=model.P.to(dtype), Q=model.Q.to(dtype),
                   user_bias=model.user_bias.to(dtype),
                   item_bias=model.item_bias.to(dtype),
                   global_bias=model.global_bias)


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
