"""SGD hyperparameters and the counter-based sampling stream.

The stream is the TPU package's ``counter_uniform`` (ops/sgd.py there),
reproduced bit for bit: the uniform draw for slot ``u`` at iteration ``t``
is a pure function of (key, t, u) — two chained murmur3 finalizer rounds —
so a batch of one reproduces the big-batch draws, and the fold-in samples
the same positions in both packages.

Torch on the CPU has no ``>>`` on uint32, so the arithmetic runs in int64
on values masked to 32 bits.  A 32-bit × 32-bit product can reach 2^64 and
would overflow signed int64; ``_mul32`` splits the constant into 16-bit
halves so that no partial product exceeds 2^48.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF


class Hyper(NamedTuple):
    """Fold-in/SGD hyperparameter scalars, rounded to float32 as the TPU
    package's traced scalars are."""

    learning_rate: float
    P_reg: float
    Q_reg: float
    user_bias_reg: float
    item_bias_reg: float

    @classmethod
    def from_config(cls, cfg) -> "Hyper":
        return cls(*(float(np.float32(v)) for v in (
            cfg.learning_rate, cfg.P_reg, cfg.Q_reg,
            cfg.user_bias_reg, cfg.item_bias_reg)))


def prng_key(seed: int) -> tuple[int, int]:
    """The two 32-bit key words of a threefry ``PRNGKey(seed)``:
    (high word, low word) of the 64-bit seed — ``(0, seed)`` for any seed
    below 2^32."""
    seed = int(seed)
    return (seed >> 32) & _M32, seed & _M32


def _key_words(key) -> tuple[int, int]:
    """Key words from a ``prng_key`` pair, or any length-2 array/tensor of
    the words (e.g. the key data of a threefry key)."""
    if isinstance(key, torch.Tensor):
        key = key.tolist()
    k0, k1 = (int(k) for k in np.asarray(key).reshape(-1)[:2])
    return k0 & _M32, k1 & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for int64 ``x`` in [0, 2^32) and a 32-bit constant,
    without any partial product above 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return ((x * lo) + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer: full-avalanche 32-bit integer mix (int64 lanes
    holding uint32 values)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def counter_uniform(key, iteration, uids: torch.Tensor) -> torch.Tensor:
    """Uniform [0,1) float32 as a pure function of (key, iteration, id).

    ``key`` is a ``prng_key`` pair; ``iteration`` an int (or 0-d tensor);
    ``uids`` an integer tensor of slot/user ids.
    """
    k0, k1 = _key_words(key)
    it = int(iteration) & _M32
    u = uids.to(torch.int64) & _M32
    inner = int(_fmix32(torch.tensor(it ^ k1, dtype=torch.int64)))
    h = _fmix32(u ^ inner ^ k0)
    h = _fmix32((h + 0x9E3779B9) & _M32)
    # 24 high bits → exact float32 in [0, 1)
    return (h >> 8).to(torch.float32) * (2.0 ** -24)
