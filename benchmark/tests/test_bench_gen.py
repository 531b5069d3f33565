"""The generator of the cells' data repeats by seed, and gives what the
port takes: each side sorted by (user, item), sizes as configured."""

import numpy as np
import torch

from bench_util import tiny

from benchmark.gen.planted import planted_split


def _arrays(seed):
    _w, config = tiny("ml20m-f50.sgd")
    return planted_split(config, seed, "cpu")


def test_same_seed_same_data():
    a, b = _arrays(2 ** 31 + 77), _arrays(2 ** 31 + 77)
    for sa, sb in zip(a, b):
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))


def test_other_seed_other_data():
    a, b = _arrays(1), _arrays(2)
    assert not np.array_equal(a[0].data, b[0].data)


def test_sides_sorted_and_sized():
    _w, config = tiny("ml20m-f50.sgd")
    train, test = planted_split(config, 5, "cpu")
    s = config["sizes"]
    assert train.nnz + test.nnz == s["n_ratings"]
    assert test.nnz == int(s["n_ratings"] * s["test_share"])
    for side in (train, test):
        assert side.indptr.shape == (s["n_users"] + 1,)
        assert side.indptr[-1] == side.nnz
        rows = np.repeat(np.arange(s["n_users"]), np.diff(side.indptr))
        key = rows.astype(np.int64) * s["n_items"] + side.indices
        assert np.all(np.diff(key) >= 0)
        assert side.indices.min() >= 0 and side.indices.max() < s["n_items"]
        assert side.data.dtype == np.float32


def test_seed_past_32_signed_bits():
    """A seed past 2**31 draws its own data, not that of the seed 2**31
    below it."""
    from benchmark.gen.planted import generator

    a = torch.rand(3, generator=generator(2 ** 31 + 3, 0, "cpu"))
    b = torch.rand(3, generator=generator(3, 0, "cpu"))
    assert not torch.equal(a, b)
