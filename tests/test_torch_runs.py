"""The runs of a ``mean``/``sum`` step: the port's plain
``collision_runs_reference`` (``ops/packed.py``, on the CPU) against the
TPU package's ``mean`` counts (``ops/packed.py``: ``zeros(I).at[items].add
(has)``) and numpy's stable argsort, on the pairs that both packages'
samplers draw from one key, JAX on the CPU.  Exact: counts and orders are
integers.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cu2rec_torch.data.csr import build_csr as t_build
from cu2rec_torch.data.csr import csr_from_arrays as t_csr_from_arrays
from cu2rec_torch.data.csr import to_device as t_to_device
from cu2rec_torch.data.ratings import read_ratings_csv as t_read
from cu2rec_torch.ops.packed import collision_runs, collision_runs_reference
from cu2rec_torch.ops.sgd import prng_key, sample_items
from cu2rec_tpu.data import build_csr, read_ratings_csv
from cu2rec_tpu.data.csr import to_device
from cu2rec_tpu.ops.sgd import sample_items as j_sample_items

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = {"toy": "tests/data/test_ratings.csv",
         "ml100k": "data/ml100k_ratings_train.csv"}


@pytest.fixture(scope="module", params=list(FILES))
def ratings(request):
    path = str(ROOT / FILES[request.param])
    csr = build_csr(read_ratings_csv(path))
    return to_device(csr), t_to_device(t_build(t_read(path)), "cpu")


def _want(items: np.ndarray, has: np.ndarray, n_items: int):
    """The runs by numpy: offsets from the counts, users by a stable
    argsort of their items."""
    who = np.nonzero(has)[0]
    order = np.argsort(items[who], kind="stable")
    offsets = np.zeros(n_items + 1, np.int64)
    np.cumsum(np.bincount(items[who], minlength=n_items), out=offsets[1:])
    return offsets, who[order]


@pytest.mark.parametrize("iteration", [0, 1, 4095])
@pytest.mark.parametrize("seed", [0, 7])
def test_runs_match_jax_mean_counts_and_stable_argsort(ratings, iteration,
                                                       seed):
    jdev, tdev = ratings
    j_items, _r, j_has = j_sample_items(
        jax.random.PRNGKey(seed), jnp.uint32(iteration), jdev.indptr,
        jdev.indices, jdev.data)
    I = tdev.n_items
    j_items = np.asarray(j_items)[:tdev.n_users]
    j_has = np.asarray(j_has)[:tdev.n_users]
    # The TPU package's mean counts (ops/packed.py, collision "mean").
    counts = np.asarray(jnp.zeros((I,), jnp.float32).at[
        jnp.asarray(j_items)].add(jnp.asarray(j_has).astype(jnp.float32)))
    offsets, users = collision_runs(tdev, prng_key(seed), iteration)
    assert offsets.dtype == users.dtype == torch.int32
    assert offsets.shape == (I + 1,)
    np.testing.assert_array_equal(np.diff(offsets.numpy()),
                                  counts.astype(np.int64))
    want_offsets, want_users = _want(j_items, j_has, I)
    np.testing.assert_array_equal(offsets.numpy(), want_offsets)
    np.testing.assert_array_equal(users.numpy(), want_users)
    # The port's sampler draws the same pairs.
    items, _r, has = sample_items(prng_key(seed), iteration, tdev.indptr,
                                  tdev.indices, tdev.data)
    np.testing.assert_array_equal(has.numpy(), j_has)
    np.testing.assert_array_equal(items.numpy()[j_has], j_items[j_has])


@pytest.mark.parametrize("case", ["no pairs", "last item", "one hot run",
                                  "all items"])
def test_runs_reference_edge_cases(case):
    """Users with no pair are left out; item I - 1 closes the offsets; a
    hot run lists its users in ascending order."""
    rng = np.random.default_rng(3)
    U, I = 500, 40
    items = rng.integers(0, I, U)
    has = rng.random(U) < 0.8
    if case == "no pairs":
        has[:] = False
    elif case == "last item":
        items[::2] = I - 1
    elif case == "one hot run":
        items[rng.random(U) < 0.7] = 5
    else:
        items = np.arange(U) % I
        has[:] = True
    offsets, users = collision_runs_reference(
        torch.from_numpy(items), torch.from_numpy(has), I)
    want_offsets, want_users = _want(items, has, I)
    np.testing.assert_array_equal(offsets.numpy(), want_offsets)
    np.testing.assert_array_equal(users.numpy(), want_users)
    assert int(offsets[I]) == int(has.sum())
    for i in range(I):
        run = users[offsets[i]:offsets[i + 1]].numpy()
        assert (np.diff(run) > 0).all() and (items[run] == i).all()


def test_runs_of_users_without_ratings_and_empty_items():
    """A CSR where some users have no rating and some items none: the
    runs hold exactly the users with a rating, once each."""
    rng = np.random.default_rng(5)
    U, I = 300, 50
    users = rng.integers(20, U, 3000)
    items = rng.integers(0, I - 10, 3000)
    dev = t_to_device(t_csr_from_arrays(users, items, np.full(3000, 3.0,
                                                              np.float32),
                                        U, I), "cpu")
    offsets, run_users = collision_runs(dev, prng_key(2), 3)
    assert sorted(run_users.tolist()) == sorted(set(users.tolist()))
    assert (offsets[I - 10:] == offsets[I]).all()
