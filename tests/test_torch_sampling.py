"""The port's counter-based sampling stream is bit-equal to the TPU
package's: same key words, same murmur3 rounds, same 24-bit uniforms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cu2rec_torch.ops.sgd import Hyper as THyper
from cu2rec_torch.ops.sgd import _fmix32, counter_uniform, prng_key
from cu2rec_tpu.ops.sgd import Hyper as JHyper
from cu2rec_tpu.ops.sgd import _fmix32 as j_fmix32
from cu2rec_tpu.ops.sgd import counter_uniform as j_counter_uniform
from cu2rec_tpu.utils.config import Config

SEEDS = (0, 42, 2 ** 31 + 5)
ITERS = (0, 1, 4095)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_words_match_threefry_key(seed):
    kd = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    assert tuple(int(x) for x in kd) == prng_key(seed)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("iteration", ITERS)
def test_counter_uniform_bit_equal(seed, iteration):
    uids = np.arange(2 ** 18, dtype=np.uint32)
    want = np.asarray(j_counter_uniform(
        jax.random.PRNGKey(seed), jnp.uint32(iteration), jnp.asarray(uids)))
    got = counter_uniform(prng_key(seed), iteration,
                          torch.from_numpy(uids.astype(np.int64))).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # a key passed as its raw words gives the same stream
    kd = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    again = counter_uniform(torch.as_tensor(kd.astype(np.int64)), iteration,
                            torch.from_numpy(uids[:64].astype(np.int64)))
    np.testing.assert_array_equal(again.numpy(), got[:64])


def test_fmix32_extreme_words_bit_equal():
    """The two 32-bit multiplies at full width: no int64 overflow."""
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xDEADBEEF,
                  0x85EBCA6B, 0xC2B2AE35], dtype=np.uint32)
    want = np.asarray(j_fmix32(jnp.asarray(x)))
    got = _fmix32(torch.from_numpy(x.astype(np.int64))).numpy()
    assert got.min() >= 0 and got.max() <= 0xFFFFFFFF
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_hyper_scalars_round_to_float32():
    cfg = Config(learning_rate=0.1, P_reg=0.02, Q_reg=0.3,
                 user_bias_reg=1e-3, item_bias_reg=7.7)
    for a, b in zip(THyper.from_config(cfg), JHyper.from_config(cfg)):
        assert np.float32(a) == np.asarray(b)
        assert a == float(np.asarray(b))


def _csr_pair(name):
    """The same ratings file through both packages' host CSR builders."""
    import pathlib

    from cu2rec_torch.data.csr import build_csr as t_build
    from cu2rec_torch.data.ratings import read_ratings_csv as t_read
    from cu2rec_tpu.data import build_csr, read_ratings_csv

    root = pathlib.Path(__file__).resolve().parents[1]
    path = str(root / {"toy": "tests/data/test_ratings.csv",
                       "ml100k": "data/ml100k_ratings_train.csv"}[name])
    return build_csr(read_ratings_csv(path)), t_build(t_read(path))


@pytest.fixture(scope="module", params=["toy", "ml100k"])
def both_devs(request):
    from cu2rec_torch.data.csr import to_device as t_to_device
    from cu2rec_tpu.data.csr import to_device

    jcsr, tcsr = _csr_pair(request.param)
    return (to_device(jcsr, item_major=True),
            t_to_device(tcsr, "cpu", item_major=True))


@pytest.mark.parametrize("seed", (0, 42))
@pytest.mark.parametrize("iteration", ITERS)
@pytest.mark.parametrize("side", ("users", "items"))
def test_sampled_positions_items_and_winners_bit_equal(both_devs, seed,
                                                       iteration, side):
    """Positions, the has mask, sampled (item, rating) pairs, rotated
    priorities and the first-wins election, against the TPU package.  The
    item side is the twin stream: item-major CSR, ids offset by the user
    count."""
    from cu2rec_torch.ops.sgd import (
        elect_winners, rotated_priority, sample_items, sample_positions,
        win_mask,
    )
    from cu2rec_tpu.ops.sgd import elect_winners as j_elect
    from cu2rec_tpu.ops.sgd import rotated_priority as j_prio
    from cu2rec_tpu.ops.sgd import sample_items as j_sample_items
    from cu2rec_tpu.ops.sgd import sample_positions as j_positions
    from cu2rec_tpu.ops.sgd import win_mask as j_win_mask

    jd, td = both_devs
    key, it = jax.random.PRNGKey(seed), jnp.int32(iteration)
    if side == "users":
        jptr, tptr, offset = jd.indptr, td.indptr, 0
    else:
        jptr, tptr, offset = jd.it_indptr, td.it_indptr, td.n_users
    pos, has = sample_positions(prng_key(seed), iteration, tptr, offset)
    j_pos, j_has = j_positions(key, it, jptr, offset)
    np.testing.assert_array_equal(has.numpy(), np.asarray(j_has))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))
    if side == "items":
        return
    items, ratings, has = sample_items(prng_key(seed), iteration, td.indptr,
                                       td.indices, td.data)
    j_items, j_ratings, _ = (np.asarray(x) for x in j_sample_items(
        key, it, jd.indptr, jd.indices, jd.data))
    h = has.numpy()
    np.testing.assert_array_equal(items.numpy()[h], j_items[h])
    np.testing.assert_array_equal(ratings.numpy()[h], j_ratings[h])

    U, I = td.n_users, td.n_items
    for off in (0, U):
        np.testing.assert_array_equal(
            rotated_priority(U, iteration, off, U).numpy(),
            np.asarray(j_prio(U, it, off, U)))
    prio = rotated_priority(U, iteration, 0, U)
    best, cand = elect_winners(items, has, prio, I)
    j_best, j_cand = j_elect(jnp.asarray(items.numpy().astype(np.int32)),
                             jnp.asarray(h), j_prio(U, it, 0, U), I)
    np.testing.assert_array_equal(best.numpy(), np.asarray(j_best)[:I])
    np.testing.assert_array_equal(cand.numpy(), np.asarray(j_cand))
    np.testing.assert_array_equal(
        win_mask(best, items, cand, has).numpy(),
        np.asarray(j_win_mask(j_best, jnp.asarray(
            items.numpy().astype(np.int32)), j_cand, jnp.asarray(h))))


@pytest.mark.parametrize("iteration", (0, 7, 8_589_935, 2 ** 31 - 1))
def test_start_user_wraps_like_int32(iteration):
    """The rotation's start user, including products past 2^31."""
    from cu2rec_torch.ops.sgd import start_user_of

    for U in (1, 6, 943, 138_000):
        want = int((jnp.int32(iteration) * 250) % jnp.int32(U))
        assert start_user_of(iteration, U) == want


def test_transpose_and_eval_span_match(both_devs):
    from cu2rec_torch.data.csr import (
        eval_window_span, transpose_csr, transpose_order,
    )
    from cu2rec_tpu.data.csr import eval_window_span as j_span
    from cu2rec_tpu.data.csr import transpose_csr as j_transpose_csr
    from cu2rec_tpu.data.csr import transpose_order as j_transpose_order

    for name in ("toy", "ml100k"):
        jcsr, tcsr = _csr_pair(name)
        for a, b in zip(transpose_order(tcsr), j_transpose_order(jcsr)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(transpose_csr(tcsr), j_transpose_csr(jcsr)):
            np.testing.assert_array_equal(a, b)
        for chunk in (5, 1 << 18):
            assert eval_window_span(tcsr.row_ids, tcsr.nnz, chunk) == \
                j_span(jcsr.row_ids, jcsr.nnz, chunk)
