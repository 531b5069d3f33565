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
