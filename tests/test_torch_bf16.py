"""bf16 tables and the ``mean``/``sum`` collision policies: the port's plain
K0a and K0b (``ops/packed.py``, ``ops/loss.py`` on the CPU) against the TPU
package's packed step and eval, JAX on the CPU.

bf16 weights cross as bits (through a uint16 view), so both packages start
from the same tables.  Tolerances: bf16 tables within 1 bf16 ulp per entry
after one step and within 4 after five; float32 ``mean``/``sum`` within
atol 2e-6 over five steps (the tolerance of ``tests/test_packed.py``); the
eval over bf16 tables within rtol 1e-6.  The rule for colliding adds
(ascending user order, rounded after each add) is XLA's own, checked bit for
bit against ``.at[].add``.
"""

import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cu2rec_torch.data.csr import build_csr as t_build
from cu2rec_torch.data.csr import to_device as t_to_device
from cu2rec_torch.data.ratings import read_ratings_csv as t_read
from cu2rec_torch.ops.loss import evaluate_packed
from cu2rec_torch.ops.packed import (
    PackedModel, packed_run_steps, packed_step, scatter_add_in_order,
)
from cu2rec_torch.ops.sgd import Hyper, prng_key
from cu2rec_tpu.data import build_csr, read_ratings_csv
from cu2rec_tpu.data.csr import to_device
from cu2rec_tpu.models.state import init_model
from cu2rec_tpu.ops.loss import evaluate_packed as j_evaluate_packed
from cu2rec_tpu.ops.packed import pack as j_pack
from cu2rec_tpu.ops.packed import packed_run_steps as j_run_steps
from cu2rec_tpu.ops.packed import packed_step as j_step
from cu2rec_tpu.ops.sgd import Hyper as JHyper

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = {"toy": "tests/data/test_ratings.csv",
         "ml100k": "data/ml100k_ratings_train.csv"}
HPV = (0.05, 0.02, 0.03, 0.04, 0.05)
POLICIES = ("first_wins", "twin", "mean", "sum")


def to_torch(a) -> torch.Tensor:
    """A JAX or NumPy array as a torch tensor, bf16 bit for bit (torch's
    ``from_numpy`` takes no ``ml_dtypes.bfloat16``)."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(
            a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def to_numpy_bf16(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def ulp_distance(t: torch.Tensor, a) -> int:
    """The largest distance in bf16 ulps between entries of ``t`` and ``a``
    (+0 and −0 coincide)."""
    def ordered(bits):
        b = bits.astype(np.int32)
        return np.where(b >= 0x8000, 0x8000 - b, b)

    x = ordered(t.view(torch.int16).numpy().view(np.uint16))
    y = ordered(np.asarray(a).view(np.uint16))
    return int(np.abs(x - y).max())


@pytest.fixture(scope="module", params=list(FILES))
def setup(request):
    path = str(ROOT / FILES[request.param])
    csr = build_csr(read_ratings_csv(path))
    tcsr = t_build(t_read(path))
    gb = read_ratings_csv(path).global_bias
    return csr, tcsr, gb


def _models(setup, dtype):
    csr, _, gb = setup
    jm = j_pack(init_model(csr.n_users, csr.n_items, 8, gb, seed=3,
                           dtype=dtype))
    tm = PackedModel(T_u=to_torch(jm.T_u), T_i=to_torch(jm.T_i),
                     global_bias=torch.tensor(np.float32(jm.global_bias)),
                     n_factors=8)
    return jm, tm


def _devs(setup):
    csr, tcsr, _ = setup
    return (to_device(csr, item_major=True),
            t_to_device(tcsr, "cpu", item_major=True))


def _hp():
    return (JHyper(*(jnp.float32(v) for v in HPV)),
            Hyper(*(float(np.float32(v)) for v in HPV)))


def test_bf16_weights_cross_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 33)).astype(np.float32) * 10.0 ** rng.integers(
        -30, 30, size=(64, 33))
    j = jnp.asarray(x).astype(jnp.bfloat16)
    t = to_torch(j)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy_bf16(t).view(np.uint16),
                                  np.asarray(j).view(np.uint16))
    # torch's round to nearest even is JAX's astype.
    assert torch.equal(torch.from_numpy(x).to(torch.bfloat16), t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_add_in_order_is_xlas_rule(dtype):
    """XLA's scatter-add on the CPU adds the updates in their order and
    rounds after each add; ``scatter_add_in_order`` gives the same bits.
    Deltas far below the rows' ulp make the rule visible in bf16."""
    rng = np.random.default_rng(1)
    T = rng.normal(size=(7, 16)).astype(np.float32)
    idx = rng.integers(0, 7, size=500)
    idx[:200] = 3                                  # one heavy collision
    src = (rng.normal(size=(500, 16)) * 10.0 ** rng.integers(
        -4, 1, size=(500, 1))).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = jnp.asarray(T).astype(jdt).at[jnp.asarray(idx)].add(
        jnp.asarray(src).astype(jdt))
    tdt = getattr(torch, dtype)
    got = scatter_add_in_order(torch.from_numpy(T).to(tdt),
                               torch.from_numpy(idx),
                               torch.from_numpy(src).to(tdt))
    if dtype == "bfloat16":
        assert ulp_distance(got, want) == 0
        # torch's own index_add rounds once: another result.
        once = torch.from_numpy(T).to(tdt).index_add(
            0, torch.from_numpy(idx), torch.from_numpy(src).to(tdt))
        assert ulp_distance(once, want) > 0
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("collision", POLICIES)
def test_bf16_one_step_within_one_ulp(setup, collision):
    jd, td = _devs(setup)
    jhp, hp = _hp()
    for it in (0, 7):
        ja, tb = _models(setup, jnp.bfloat16)
        a = j_step(ja, jd, jhp, jax.random.PRNGKey(7), jnp.int32(it),
                   collision=collision)
        b = packed_step(tb, td, hp, prng_key(7), it, collision=collision)
        assert b.T_u.dtype == b.T_i.dtype == torch.bfloat16
        assert ulp_distance(b.T_u, a.T_u) <= 1
        assert ulp_distance(b.T_i, a.T_i) <= 1


@pytest.mark.parametrize("collision", POLICIES)
def test_bf16_five_steps_within_four_ulps(setup, collision):
    jd, td = _devs(setup)
    jhp, hp = _hp()
    ja, tb = _models(setup, jnp.bfloat16)
    a = j_run_steps(ja, jd, jhp, jax.random.PRNGKey(11), jnp.int32(5), 5,
                    True, collision)
    b = packed_run_steps(tb, td, hp, prng_key(11), 5, 5, True, collision)
    assert ulp_distance(b.T_u, a.T_u) <= 4
    assert ulp_distance(b.T_i, a.T_i) <= 4


@pytest.mark.parametrize("collision", ["mean", "sum"])
def test_float32_mean_sum_match(setup, collision):
    jd, td = _devs(setup)
    jhp, hp = _hp()
    ja, tb = _models(setup, jnp.float32)
    a = j_step(ja, jd, jhp, jax.random.PRNGKey(5), jnp.int32(3),
               collision=collision)
    b = packed_step(tb, td, hp, prng_key(5), 3, collision=collision)
    np.testing.assert_allclose(b.T_i.numpy(), np.asarray(a.T_i), rtol=0,
                               atol=2e-6)
    ja, tb = _models(setup, jnp.float32)
    a = j_run_steps(ja, jd, jhp, jax.random.PRNGKey(5), jnp.int32(0), 5,
                    True, collision)
    b = packed_run_steps(tb, td, hp, prng_key(5), 0, 5, True, collision)
    np.testing.assert_allclose(b.T_u.numpy(), np.asarray(a.T_u), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(b.T_i.numpy(), np.asarray(a.T_i), rtol=0,
                               atol=2e-6)


def test_mean_is_sum_over_counts(setup):
    """One step of mean moves each item by its pairs' deltas divided by
    their count: with one pair an item the two policies agree."""
    _, td = _devs(setup)
    _, hp = _hp()
    _, tb = _models(setup, jnp.float32)
    m = packed_step(tb, td, hp, prng_key(2), 0, collision="mean")
    s = packed_step(tb, td, hp, prng_key(2), 0, collision="sum")
    assert torch.equal(m.T_u, s.T_u)
    dm, ds = m.T_i - tb.T_i, s.T_i - tb.T_i
    moved = (ds != 0).any(dim=1)
    assert moved.any()
    assert torch.all((dm.abs() <= ds.abs() + 1e-7)[moved])


def test_bf16_eval_matches(setup):
    csr, tcsr, _ = setup
    ja, tb = _models(setup, jnp.bfloat16)
    want = j_evaluate_packed(ja, to_device(csr))
    got = evaluate_packed(tb, t_to_device(tcsr, "cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-6)
