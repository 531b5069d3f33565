"""The port's SGD step (``ops/packed.py``, the plain version of K0a on the
CPU) against the TPU package's ``packed_step``: first_wins, twin with the
item-major mirror and lean, and the fold-in step (items frozen).

The same model (drawn by the TPU package) and the same ratings go through
both.  The set of item rows a step changes is exactly equal (positions and
winners are bit-exact); the tables agree within atol 1e-5 after one step
and rtol 1e-4 / atol 1e-5 after 20 (float32 sums in another order).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cu2rec_torch.data.csr import build_csr as t_build
from cu2rec_torch.data.csr import to_device as t_to_device
from cu2rec_torch.data.ratings import read_ratings_csv as t_read
from cu2rec_torch.models.state import model_from_numpy
from cu2rec_torch.ops.packed import PackedModel, pack, packed_run_steps, \
    packed_step
from cu2rec_torch.ops.sgd import Hyper, prng_key
from cu2rec_tpu.data import build_csr, read_ratings_csv
from cu2rec_tpu.data.csr import to_device
from cu2rec_tpu.models.state import init_model, model_to_numpy
from cu2rec_tpu.ops.packed import pack as j_pack
from cu2rec_tpu.ops.packed import packed_run_steps as j_run_steps
from cu2rec_tpu.ops.packed import packed_step as j_step
from cu2rec_tpu.ops.sgd import Hyper as JHyper

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = {"toy": "tests/data/test_ratings.csv",
         "ml100k": "data/ml100k_ratings_train.csv"}
HPV = (0.05, 0.02, 0.03, 0.04, 0.05)
CASES = [("first_wins", False, True), ("twin", False, True),
         ("twin", True, True), ("first_wins", False, False)]


@pytest.fixture(scope="module", params=list(FILES))
def setup(request):
    path = str(ROOT / FILES[request.param])
    rd = read_ratings_csv(path)
    csr = build_csr(rd)
    jm = init_model(csr.n_users, csr.n_items, 8, rd.global_bias, seed=3)
    return csr, t_build(t_read(path)), jm


def _devs(setup, lean):
    csr, tcsr, _ = setup
    return (to_device(csr, item_major=True, lean=lean),
            t_to_device(tcsr, "cpu", item_major=True, lean=lean))


def _port_model(jm):
    return pack(model_from_numpy(model_to_numpy(jm), "cpu"))


def _hp():
    return (JHyper(*(jnp.float32(v) for v in HPV)),
            Hyper(*(float(np.float32(v)) for v in HPV)))


@pytest.mark.parametrize("collision,lean,train_items", CASES)
def test_one_step_matches(setup, collision, lean, train_items):
    jd, td = _devs(setup, lean)
    jm = setup[2]
    jhp, hp = _hp()
    for it in (0, 1, 4095):
        a0, b0 = j_pack(jm), _port_model(jm)
        a = j_step(a0, jd, jhp, jax.random.PRNGKey(7), jnp.int32(it),
                   train_items=train_items, collision=collision)
        b = packed_step(b0, td, hp, prng_key(7), it, train_items=train_items,
                        collision=collision)
        changed_j = np.any(np.asarray(a.T_i) != np.asarray(a0.T_i), axis=1)
        changed_t = (b.T_i != b0.T_i).any(dim=1).numpy()
        np.testing.assert_array_equal(changed_t, changed_j)
        if not train_items:
            assert not changed_t.any()
        np.testing.assert_allclose(b.T_u.numpy(), np.asarray(a.T_u),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(b.T_i.numpy(), np.asarray(a.T_i),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("collision,lean,train_items", CASES)
def test_twenty_steps_match(setup, collision, lean, train_items):
    jd, td = _devs(setup, lean)
    jm = setup[2]
    jhp, hp = _hp()
    b = packed_run_steps(_port_model(jm), td, hp, prng_key(11), 5, 20,
                         train_items, collision)
    # packed_run_steps donates its model: hand it a copy of the fixture's.
    a = j_run_steps(j_pack(jax.tree.map(jnp.copy, jm)), jd, jhp,
                    jax.random.PRNGKey(11), jnp.int32(5), 20, train_items,
                    collision)
    np.testing.assert_allclose(b.T_u.numpy(), np.asarray(a.T_u), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(b.T_i.numpy(), np.asarray(a.T_i), rtol=1e-4,
                               atol=1e-5)


def test_twin_mirror_and_lean_bit_identical(setup):
    _, td_full = _devs(setup, False)
    _, td_lean = _devs(setup, True)
    assert td_lean.it_users is None and td_lean.it_order is not None
    assert td_full.it_order is None and td_full.it_users is not None
    _, hp = _hp()
    a = b = _port_model(setup[2])
    for it in range(4):
        a = packed_step(a, td_full, hp, prng_key(11), it, collision="twin")
        b = packed_step(b, td_lean, hp, prng_key(11), it, collision="twin")
    assert torch.equal(a.T_u, b.T_u)
    assert torch.equal(a.T_i, b.T_i)


def test_step_leaves_its_inputs_alone(setup):
    _, td = _devs(setup, False)
    _, hp = _hp()
    pm = _port_model(setup[2])
    T_u, T_i = pm.T_u.clone(), pm.T_i.clone()
    for collision in ("first_wins", "twin", "mean", "sum"):
        packed_step(pm, td, hp, prng_key(1), 0, collision=collision)
        assert torch.equal(pm.T_u, T_u) and torch.equal(pm.T_i, T_i)


def test_tables_of_two_dtypes_raise(setup):
    _, td = _devs(setup, False)
    _, hp = _hp()
    pm = _port_model(setup[2])
    mixed = PackedModel(T_u=pm.T_u.bfloat16(), T_i=pm.T_i,
                        global_bias=pm.global_bias, n_factors=pm.n_factors)
    with pytest.raises(TypeError,
                       match="must both be float32 or both bfloat16"):
        packed_step(mixed, td, hp, prng_key(1), 0)


def test_twin_needs_item_major(setup):
    _, hp = _hp()
    td = t_to_device(setup[1], "cpu")
    with pytest.raises(ValueError, match="item-major"):
        packed_step(_port_model(setup[2]), td, hp, prng_key(1), 0,
                    collision="twin")


def test_kernel_widths_are_the_packed_widths():
    """K0a and K0b take every width ``packed_width`` gives (the port's and
    the TPU package's) for F < 512, and no other."""
    from cu2rec_torch.ops.packed import KERNEL_WIDTHS, packed_width
    from cu2rec_tpu.ops.packed import packed_width as j_packed_width

    widths = {packed_width(F) for F in range(512)}
    assert widths == set(KERNEL_WIDTHS)
    assert widths == {j_packed_width(F) for F in range(512)}
    assert packed_width(512) not in KERNEL_WIDTHS


@pytest.mark.parametrize("W", [32, 96, 640])
def test_kernel_tables_check_rejects_other_widths(W):
    from cu2rec_torch.ops.packed import check_kernel_tables

    T = torch.zeros((4, W))
    with pytest.raises(ValueError, match="K0a takes rows of"):
        check_kernel_tables("K0a", T, T)


def test_kernel_tables_check_rejects_unaligned_rows():
    """The kernels read rows as float4s: a table that starts off a 16-byte
    boundary is refused, one that starts on it is taken."""
    from cu2rec_torch.ops.packed import check_kernel_tables

    flat = torch.zeros(8 * 128 + 4)
    start = (-flat.data_ptr() // 4) % 4  # the first 16-byte boundary
    aligned = flat[start:start + 4 * 128].view(4, 128)
    check_kernel_tables("K0b", aligned, aligned)
    shifted = flat[start + 1:start + 1 + 4 * 128].view(4, 128)
    with pytest.raises(ValueError, match="T_i must start on a 16-byte"):
        check_kernel_tables("K0b", aligned, shifted)
