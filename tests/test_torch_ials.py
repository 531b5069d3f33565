"""The port's implicit fold-in (Gramian + per-user corrections + the K1
ridge solve) against the TPU package's ``ials_fold_in`` through its Pallas
solver (interpret mode on the CPU) and its blocked solver.

Tolerance rtol 1e-3 / atol 1e-4: float32 Gramians summed in another order,
then float32 Cholesky solves of well-conditioned systems (reg > 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cu2rec_torch.ops.ials import gramian as t_gramian
from cu2rec_torch.ops.ials import ials_fold_in as t_fold_in
from cu2rec_tpu.ops.ials import gramian as j_gramian
from cu2rec_tpu.ops.ials import ials_fold_in as j_fold_in

RTOL, ATOL = 1e-3, 1e-4


def _inputs(F, I=60, B=5, D=7, seed=0):
    rng = np.random.default_rng(seed)
    Y = rng.normal(0, 0.3, (I, F)).astype(np.float32)
    cols = rng.integers(0, I, (B, D)).astype(np.int32)
    vals = rng.random((B, D)).astype(np.float32) * 3
    mask = rng.random((B, D)) > 0.3
    mask[:, 0] = True
    return Y, cols, vals, mask


def test_gramian_matches():
    Y, *_ = _inputs(16)
    np.testing.assert_allclose(t_gramian(torch.from_numpy(Y)).numpy(),
                               np.asarray(j_gramian(jnp.asarray(Y))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("solver", ["pallas", "blocked"])
@pytest.mark.parametrize("F", [8, 16])
def test_ials_fold_in_matches(solver, F):
    Y, cols, vals, mask = _inputs(F, seed=F)
    want = np.asarray(j_fold_in(jnp.asarray(Y), cols, vals, mask,
                                alpha=40.0, reg=0.1, solver=solver))
    got = t_fold_in(torch.from_numpy(Y), cols, vals, mask, alpha=40.0,
                    reg=0.1, solver=solver)
    assert got.shape == (5, F) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_ials_fold_in_masked_entries_drop_out():
    """A masked entry contributes nothing, whatever its item and value."""
    Y, cols, vals, mask = _inputs(8, seed=2)
    mask[:, -1] = False
    a = t_fold_in(torch.from_numpy(Y), cols, vals, mask, 5.0, 0.3)
    cols2, vals2 = cols.copy(), vals.copy()
    cols2[:, -1] = (cols[:, -1] + 13) % Y.shape[0]
    vals2[:, -1] = 99.0
    b = t_fold_in(torch.from_numpy(Y), cols2, vals2, mask, 5.0, 0.3)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
