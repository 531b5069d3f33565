"""Kernel K1 (the ridge-Cholesky solve) and its plain version against the
TPU package's solvers: the Pallas kernel in interpret mode and the blocked
batched Cholesky.

Tolerance rtol 1e-3 / atol 1e-4: both sides are float32 Cholesky solves of
systems with condition number below ~10 (``spd_batch``), so they agree to
a few float32 ulps times N; this is tighter than the TPU package's own
2e-2 on purpose.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cu2rec_torch.ops import cuda_linalg
from cu2rec_torch.ops.als import SOLVERS, _ridge_finish
from cu2rec_torch.ops.cuda_linalg import (ridge_solve_batched_cuda,
                                          ridge_solve_reference)
from cu2rec_tpu.ops.batched_linalg import ridge_solve_batched
from cu2rec_tpu.ops.pallas_linalg import ridge_solve_batched_pallas

RTOL, ATOL = 1e-3, 1e-4


def spd_batch(B, N, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, N, N)).astype(np.float32)
    return np.einsum("bik,bjk->bij", A, A) / N + \
        np.eye(N, dtype=np.float32)[None] * 0.5


def _system(B, N, seed):
    G = spd_batch(B, N, seed=seed)
    rhs = np.random.default_rng(seed + 100).normal(
        size=(B, N)).astype(np.float32)
    return G, rhs


@pytest.mark.parametrize("B,N", [(9, 5), (130, 33), (64, 101)])
def test_plain_matches_pallas_interpret(B, N):
    G, rhs = _system(B, N, seed=N + 7)
    want = np.asarray(ridge_solve_batched_pallas(
        jnp.asarray(G), jnp.asarray(rhs), interpret=True))
    got = ridge_solve_reference(torch.from_numpy(G),
                                torch.from_numpy(rhs)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("N", [113, 301])
def test_plain_matches_blocked_above_pallas_ceiling(N):
    G, rhs = _system(3, N, seed=N)
    want = np.asarray(ridge_solve_batched(jnp.asarray(G), jnp.asarray(rhs)))
    got = ridge_solve_reference(torch.from_numpy(G),
                                torch.from_numpy(rhs)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("solver", SOLVERS)
def test_ridge_finish_every_solver_name_is_k1(solver):
    """On CPU tensors every solver name runs K1's plain version (the same
    numbers, exactly), and launches nothing."""
    G, rhs = _system(4, 12, seed=1)
    n0 = cuda_linalg.LAUNCHES
    got = _ridge_finish(torch.from_numpy(G), torch.from_numpy(rhs), solver)
    want = ridge_solve_reference(torch.from_numpy(G), torch.from_numpy(rhs))
    assert torch.equal(got, want)
    assert cuda_linalg.LAUNCHES == n0


def test_wrapper_rejects_bad_inputs():
    G, rhs = _system(2, 4, seed=0)
    G, rhs = torch.from_numpy(G), torch.from_numpy(rhs)
    with pytest.raises(TypeError):
        ridge_solve_batched_cuda(G.double(), rhs)
    with pytest.raises(ValueError):
        ridge_solve_batched_cuda(G[:, :3], rhs)
    with pytest.raises(ValueError):
        ridge_solve_batched_cuda(G, rhs[:, :3])
    with pytest.raises(ValueError):
        _ridge_finish(G, rhs, "cholesky")


def test_plain_solves_exactly_on_cpu():
    """The plain version against float64 numpy (an independent oracle)."""
    G, rhs = _system(6, 40, seed=3)
    want = np.linalg.solve(G.astype(np.float64),
                           rhs[..., None].astype(np.float64))[..., 0]
    got = ridge_solve_batched_cuda(torch.from_numpy(G),
                                   torch.from_numpy(rhs)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_smoke_names_the_tpu_kernel_it_replaces():
    """chip_smoke.py's kernels line names K1's TPU counterpart by the file
    and line of its definition."""
    import importlib.util
    import inspect
    import pathlib

    from cu2rec_tpu.ops import pallas_linalg

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    line = inspect.getsourcelines(pallas_linalg._ridge_kernel)[1]
    assert smoke._tpu_kernel_site("ops/pallas_linalg.py",
                                  "def _ridge_kernel") == \
        f"cu2rec_tpu/ops/pallas_linalg.py:{line}"
