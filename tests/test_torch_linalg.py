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
from cu2rec_torch.ops.cuda_linalg import (BUCKET_ROWS, SHARED_MAX_N,
                                          kernel_for,
                                          ridge_solve_batched_cuda,
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


def test_wrapper_rejects_bad_inputs():
    G, rhs = _system(2, 4, seed=0)
    G, rhs = torch.from_numpy(G), torch.from_numpy(rhs)
    with pytest.raises(TypeError):
        ridge_solve_batched_cuda(G.double(), rhs)
    with pytest.raises(ValueError):
        ridge_solve_batched_cuda(G[:, :3], rhs)
    with pytest.raises(ValueError):
        ridge_solve_batched_cuda(G, rhs[:, :3])


def test_plain_solves_exactly_on_cpu():
    """The plain version against float64 numpy (an independent oracle)."""
    G, rhs = _system(6, 40, seed=3)
    want = np.linalg.solve(G.astype(np.float64),
                           rhs[..., None].astype(np.float64))[..., 0]
    got = ridge_solve_batched_cuda(torch.from_numpy(G),
                                   torch.from_numpy(rhs)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# K1's kernels in the order of the N they take.
KERNEL_ORDER = ("bucket32", "bucket64", "bucket104", "bucket128", "shared",
                "global")


def test_kernel_for_takes_every_n_with_one_kernel():
    """Every N from 1 to 512 goes to one of K1's kernels, each kernel
    taking one run of N, in order."""
    names = [kernel_for(n) for n in range(1, 513)]
    assert set(names) == set(KERNEL_ORDER) == set(cuda_linalg._KERNEL_CODE)
    ranks = [KERNEL_ORDER.index(name) for name in names]
    assert ranks == sorted(ranks)


def _workspace_bytes(n):
    """The one-block-a-system kernel's triangle, pivot column and solution."""
    return 4 * (n * (n + 1) // 2 + 2 * n)


@pytest.mark.parametrize("kernel", KERNEL_ORDER)
def test_kernel_for_gives_each_kernel_only_what_fits_it(kernel):
    """A bucket takes N with N + 1 within its rows and no smaller bucket
    takes them; the shared-memory kernel takes the N whose workspace fits
    an H100 block's 232,448 bytes of shared memory above the buckets, the
    global-scratch kernel the rest."""
    ns = [n for n in range(1, 513) if kernel_for(n) == kernel]
    assert ns == list(range(ns[0], ns[-1] + 1))
    if kernel.startswith("bucket"):
        rows = int(kernel[len("bucket"):])
        smaller = [r for r in BUCKET_ROWS if r < rows]
        assert ns[-1] + 1 == rows
        assert ns[0] == (max(smaller) if smaller else 1)
    elif kernel == "shared":
        assert ns[0] == max(BUCKET_ROWS) and ns[-1] == SHARED_MAX_N
        assert _workspace_bytes(SHARED_MAX_N) <= 232_448
    else:
        assert ns[0] == SHARED_MAX_N + 1 and ns[-1] == 512
        assert _workspace_bytes(SHARED_MAX_N + 1) > 232_448


def _smoke():
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_smoke_shapes_reach_every_kernel_on_both_sides_of_each_edge():
    """chip_smoke.py checks K1 on the card at N on both sides of every edge
    between two of its kernels, so it reaches all of them."""
    smoke = _smoke()
    ns = {n for _, n in smoke.SHAPES}
    assert {kernel_for(n) for n in ns} == set(KERNEL_ORDER)
    edges = [n for n in range(1, 512) if kernel_for(n) != kernel_for(n + 1)]
    assert len(edges) == len(KERNEL_ORDER) - 1
    for n in edges:
        assert {n, n + 1} <= ns
    assert smoke.MAIN_SHAPE in smoke.SHAPES


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
