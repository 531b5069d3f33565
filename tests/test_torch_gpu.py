"""Tests of the PyTorch port that need a CUDA device: kernel K1 against its
plain version on the card, and the serving engine on the card against the
same engine on the CPU.  Here, without a card, each skips with a reason.

This file imports neither JAX nor the TPU package, so that it also runs on
a machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu -q

Tolerance rtol 1e-3 / atol 1e-4 for ridge solves (float32 Cholesky of
well-conditioned systems, summed in another order on the card); recommend
scores rtol 1e-4 (the card's float32 matmul blocks its sums differently).
"""

import numpy as np
import pytest
import torch

RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU interpret mode)")
    return torch.device("cuda")


def _system(B, N, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, N, N)).astype(np.float32)
    G = np.einsum("bik,bjk->bij", A, A) / N + \
        np.eye(N, dtype=np.float32)[None] * 0.5
    return G, rng.normal(size=(B, N)).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N", [(7, 9), (1000, 51), (256, 100), (64, 101),
                                 (33, 301), (3, 400)])
def test_kernel_matches_plain(cuda_device, B, N):
    from cu2rec_torch.ops import cuda_linalg

    G, rhs = _system(B, N, seed=N)
    Gd = torch.from_numpy(G).to(cuda_device)
    rd = torch.from_numpy(rhs).to(cuda_device)
    n0 = cuda_linalg.LAUNCHES
    got = cuda_linalg.ridge_solve_batched_cuda(Gd, rd)
    torch.cuda.synchronize()
    assert cuda_linalg.LAUNCHES == n0 + 1
    want = cuda_linalg.ridge_solve_reference(Gd, rd)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    exact = np.linalg.solve(G.astype(np.float64),
                            rhs[..., None].astype(np.float64))[..., 0]
    np.testing.assert_allclose(got.cpu().numpy(), exact, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.gpu
def test_kernel_wrapper_rejects_what_it_cannot_take(cuda_device):
    from cu2rec_torch.ops.cuda_linalg import ridge_solve_batched_cuda

    G, rhs = _system(4, 16, seed=0)
    Gd = torch.from_numpy(G).to(cuda_device)
    rd = torch.from_numpy(rhs).to(cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ridge_solve_batched_cuda(Gd.transpose(1, 2), rd)
    with pytest.raises(TypeError):
        ridge_solve_batched_cuda(Gd.half(), rd)
    with pytest.raises(ValueError):
        ridge_solve_batched_cuda(Gd, rd.cpu())
    out = ridge_solve_batched_cuda(Gd[:0], rd[:0])
    assert out.shape == (0, 16)


@pytest.mark.gpu
def test_engine_on_card_matches_cpu(cuda_device):
    """The same engine on the card (K1 for the implicit solve) and on the
    CPU (its plain version)."""
    from cu2rec_torch.data.csr import csr_from_arrays
    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.ops import cuda_linalg
    from cu2rec_torch.serve.engine import ServingEngine

    rng = np.random.default_rng(11)
    U, I, F = 40, 3000, 16
    d = {"p": rng.normal(0, 0.3, (U, F)), "q": rng.normal(0, 0.3, (I, F)),
         "user_bias": rng.normal(0, 0.1, U),
         "item_bias": rng.normal(0, 0.1, I), "global_bias": [3.5]}
    deg = rng.integers(6, 13, U)
    csr = csr_from_arrays(np.repeat(np.arange(U), deg),
                          np.concatenate([rng.choice(I, n, replace=False)
                                          for n in deg]),
                          np.ones(deg.sum(), np.float32), U, I)
    gpu = ServingEngine(model_from_numpy(d, cuda_device), device=cuda_device)
    cpu = ServingEngine(model_from_numpy(d, "cpu"), device="cpu")
    assert gpu.T_i.device.type == "cuda"
    users = list(range(16))
    gv, gi = gpu.recommend_known(users, csr, k=10)
    cv, ci = cpu.recommend_known(users, csr, k=10)
    np.testing.assert_allclose(gv, cv, rtol=1e-4)
    agree = np.mean(gi == ci)
    assert agree > 0.95, agree  # ids may swap only at near-ties

    rated = rng.integers(0, I, (20, 9)).astype(np.int32)
    vals = (rng.random((20, 9)) * 3).astype(np.float32)
    mask = np.ones((20, 9), bool)
    n0 = cuda_linalg.LAUNCHES
    g_rows, _ = gpu.fold_in_implicit(rated, vals, mask)
    assert cuda_linalg.LAUNCHES == n0 + 1
    c_rows, _ = cpu.fold_in_implicit(rated, vals, mask)
    np.testing.assert_allclose(g_rows, c_rows, rtol=RTOL, atol=ATOL)
    cfg_rows = gpu.fold_in(rated, vals, mask)[0]
    assert np.isfinite(cfg_rows).all()
