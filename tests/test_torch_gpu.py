"""Tests of the PyTorch port that need a CUDA device: each kernel against
its plain version on the card (K1 at N on both sides of every edge between
its kernels), and the serving engine and trainer on the card against the
same code on the CPU.  Here, without a card, each skips with a reason.

This file imports neither JAX nor the TPU package, so that it also runs on
a machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu -q

Tolerance rtol 1e-3 / atol 1e-4 for ridge solves (float32 Cholesky of
well-conditioned systems, summed in another order on the card); recommend
scores rtol 1e-4 (the card's float32 matmul blocks its sums differently).
"""

import functools
import time

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


def _system_on_card(B, N, seed, device, ridge=None):
    """B random SPD systems made on the card: A·Aᵀ/N + I/2, or with
    ``ridge`` XᵀX/2N + ridge·I for X of 2N rows (condition number ~34)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if ridge is None:
        A = torch.randn((B, N, N), generator=gen, device=device)
        G = A @ A.mT / N + 0.5 * torch.eye(N, device=device)
    else:
        X = torch.randn((B, 2 * N, N), generator=gen, device=device)
        G = X.mT @ X / (2 * N) + ridge * torch.eye(N, device=device)
    rhs = torch.randn((B, N), generator=gen, device=device)
    return (G + G.mT) / 2, rhs


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 7, 256])
@pytest.mark.parametrize("N", [1, 2, 31, 32, 33, 63, 64, 65, 100, 101, 103,
                               104, 127, 128, 129, 301, 339, 400])
def test_kernel_matches_plain_at_every_kernel_edge(cuda_device, B, N):
    """Every kernel ``kernel_for`` picks, on both sides of each edge, at
    one system, a block's spare systems and a full wave."""
    from cu2rec_torch.ops import cuda_linalg

    G, rhs = _system_on_card(B, N, seed=B * 1000 + N, device=cuda_device)
    n0 = cuda_linalg.LAUNCHES
    got = cuda_linalg.ridge_solve_batched_cuda(G, rhs)
    torch.cuda.synchronize()
    assert cuda_linalg.LAUNCHES == n0 + 1
    want = cuda_linalg.ridge_solve_reference(G, rhs)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_shared_kernel_at_n301_on_a_sweeps_worth_of_systems(cuda_device):
    """N = 301, ALS at F = 300: ``kernel_for`` picks the one-block-a-system
    kernel with its triangle in shared memory, and it solves 4,096 systems
    (many waves of blocks) as the plain version does."""
    from cu2rec_torch.ops import cuda_linalg

    assert cuda_linalg.kernel_for(301) == "shared"
    G, rhs = _system_on_card(4096, 301, seed=301, device=cuda_device)
    n0 = cuda_linalg.LAUNCHES
    got = cuda_linalg.ridge_solve_batched_cuda(G, rhs)
    torch.cuda.synchronize()
    assert cuda_linalg.LAUNCHES == n0 + 1
    want = cuda_linalg.ridge_solve_reference(G, rhs)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


# The shared-memory kernel's largest error against a float64 solve, by the
# kind of system (``_system_on_card``'s default and ridge 1e-3): twice what
# the one-block-a-system kernel before the blocked design read at N = 301,
# B = 4,096 (8.0e-6 and 2.43e-5, NVIDIA H100 80GB HBM3, 700 W).
SHARED_F64_BOUND = {"spd": 1.6e-5, "small_ridge": 4.9e-5}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["spd", "small_ridge"])
@pytest.mark.parametrize("B", [1, 54, 133, 4096])
@pytest.mark.parametrize("N", [128, 129, 200, 256, 300, 301, 337, 338])
def test_shared_kernel_matches_plain_and_float64(cuda_device, N, B, kind):
    """The shared-memory kernel (the blocked Cholesky, 128 ≤ N ≤ 338) at one
    system, an item-side chunk (54), one past a wave of 132 SMs and a
    sweep's worth, on well-conditioned and small-ridge systems: within
    the file's tolerance of its plain version, within
    ``SHARED_F64_BOUND`` of a float64 solve (``torch.linalg``, a yardstick
    here only), and counted once as ``k1.shared`` under a trace.  At
    N = 301, B = 4,096 the kernel before the blocked design read 8.0e-6
    (well-conditioned) and 2.43e-5 (ridge 1e-3) against float64."""
    from cu2rec_torch.ops import cuda_linalg
    from cu2rec_torch.utils import timing

    assert cuda_linalg.kernel_for(N) == "shared"
    G, rhs = _system_on_card(B, N, seed=N * 10_000 + B, device=cuda_device,
                             ridge=None if kind == "spd" else 1e-3)
    n0 = cuda_linalg.LAUNCHES
    timing.trace_start()
    try:
        got = cuda_linalg.ridge_solve_batched_cuda(G, rhs)
    finally:
        counters = timing.trace_stop()["counters"]
    torch.cuda.synchronize()
    assert cuda_linalg.LAUNCHES == n0 + 1
    assert counters == {"k1.shared": 1}
    want = cuda_linalg.ridge_solve_reference(G, rhs)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    exact = torch.linalg.solve(G.double(), rhs.double()[..., None])[..., 0]
    assert float((got.double() - exact).abs().max()) <= SHARED_F64_BOUND[kind]


@pytest.mark.gpu
@pytest.mark.parametrize("N", [20, 50, 100, 200])
def test_kernel_matches_plain_with_a_small_ridge(cuda_device, N):
    """A Gram matrix of 2N random rows plus λ = 1e-3 on the diagonal."""
    from cu2rec_torch.ops import cuda_linalg

    G, rhs = _system_on_card(64, N, seed=N, device=cuda_device, ridge=1e-3)
    got = cuda_linalg.ridge_solve_batched_cuda(G, rhs)
    want = cuda_linalg.ridge_solve_reference(G, rhs)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_every_kernel_launches_on_its_own(cuda_device):
    """Each kernel, launched past the wrapper where N fits it, solves the
    same systems; a bucket too small for N is refused."""
    from cu2rec_torch.ops import cuda_linalg

    G, rhs = _system_on_card(9, 30, seed=3, device=cuda_device)
    want = cuda_linalg.ridge_solve_reference(G, rhs)
    for kernel in ("bucket32", "bucket64", "bucket104", "bucket128",
                   "shared", "global"):
        got = cuda_linalg._launch(G, rhs, kernel)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    G, rhs = _system_on_card(2, 32, seed=4, device=cuda_device)
    with pytest.raises(RuntimeError, match="bucket32"):
        cuda_linalg._launch(G, rhs, "bucket32")


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


def _ratings(U, I, seed, empty_users=(3,), empty_items=(5,)):
    """A random CSR with a few users and items that have no ratings."""
    from cu2rec_torch.data.csr import csr_from_arrays

    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 12, U)
    deg[[u for u in empty_users if u < U]] = 0
    users = np.repeat(np.arange(U), deg)
    items = rng.integers(0, I, len(users))
    items[np.isin(items, empty_items)] = 0
    vals = rng.integers(1, 11, len(users)) / 2.0
    return csr_from_arrays(users, items, vals.astype(np.float32), U, I)


def _packed(U, I, F, seed, device):
    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.ops.packed import pack

    rng = np.random.default_rng(seed)
    d = {"p": rng.normal(0, 0.1, (U, F)), "q": rng.normal(0, 0.1, (I, F)),
         "user_bias": rng.normal(0, 0.1, U),
         "item_bias": rng.normal(0, 0.1, I), "global_bias": [3.5]}
    return pack(model_from_numpy(d, device))


STEP_CASES = [("first_wins", False, True), ("twin", False, True),
              ("twin", True, True), ("first_wins", False, False)]
# One F for each row width the kernels take: W = 64, 128, 256, 384, 512.
WIDTH_FS = [16, 100, 200, 300, 450]


def _check_kernel_steps(device, U, I, F, collision, train_items, dev):
    """K0a against its plain version, step by step from the same tables:
    the same rows change, and the tables agree within 1e-5 (float32 FMA
    contraction and another sum order in the kernel; positions and winners
    are exact)."""
    from cu2rec_torch.ops import cuda_sgd
    from cu2rec_torch.ops.packed import packed_step, packed_step_reference
    from cu2rec_torch.ops.sgd import Hyper, prng_key

    pm = _packed(U, I, F, seed=1, device=device)
    hp = Hyper(0.05, 0.02, 0.03, 0.04, 0.05)
    for it in (0, 1, 4095):
        n0 = cuda_sgd.LAUNCHES.total()
        got = packed_step(pm, dev, hp, prng_key(42), it,
                          train_items=train_items, collision=collision)
        torch.cuda.synchronize()
        assert cuda_sgd.LAUNCHES.total() == n0 + 1
        want = packed_step_reference(pm, dev, hp, prng_key(42), it,
                                     train_items=train_items,
                                     collision=collision)
        changed_got = (got.T_i != pm.T_i).any(dim=1)
        changed_want = (want.T_i != pm.T_i).any(dim=1)
        assert torch.equal(changed_got, changed_want)
        assert torch.equal((got.T_u != pm.T_u).any(dim=1),
                           (want.T_u != pm.T_u).any(dim=1))
        torch.testing.assert_close(got.T_u, want.T_u, rtol=0, atol=1e-5)
        torch.testing.assert_close(got.T_i, want.T_i, rtol=0, atol=1e-5)
        if not train_items:
            assert got.T_i is pm.T_i
        pm = got


@pytest.mark.gpu
@pytest.mark.parametrize("F", WIDTH_FS)
@pytest.mark.parametrize("collision,lean,train_items", STEP_CASES)
@pytest.mark.parametrize("U,I", [(300, 120), (301, 97)])
def test_sgd_step_kernel_matches_plain(cuda_device, F, collision, lean,
                                       train_items, U, I):
    """Every row width; 301 users and 97 items are no multiple of the rows
    a warp or a block of either kernel takes."""
    from cu2rec_torch.data.csr import to_device

    dev = to_device(_ratings(U, I, seed=F), cuda_device,
                    item_major=collision == "twin", lean=lean)
    _check_kernel_steps(cuda_device, U, I, F, collision, train_items, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("F", WIDTH_FS)
def test_sgd_step_kernel_one_user_frozen_items(cuda_device, F):
    """``predict``'s fold-in: one user, items frozen."""
    from cu2rec_torch.data.csr import to_device

    dev = to_device(_ratings(1, 120, seed=F, empty_users=()), cuda_device)
    _check_kernel_steps(cuda_device, 1, 120, F, "first_wins", False, dev)


def _ratings_built_on_card(U, I, seed, device, item_major, lean):
    """A ``DeviceRatings`` made on the card by torch kernels from unsorted
    (user, item, rating) triples, as an ingest on the card would make it."""
    from cu2rec_torch.data.csr import DeviceRatings

    rng = np.random.default_rng(seed)
    n = 4000
    users = torch.from_numpy(rng.integers(2, U, n)).to(device)
    items = torch.from_numpy(rng.integers(1, I, n)).to(device)
    vals = torch.from_numpy((rng.integers(1, 11, n) / 2.0).astype(
        np.float32)).to(device)

    def indptr(keys, size):
        counts = torch.bincount(keys, minlength=size)
        return torch.cat([counts.new_zeros(1), counts.cumsum(0)]).int()

    order = torch.argsort(users, stable=True)
    row_ids, indices = users[order].int(), items[order].int()
    data = vals[order].contiguous()
    extra = {}
    if item_major:
        it_order = torch.argsort(indices, stable=True)
        extra["it_indptr"] = indptr(indices.long(), I)
        if lean:
            extra["it_order"] = it_order.int()
        else:
            extra["it_users"] = row_ids[it_order].contiguous()
            extra["it_vals"] = data[it_order].contiguous()
    return DeviceRatings(indptr=indptr(users, U), indices=indices, data=data,
                         row_ids=row_ids, nnz=n, n_users=U, n_items=I,
                         **extra)


@pytest.mark.gpu
@pytest.mark.parametrize("collision,lean,train_items", STEP_CASES)
def test_sgd_step_kernel_on_ratings_built_on_the_card(cuda_device, collision,
                                                      lean, train_items):
    """Ratings arrays written by torch kernels, finished by a synchronize
    before the step as ``DeviceRatings`` asks: K0a samples from them before
    it waits on the kernel ahead of it, and still matches its plain
    version."""
    dev = _ratings_built_on_card(300, 120, 7, cuda_device,
                                 collision == "twin", lean)
    torch.cuda.synchronize()
    _check_kernel_steps(cuda_device, 300, 120, 100, collision, train_items,
                        dev)


@pytest.mark.gpu
def test_sgd_step_kernel_widths(cuda_device):
    """The library's widest row is the widest width the wrapper passes."""
    from cu2rec_torch.ops import cuda_sgd
    from cu2rec_torch.ops.packed import KERNEL_WIDTHS

    assert cuda_sgd._load().sgd_step_max_width() == max(KERNEL_WIDTHS)


@pytest.mark.gpu
def test_sgd_step_run_keeps_election_buffer_clean(cuda_device):
    """Across a run of first_wins steps the shared election buffer is
    reset by each item kernel: the run equals step-by-step plain steps."""
    from cu2rec_torch.data.csr import to_device
    from cu2rec_torch.ops.packed import packed_run_steps, packed_step_reference
    from cu2rec_torch.ops.sgd import Hyper, prng_key

    csr = _ratings(200, 64, seed=5)
    dev = to_device(csr, cuda_device)
    pm = _packed(200, 64, 8, seed=2, device=cuda_device)
    hp = Hyper(0.05, 0.02, 0.02, 0.02, 0.02)
    got = packed_run_steps(pm, dev, hp, prng_key(3), 10, 6)
    want = pm
    for it in range(10, 16):
        want = packed_step_reference(want, dev, hp, prng_key(3), it)
    torch.testing.assert_close(got.T_u, want.T_u, rtol=0, atol=1e-4)
    torch.testing.assert_close(got.T_i, want.T_i, rtol=0, atol=1e-4)


def _eval_rows(rng, U, n, order):
    """n user ids: sorted, in random order, or sorted around one user of
    1,500 ratings in a row (a run across several warps' 64-rating chunks
    and a block's 512)."""
    if order == "long run":
        return np.sort(np.concatenate([rng.integers(0, U, n - 1500),
                                       np.full(1500, U // 2)]))
    rows = rng.integers(0, U, n)
    return np.sort(rows) if order == "sorted" else rows


@pytest.mark.gpu
@pytest.mark.parametrize("F", WIDTH_FS)
@pytest.mark.parametrize("n,order", [(1, "sorted"), (4999, "sorted"),
                                     (70_001, "sorted"), (70_001, "random"),
                                     (3001, "long run")])
def test_eval_kernel_matches_plain(cuda_device, F, n, order):
    """K0b against its plain version (both sum in float64): rtol 1e-6, for
    every row width, rows in any order, and n no multiple of a chunk."""
    from cu2rec_torch.ops import cuda_loss
    from cu2rec_torch.ops.loss import packed_error_sums_reference

    rng = np.random.default_rng(n)
    U, I = 500, 300
    pm = _packed(U, I, F, seed=3, device=cuda_device)
    rows = torch.from_numpy(_eval_rows(rng, U, n, order).astype(
        np.int32)).to(cuda_device)
    cols = torch.from_numpy(rng.integers(0, I, n).astype(np.int32)).to(
        cuda_device)
    vals = torch.from_numpy((rng.integers(1, 11, n) / 2.0).astype(
        np.float32)).to(cuda_device)
    n0 = cuda_loss.LAUNCHES.total()
    got = cuda_loss.packed_error_sums_cuda(pm.T_u, pm.T_i, 3.5, rows, cols,
                                           vals, F)
    again = cuda_loss.packed_error_sums_cuda(pm.T_u, pm.T_i, 3.5, rows,
                                             cols, vals, F)
    torch.cuda.synchronize()
    assert cuda_loss.LAUNCHES.total() == n0 + 2
    assert torch.equal(got, again)  # deterministic reduction
    want = packed_error_sums_reference(pm.T_u, pm.T_i, pm.global_bias, rows,
                                       cols, vals, F)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("W", [32, 128, 512])
def test_row_gather_kernel_is_exact(cuda_device, W):
    from cu2rec_torch.ops.cuda_gather import row_gather

    g = torch.Generator().manual_seed(W)
    table = torch.randn((5000, W), generator=g).to(cuda_device)
    for M in (1, 15, 16, 17, 1000, 70_001):
        idx = torch.randint(0, 5000, (M,), generator=g).to(cuda_device)
        n0 = row_gather.LAUNCHES
        got = row_gather(table, idx.to(torch.int32))
        torch.cuda.synchronize()
        assert row_gather.LAUNCHES == n0 + 1
        assert torch.equal(got, table[idx])


@pytest.mark.gpu
@pytest.mark.parametrize("I", [1, 64, 448, 454])
def test_smem_gather_kernel_is_exact(cuda_device, I):
    """Up to the largest table that fits (454 rows of 512 bytes); M off the
    32 indices a warp takes and the 1,024 a block takes."""
    from cu2rec_torch.ops.cuda_gather import smem_gather

    g = torch.Generator().manual_seed(I)
    table = torch.randn((I, 128), generator=g).to(cuda_device)
    for M in (1, 31, 33, 1025, 2047, 2049, 300_001):
        idx = torch.randint(0, I, (M,), generator=g).to(cuda_device)
        n0 = smem_gather.LAUNCHES
        got = smem_gather(table, idx.to(torch.int32))
        torch.cuda.synchronize()
        assert smem_gather.LAUNCHES == n0 + 1
        assert torch.equal(got, table[idx])
    big = torch.zeros((455, 128), device=cuda_device)
    n0 = smem_gather.LAUNCHES
    with pytest.raises(ValueError, match="does not fit"):
        smem_gather(big, torch.zeros(4, dtype=torch.int32,
                                     device=cuda_device))
    assert smem_gather.LAUNCHES == n0


@pytest.mark.gpu
@pytest.mark.parametrize("W", [4, 12, 32, 64, 256, 512])
def test_smem_gather_kernel_every_row_width(cuda_device, W):
    """Rows narrower than a warp's 32 float4s (idle lanes) and wider ones
    (several float4s a lane), with NaN rows for indices out of range."""
    from cu2rec_torch.ops.cuda_gather import SMEM_LIMIT_BYTES, smem_gather

    I = min(300, SMEM_LIMIT_BYTES // (4 * W))
    g = torch.Generator().manual_seed(W)
    table = torch.randn((I, W), generator=g).to(cuda_device)
    idx = torch.randint(0, I, (5001,), generator=g).to(torch.int32)
    bad = torch.tensor([0, 31, 32, 5000])
    idx[bad] = torch.tensor([I, -1, 1 << 30, -(1 << 31)], dtype=torch.int32)
    got = smem_gather(table, idx.to(cuda_device)).cpu()
    good = torch.ones(5001, dtype=torch.bool)
    good[bad] = False
    assert torch.isnan(got[bad]).all()
    assert torch.equal(got[good], table.cpu()[idx[good].long()])


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["row_gather", "smem_gather"])
def test_gather_kernels_give_nan_rows_for_indices_out_of_range(cuda_device,
                                                               which):
    from cu2rec_torch.ops import cuda_gather

    fn = getattr(cuda_gather, which)
    g = torch.Generator().manual_seed(7)
    table = torch.randn((100, 128), generator=g).to(cuda_device)
    idx = torch.randint(0, 100, (3000,), generator=g).to(torch.int32)
    bad = torch.tensor([0, 17, 18, 2999])
    idx[bad] = torch.tensor([100, -1, 1 << 30, -(1 << 31)], dtype=torch.int32)
    got = fn(table, idx.to(cuda_device)).cpu()
    good = torch.ones(3000, dtype=torch.bool)
    good[bad] = False
    assert torch.isnan(got[bad]).all()
    assert torch.equal(got[good], table.cpu()[idx[good].long()])


@pytest.mark.gpu
def test_train_on_card_matches_cpu(cuda_device):
    """A short training run on the card (K0a, K0b) and on the CPU (their
    plain versions) from the same tables: per-eval RMSE within 1e-4."""
    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.ops import cuda_loss, cuda_sgd
    from cu2rec_torch.train.trainer import train
    from cu2rec_torch.utils.config import Config
    from cu2rec_torch.utils.metrics import MetricsLogger

    csr = _ratings(400, 150, seed=9)
    rng = np.random.default_rng(0)
    d = {"p": rng.normal(0, 0.1, (400, 8)), "q": rng.normal(0, 0.1, (150, 8)),
         "user_bias": np.zeros(400), "item_bias": np.zeros(150),
         "global_bias": [2.75]}
    runs = {}
    for device in (cuda_device, "cpu"):
        for collision in ("first_wins", "twin"):
            cfg = Config(total_iterations=60, n_factors=8, check_error=20,
                         learning_rate=0.05, collision_policy=collision)
            logger = MetricsLogger(verbose=False)
            n0 = (cuda_sgd.LAUNCHES.total(), cuda_loss.LAUNCHES.total())
            train(csr, csr, cfg, 2.75, model=model_from_numpy(d, device),
                  logger=logger, device=device)
            if device != "cpu":
                assert cuda_sgd.LAUNCHES.total() > n0[0]
                assert cuda_loss.LAUNCHES.total() > n0[1]
            runs[(str(device), collision)] = [
                (r["train_rmse"], r["test_mae"]) for r in logger.history
                if r["event"] == "eval"]
    for collision in ("first_wins", "twin"):
        np.testing.assert_allclose(runs[("cuda", collision)],
                                   runs[("cpu", collision)], atol=1e-4)


def _family_ratings(U, I, seed):
    """Ratings with power-law item popularity (items far above the small
    bucket caps) and users 0 and 7 unrated."""
    from cu2rec_torch.data.csr import csr_from_arrays

    rng = np.random.default_rng(seed)
    u = rng.integers(0, U, 20 * U)
    u = u[~np.isin(u, (0, 7))]
    i = np.minimum((I * rng.power(0.4, len(u))).astype(np.int64), I - 1)
    keys = np.unique(u * I + i)
    r = (rng.integers(1, 11, len(keys)) / 2.0).astype(np.float32)
    return csr_from_arrays(keys // I, keys % I, r, U, I)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["als", "ials"])
@pytest.mark.parametrize("side", ["users", "items"])
@pytest.mark.parametrize("budget", [200_000, 20_000])
def test_half_sweep_on_card_matches_cpu(cuda_device, family, side, budget):
    """An ALS or iALS half sweep with heavy rows (caps 4, 8) on the card
    (K1) and on the CPU (its plain version), from the same chunks (one a
    bucket at the larger budget, several at the smaller): rtol
    1e-3 / atol 1e-4 (float32 Grams summed in another order, then the
    solve).  Every chunk's solve launches K1; unrated rows stay as they
    were."""
    from cu2rec_torch.data.csr import transpose_csr
    from cu2rec_torch.ops import als, cuda_linalg
    from cu2rec_torch.ops.ials import ials_half_sweep

    csr = _family_ratings(300, 120, seed=3)
    ip, ind, dat = ((csr.indptr, csr.indices, csr.data) if side == "users"
                    else transpose_csr(csr))
    n_self = len(ip) - 1
    n_other = 120 if side == "users" else 300
    F = 100 if family == "als" else 64
    rng = np.random.default_rng(1)
    W = 128
    S = np.zeros((n_self, W), np.float32)
    O = np.zeros((n_other, W), np.float32)
    S[:, :F + 1] = rng.normal(0, 0.1, (n_self, F + 1))
    O[:, :F + 1] = rng.normal(0, 0.1, (n_other, F + 1))
    if family == "ials":
        S, O = S[:, :F].copy(), O[:, :F].copy()
    caps = (4, 8)
    runs = {}
    for device in ("cpu", cuda_device):
        chunks = als.prepare_chunks(
            torch.from_numpy(ind).to(device), torch.from_numpy(dat).to(
                device), ip, F, len(ind), caps=caps, budget=budget)
        assert "heavy" in [c[0] for c in chunks]
        Sd, Od = torch.from_numpy(S).to(device), torch.from_numpy(O).to(
            device)
        n0 = cuda_linalg.LAUNCHES
        if family == "als":
            out = als.als_half_sweep(Sd, Od, chunks, 3.0, 0.05, 0.02, F)
        else:
            # alpha 2 and λ 0.5 keep these random systems well
            # conditioned (the fixed tolerance holds for such).
            out = ials_half_sweep(Sd, Od, chunks, 2.0, 0.5)
        if device != "cpu":
            torch.cuda.synchronize()
            assert cuda_linalg.LAUNCHES == n0 + len(chunks)
        runs[str(device)] = out.cpu()
    torch.testing.assert_close(runs["cuda"], runs["cpu"], rtol=RTOL,
                               atol=ATOL)
    empty = torch.from_numpy(np.diff(ip) == 0)
    assert torch.equal(runs["cuda"][empty], torch.from_numpy(S)[empty])


@pytest.mark.gpu
@pytest.mark.parametrize("lean", [False, True])
def test_bpr_steps_on_card_match_cpu(cuda_device, lean):
    """Three BPR steps on the card and on the CPU from the same tables: the
    same sampled ids, tables within 1e-5 (float32 sums of a row in another
    order on the card)."""
    from cu2rec_torch.data.csr import to_device
    from cu2rec_torch.ops.bpr import bpr_draws, bpr_step
    from cu2rec_torch.ops.sgd import Hyper, prng_key

    csr = _family_ratings(400, 150, seed=5)
    hp = Hyper(0.1, 0.01, 0.01, 0.0, 0.01)
    pms = {d: _packed(400, 150, 100, seed=2, device=d)
           for d in ("cpu", cuda_device)}
    devs = {d: to_device(csr, d, item_major=True, lean=lean)
            for d in ("cpu", cuda_device)}
    for it in range(3):
        a = bpr_draws(devs[cuda_device], prng_key(9), it)
        b = bpr_draws(devs["cpu"], prng_key(9), it)
        for name in a._fields:
            assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), \
                name
        for d in pms:
            pms[d] = bpr_step(pms[d], devs[d], hp, prng_key(9), it)
        for side in ("T_u", "T_i"):
            torch.testing.assert_close(getattr(pms[cuda_device], side).cpu(),
                                       getattr(pms["cpu"], side), rtol=0,
                                       atol=1e-5)


def _bpr_ratings(U, I, seed):
    """``_family_ratings`` less items 3 and I - 2: users 0 and 7 and those
    two items have no interactions, rows that only the masks reach."""
    from cu2rec_torch.data.csr import csr_from_arrays

    csr = _family_ratings(U, I, seed)
    users = np.repeat(np.arange(U), np.diff(csr.indptr))
    keep = ~np.isin(csr.indices, (3, I - 2))
    return csr_from_arrays(users[keep], csr.indices[keep], csr.data[keep],
                           U, I)


def _bf16_step(x):
    """One bf16 rounding step at each entry of ``x`` (float32): 2^(e - 7)
    for |x| in [2^e, 2^(e+1)), 0 at 0."""
    a = x.abs()
    e = torch.floor(torch.log2(torch.where(a > 0, a, torch.ones_like(a))))
    return torch.where(a > 0, torch.exp2(e - 7), torch.zeros_like(a))


@pytest.mark.gpu
@pytest.mark.parametrize("lean", [False, True])
@pytest.mark.parametrize("F,dtype", [
    (50, "float32"), (100, "float32"), (200, "float32"), (300, "float32"),
    (500, "float32"), (50, "bfloat16"), (300, "bfloat16")])
def test_bpr_kernel_matches_plain_step_on_card(cuda_device, lean, F, dtype):
    """K6 against the plain step on the card, three steps, each from the
    plain step's tables, at every row width K6 takes (W = 64, 128, 256,
    384 and 512): float32 tables within 1e-5 (a row's sums in
    another order, the card's expf), bf16 within one bf16 rounding step of
    each entry (both round float32 once); the unrated users' rows and
    every padding column unchanged; exactly one launch a step."""
    from cu2rec_torch.data.csr import to_device
    from cu2rec_torch.ops import cuda_bpr
    from cu2rec_torch.ops.bpr import bpr_draws, bpr_step, bpr_step_reference
    from cu2rec_torch.ops.packed import PackedModel
    from cu2rec_torch.ops.sgd import Hyper, prng_key

    U, I = 400, 150
    dev = to_device(_bpr_ratings(U, I, seed=5), cuda_device,
                    item_major=True, lean=lean)
    hp = Hyper(*(float(np.float32(v)) for v in (0.1, 0.01, 0.02, 0.03,
                                                 0.01)))
    dt = getattr(torch, dtype)
    pm = _packed(U, I, F, seed=2, device=cuda_device)
    pm = PackedModel(T_u=pm.T_u.to(dt), T_i=pm.T_i.to(dt),
                     global_bias=pm.global_bias, n_factors=F)
    key = prng_key(2 ** 32 + 9)
    for it in range(3):
        d = bpr_draws(dev, key, it)
        assert not d.has_u[[0, 7]].any() and not d.has_y[[3, I - 2]].any()
        n0 = cuda_bpr.LAUNCHES
        got = bpr_step(pm, dev, hp, key, it)
        torch.cuda.synchronize()
        assert cuda_bpr.LAUNCHES == n0 + 1
        want = bpr_step_reference(pm, dev, hp, key, it)
        for side in ("T_u", "T_i"):
            assert getattr(got, side).dtype == dt
            g, w = (getattr(t, side).float() for t in (got, want))
            if dtype == "float32":
                torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
            else:
                gap = (g - w).abs()
                assert bool((gap <= _bf16_step(torch.maximum(
                    g.abs(), w.abs()))).all()), float(gap.max())
            assert not g[:, F + 1:].any()
        assert torch.equal(got.T_u[[0, 7]], pm.T_u[[0, 7]])
        pm = want


@pytest.mark.gpu
def test_family_trainers_on_card_launch_their_kernels(cuda_device):
    """train_als launches K1 and K0b on the card, train_ials K1; both
    within 1e-4 of the CPU run's metrics."""
    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.ops import cuda_linalg, cuda_loss
    from cu2rec_torch.train.als import train_als
    from cu2rec_torch.train.ials import train_ials
    from cu2rec_torch.utils.config import Config
    from cu2rec_torch.utils.metrics import MetricsLogger

    csr = _family_ratings(300, 120, seed=8)
    rng = np.random.default_rng(4)
    d = {"p": rng.normal(0, 0.1, (300, 16)), "q": rng.normal(0, 0.1, (120, 16)),
         "user_bias": np.zeros(300), "item_bias": np.zeros(120),
         "global_bias": [3.0]}
    hist = {}
    for device in ("cpu", cuda_device):
        for name, train in (("als", train_als), ("ials", train_ials)):
            cfg = Config(total_iterations=2, n_factors=16, P_reg=0.5,
                         Q_reg=0.5)
            logger = MetricsLogger(verbose=False)
            n0 = (cuda_linalg.LAUNCHES, cuda_loss.LAUNCHES.total())
            kw = {"global_bias": 3.0} if name == "als" else {"alpha": 2.0}
            train(csr, csr, cfg, model=model_from_numpy(d, device),
                  logger=logger, device=device, **kw)
            if device != "cpu":
                assert cuda_linalg.LAUNCHES > n0[0]
                assert (cuda_loss.LAUNCHES.total() > n0[1]) == \
                    (name == "als")
            hist[(str(device), name)] = [
                [r[k] for k in ("train_rmse", "test_mae", "auc",
                                "recall_at_k") if k in r]
                for r in logger.history if r["event"] == "eval"]
    for name in ("als", "ials"):
        np.testing.assert_allclose(hist[("cuda", name)], hist[("cpu", name)],
                                   atol=1e-4)


def _cli(main, args, capsys):
    capsys.readouterr()
    assert main(args) == 0
    return capsys.readouterr().out


def _planted_csvs(tmp_path):
    """A small planted set written, mapped and split by the preprocessing
    CLIs (the native path): the train and test CSVs."""
    from cu2rec_torch.cli import map_items, split, synth

    raw = tmp_path / "raw.csv"
    assert synth.main([str(raw), "--users", "500", "--items", "200",
                       "--ratings", "30000", "--seed", "3"]) == 0
    assert map_items.main([str(raw)]) == 0
    assert split.main([str(tmp_path / "raw_mapped.csv"), "0.1"]) == 0
    return (str(tmp_path / "raw_mapped_train.csv"),
            str(tmp_path / "raw_mapped_test.csv"))


@pytest.mark.gpu
def test_native_reader_feeds_mf_on_the_card(cuda_device, tmp_path, capsys):
    """mf on the card reads its CSVs and writes its components through the
    native library (``native.CALLS`` rises) and launches K0a and K0b; its
    metric lines agree with the CPU run's within 1e-4."""
    from cu2rec_torch.cli import mf
    from cu2rec_torch.data import native
    from cu2rec_torch.ops import cuda_loss, cuda_sgd

    train, test = _planted_csvs(tmp_path)
    cfg = tmp_path / "cfg.txt"
    cfg.write_text("0 40 8 0.05 7 0.02 0.02 0.02 0.02 32 20 2 0.2\n")
    lines = {}
    for device in ("cuda", "cpu"):
        n0 = (native.CALLS, cuda_sgd.LAUNCHES.total(),
              cuda_loss.LAUNCHES.total())
        out = _cli(mf.main, ["-c", str(cfg), train, test, "--outdir",
                             str(tmp_path / device), "--device", device],
                   capsys)
        assert native.CALLS >= n0[0] + 7      # 2 reads, 5 component CSVs
        if device == "cuda":
            assert cuda_sgd.LAUNCHES.total() > n0[1]
            assert cuda_loss.LAUNCHES.total() > n0[2]
        lines[device] = [[float(ln.split("MAE:")[1].split()[0]),
                          float(ln.split("RMSE:")[1])]
                         for ln in out.splitlines()
                         if ln.startswith(("TRAIN:", "TEST:"))]
    assert len(lines["cuda"]) == 6
    np.testing.assert_allclose(lines["cuda"], lines["cpu"], atol=1e-4)


@pytest.mark.gpu
def test_evaluate_on_the_card_matches_the_cpu(cuda_device, tmp_path, capsys):
    """evaluate on the card (K0b) against --device cpu: RMSE and MAE within
    1e-6, recall@k and NDCG@k equal, from a checkpoint and from the five
    component CSVs."""
    import json

    from cu2rec_torch.cli import evaluate, mf
    from cu2rec_torch.ops import cuda_loss

    train, test = _planted_csvs(tmp_path)
    cfg = tmp_path / "cfg.txt"
    cfg.write_text("0 30 8 0.05 7 0.02 0.02 0.02 0.02\n")
    ck = str(tmp_path / "ck.npz")
    _cli(mf.main, ["-c", str(cfg), train, test, "--outdir", str(tmp_path),
                   "--checkpoint", ck, "--device", "cpu"], capsys)
    base = str(tmp_path / "raw_mapped_train_f8_")
    parts = ["-p", base + "p.csv", "-q", base + "q.csv", "-u",
             base + "user_bias.csv", "-i", base + "item_bias.csv", "-g",
             base + "global_bias.csv"]
    for form in (["--checkpoint", ck], parts):
        got = {}
        for device in ("cuda", "cpu"):
            n0 = cuda_loss.LAUNCHES.total()
            out = _cli(evaluate.main, form + [test, "--ranking", "--train",
                                              train, "--device", device],
                       capsys)
            assert (cuda_loss.LAUNCHES.total() > n0) == (device == "cuda")
            got[device] = json.loads(out.splitlines()[-1])
        for key in ("test_rmse", "test_mae"):
            assert abs(got["cuda"][key] - got["cpu"][key]) <= 1e-6
        for key in ("recall_at_k", "ndcg_at_k"):
            assert got["cuda"][key] == pytest.approx(got["cpu"][key],
                                                     abs=1e-6)


# ---- bf16 tables and the mean/sum collision policies ----------------------

VARIANTS = [("bfloat16", "first_wins"), ("bfloat16", "twin"),
            ("bfloat16", "mean"), ("bfloat16", "sum"),
            ("float32", "mean"), ("float32", "sum")]
# The gate on the item side of bf16 mean and sum, in bf16 ulps of the
# chain's largest magnitude: a chain of rounded adds may flip twice.
BF16_CHAIN_ULPS = 2.0


def _bf16_scaled_error(got, want, pre, peak=None):
    """The largest |got − want| in bf16 ulps of each entry's operand scale
    max(|pre|, |want|, peak): an update that cancels most of an entry
    leaves the float32 rounding of its operands, one ulp of their scale, in
    a small result; ``peak`` is the largest magnitude a chain of adds
    reached."""
    g, w, p = (t.to(torch.float32) for t in (got, want, pre))
    scale = torch.maximum(p.abs(), w.abs())
    if peak is not None:
        scale = torch.maximum(scale, peak)
    scale = scale.clamp(min=2.0 ** -126)
    _, e = torch.frexp(scale)
    return float(((g - w).abs() / torch.ldexp(torch.ones_like(scale),
                                              e - 8)).max())


def _hot_ratings(U, I, seed):
    """Ratings where item 0 is every user's only item for a third of the
    users: its run of sampled pairs is far longer than the item kernel's
    32, so the long-run kernel adds it."""
    from cu2rec_torch.data.csr import csr_from_arrays

    csr = _ratings(U, I, seed)
    users = np.repeat(np.arange(U), np.diff(csr.indptr))
    items = csr.indices.copy()
    hot = users % 3 == 0
    items[hot] = 0
    keys = np.unique(users.astype(np.int64) * I + items)
    return csr_from_arrays((keys // I).astype(np.int32),
                           (keys % I).astype(np.int32),
                           np.full(len(keys), 4.0, np.float32), U, I)


@pytest.mark.gpu
@pytest.mark.parametrize("F", WIDTH_FS)
@pytest.mark.parametrize("dtype,collision", VARIANTS)
@pytest.mark.parametrize("hot", [False, True])
def test_sgd_step_kernel_variants_match_plain(cuda_device, F, dtype,
                                              collision, hot):
    """K0a on bf16 tables and under mean/sum against its plain version,
    step by step from the same tables: float32 within 1e-5, bf16 within one
    bf16 ulp of the operands' scale (two of the chain's largest magnitude
    on the item side of mean and sum, where each add rounds); mean and sum
    give the same bits in two calls (a fixed order of adds, no float
    atomics)."""
    from cu2rec_torch.data.csr import to_device
    from cu2rec_torch.ops import cuda_sgd
    from cu2rec_torch.ops.packed import (PackedModel, packed_step,
                                         packed_step_reference)
    from cu2rec_torch.ops.sgd import Hyper, prng_key

    U, I = 301, 97
    csr = _hot_ratings(U, I, seed=F) if hot else _ratings(U, I, seed=F)
    dev = to_device(csr, cuda_device, item_major=collision == "twin")
    pm = _packed(U, I, F, seed=1, device=cuda_device)
    if dtype == "bfloat16":
        pm = PackedModel(T_u=pm.T_u.bfloat16(), T_i=pm.T_i.bfloat16(),
                         global_bias=pm.global_bias, n_factors=F)
    hp = Hyper(0.05, 0.02, 0.03, 0.04, 0.05)
    for it in (0, 1, 4095):
        n0 = cuda_sgd.LAUNCHES[pm.T_u.dtype, collision]
        got = packed_step(pm, dev, hp, prng_key(42), it,
                          collision=collision)
        again = packed_step(pm, dev, hp, prng_key(42), it,
                            collision=collision)
        torch.cuda.synchronize()
        assert cuda_sgd.LAUNCHES[pm.T_u.dtype, collision] == n0 + 2
        chain = collision in ("mean", "sum")
        peak = torch.zeros(pm.T_i.shape, device=cuda_device)
        want = packed_step_reference(pm, dev, hp, prng_key(42), it,
                                     collision=collision,
                                     peak=peak if chain else None)
        if chain:
            assert torch.equal(got.T_u, again.T_u)
            assert torch.equal(got.T_i, again.T_i)
        for side in ("T_u", "T_i"):
            g, w, p = (getattr(x, side) for x in (got, want, pm))
            assert g.dtype == p.dtype
            if dtype == "float32":
                torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
            elif side == "T_i" and chain:
                assert _bf16_scaled_error(g, w, p, peak) <= BF16_CHAIN_ULPS, \
                    side
            else:
                assert _bf16_scaled_error(g, w, p) <= 1.0, side
        pm = got


def _drop_last_of_longest_run(idx, src):
    """The pairs of a step without the last pair of its longest run."""
    at = torch.nonzero(idx == torch.bincount(idx).argmax())[:, 0]
    keep = torch.ones_like(idx, dtype=torch.bool)
    keep[at[-1]] = False
    return idx[keep], src[keep]


@pytest.mark.gpu
@pytest.mark.parametrize("F", WIDTH_FS)
@pytest.mark.parametrize("collision,hot", [("sum", False), ("sum", True),
                                           ("mean", False)])
def test_bf16_chain_gate_rejects_a_dropped_pair(cuda_device, monkeypatch, F,
                                                collision, hot):
    """The gate of the item side of bf16 mean and sum fails a kernel that
    drops a pair: K0a held against a plain version that leaves out the
    last pair of the step's longest run reads above BF16_CHAIN_ULPS at one
    of three steps.  (Under mean on a long run the dropped delta, divided
    by the run's count, may fall below a bf16 ulp: no bf16 comparison can
    see it there.)"""
    from cu2rec_torch.data.csr import to_device
    from cu2rec_torch.ops import packed
    from cu2rec_torch.ops.packed import PackedModel, packed_step
    from cu2rec_torch.ops.sgd import Hyper, prng_key

    U, I = 301, 97
    csr = _hot_ratings(U, I, seed=F) if hot else _ratings(U, I, seed=F)
    dev = to_device(csr, cuda_device)
    pm = _packed(U, I, F, seed=1, device=cuda_device)
    pm = PackedModel(T_u=pm.T_u.bfloat16(), T_i=pm.T_i.bfloat16(),
                     global_bias=pm.global_bias, n_factors=F)
    hp = Hyper(0.05, 0.02, 0.03, 0.04, 0.05)
    real = packed.scatter_add_in_order
    monkeypatch.setattr(packed, "scatter_add_in_order",
                        lambda T, idx, src, peak=None: real(
                            T, *_drop_last_of_longest_run(idx, src), peak))
    readings = []
    for it in (0, 1, 4095):
        got = packed_step(pm, dev, hp, prng_key(42), it, collision=collision)
        peak = torch.zeros(pm.T_i.shape, device=cuda_device)
        bad = packed.packed_step_reference(pm, dev, hp, prng_key(42), it,
                                           collision=collision, peak=peak)
        readings.append(_bf16_scaled_error(got.T_i, bad.T_i, pm.T_i, peak))
    assert max(readings) > BF16_CHAIN_ULPS, readings


@pytest.mark.gpu
def test_sgd_step_kernel_rejects_tables_of_two_dtypes(cuda_device):
    from cu2rec_torch.data.csr import to_device
    from cu2rec_torch.ops.cuda_sgd import sgd_step_cuda
    from cu2rec_torch.ops.sgd import Hyper, prng_key

    pm = _packed(30, 20, 16, seed=1, device=cuda_device)
    dev = to_device(_ratings(30, 20, seed=1), cuda_device)
    hp = Hyper(0.05, 0.02, 0.03, 0.04, 0.05)
    with pytest.raises(TypeError, match="T_i must be torch.bfloat16"):
        sgd_step_cuda(pm.T_u.bfloat16(), pm.T_i, 3.5, dev, hp, prng_key(1),
                      0, n_factors=16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sgd_step_cuda(pm.T_u.half(), pm.T_i.half(), 3.5, dev, hp,
                      prng_key(1), 0, n_factors=16)


@pytest.mark.gpu
@pytest.mark.parametrize("F", WIDTH_FS)
@pytest.mark.parametrize("n,order", [(4999, "sorted"), (70_001, "random"),
                                     (3001, "long run")])
def test_eval_kernel_on_bf16_tables_matches_plain(cuda_device, F, n, order):
    """K0b over bf16 tables (rows upcast as they load) against its plain
    version over the same bf16 values: rtol 1e-6, the same bits twice."""
    from cu2rec_torch.ops import cuda_loss
    from cu2rec_torch.ops.loss import packed_error_sums_reference

    rng = np.random.default_rng(n)
    U, I = 500, 300
    pm = _packed(U, I, F, seed=3, device=cuda_device)
    T_u, T_i = pm.T_u.bfloat16(), pm.T_i.bfloat16()
    rows = torch.from_numpy(_eval_rows(rng, U, n, order).astype(
        np.int32)).to(cuda_device)
    cols = torch.from_numpy(rng.integers(0, I, n).astype(np.int32)).to(
        cuda_device)
    vals = torch.from_numpy((rng.integers(1, 11, n) / 2.0).astype(
        np.float32)).to(cuda_device)
    n0 = cuda_loss.LAUNCHES[torch.bfloat16]
    got = cuda_loss.packed_error_sums_cuda(T_u, T_i, 3.5, rows, cols, vals,
                                           F)
    again = cuda_loss.packed_error_sums_cuda(T_u, T_i, 3.5, rows, cols,
                                             vals, F)
    torch.cuda.synchronize()
    assert cuda_loss.LAUNCHES[torch.bfloat16] == n0 + 2
    assert torch.equal(got, again)
    want = packed_error_sums_reference(T_u, T_i, pm.global_bias, rows, cols,
                                       vals, F)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.gpu
def test_train_bf16_and_mean_on_card_track_cpu(cuda_device):
    """The SGD trainer with bf16 tables and with mean collisions on the
    card against the same run on the CPU: the losses within 2e-3."""
    from cu2rec_torch.train.trainer import train
    from cu2rec_torch.utils.config import Config
    from cu2rec_torch.utils.metrics import MetricsLogger

    csr = _ratings(400, 150, seed=9)
    for kw in ({"dtype": "bfloat16"}, {"collision_policy": "mean"},
               {"collision_policy": "sum", "dtype": "bfloat16"}):
        losses = {}
        for device in ("cpu", "cuda"):
            cfg = Config(total_iterations=30, n_factors=16, check_error=10,
                         learning_rate=0.05, **kw)
            model, losses[device] = train(
                csr, csr, cfg, 3.0, logger=MetricsLogger(verbose=False),
                device=device)
        assert losses["cpu"].keys() == losses["cuda"].keys()
        for k in losses["cpu"]:
            assert abs(losses["cpu"][k] - losses["cuda"][k]) <= 2e-3, kw


# ---- The runs of mean/sum at many blocks ----------------------------------

# kLong and kBig of csrc/sgd_step.cuh: the longest run the item kernel adds
# itself, and the runs the long-run kernel takes first.
K_LONG, K_BIG = 32, 896


def _run_ratings(U, I, seed):
    """Ratings at a size that spans many blocks of every collision kernel:
    users 0-99 have no rating; single-rating users, scattered over the
    user ids, give item 7 a run of 2,000 pairs (several long-run tiles,
    above kBig), items 11 and 12 runs of exactly kLong and kLong + 1, item
    13 a run of 100 and item I - 1 one of 36 at every step; the other users
    rate 1-4 random items."""
    from cu2rec_torch.data.csr import csr_from_arrays

    rng = np.random.default_rng(seed)
    ids = rng.permutation(np.arange(100, U))
    fixed = [(7, 2000), (11, K_LONG), (12, K_LONG + 1), (13, 100),
             (I - 1, 36)]
    users, items, at = [], [], 0
    for item, n in fixed:
        users.append(ids[at:at + n])
        items.append(np.full(n, item))
        at += n
    rest = ids[at:]
    deg = rng.integers(1, 5, len(rest))
    users.append(np.repeat(rest, deg))
    items.append(rng.integers(14, I - 1, int(deg.sum())))
    users, items = np.concatenate(users), np.concatenate(items)
    keys = np.unique(users.astype(np.int64) * I + items)
    return csr_from_arrays((keys // I).astype(np.int32),
                           (keys % I).astype(np.int32),
                           (rng.integers(1, 11, len(keys)) / 2.0).astype(
                               np.float32), U, I)


@pytest.mark.gpu
@pytest.mark.parametrize("U,I", [(20_011, 3_001), (300_007, 3_001)])
@pytest.mark.parametrize("iteration", [0, 1, 4095])
def test_collision_runs_match_stable_sort(cuda_device, U, I, iteration):
    """The step's sampling and counting sort on the card alone
    (``collision_runs_cuda``): the run offsets and each run's users bit for
    bit ``torch.sort(items[has], stable=True)`` and ``torch.bincount``;
    300,007 users map a long run's bitmap in two chunks.  The counts buffer
    is left zero."""
    from cu2rec_torch.data.csr import to_device
    from cu2rec_torch.ops.cuda_sgd import collision_runs_cuda
    from cu2rec_torch.ops.sgd import prng_key, sample_items

    dev = to_device(_run_ratings(U, I, seed=iteration), cuda_device)
    counts = torch.zeros(I, dtype=torch.int32, device=cuda_device)
    for _ in range(2):
        offsets, users = collision_runs_cuda(dev, prng_key(3), iteration,
                                             counts=counts)
        torch.cuda.synchronize()
        assert not counts.any()
        items, _r, has = sample_items(prng_key(3), iteration, dev.indptr,
                                      dev.indices, dev.data)
        who = torch.nonzero(has)[:, 0]
        keys = items[who]
        n = torch.bincount(keys, minlength=I)
        assert int(n[7]) == 2000 and int(n[11]) == K_LONG
        assert int(n[12]) == K_LONG + 1 and int(n[I - 1]) == 36
        assert not has[:100].any()
        want = torch.zeros(I + 1, dtype=torch.int64, device=cuda_device)
        want[1:] = torch.cumsum(n, 0)
        assert torch.equal(offsets.long(), want)
        assert torch.equal(users.long(),
                           who[torch.sort(keys, stable=True).indices])


@pytest.mark.gpu
@pytest.mark.parametrize("F", WIDTH_FS)
@pytest.mark.parametrize("dtype,collision", [
    ("float32", "mean"), ("float32", "sum"), ("bfloat16", "mean"),
    ("bfloat16", "sum")])
@pytest.mark.parametrize("hot", [False, True])
def test_mean_sum_steps_at_many_blocks_match_plain(cuda_device, F, dtype,
                                                   collision, hot):
    """The mean/sum variants at U = 20,011, I = 3,001 (many blocks of each
    collision kernel), uniform items or the runs of ``_run_ratings``, step
    by step from the same tables: float32 within 1e-5, bf16 within
    BF16_CHAIN_ULPS of the chain's scale on the item side (one ulp on the
    user side), the same bits twice, through a run of steps that carries
    the counts buffer as the trainer does.  Under sum the 2,000-pair run
    adds 2,000 deltas to one row, which then reaches |20| and drives the
    rows of its users to |1e4| within two steps, where one float32
    rounding is 1e-3: the float32 gate is 1e-5 of max(1, the entry's
    magnitude, the chain's largest magnitude), the 1e-5 of the other tests
    at the unit scale of their tables."""
    from cu2rec_torch.data.csr import to_device
    from cu2rec_torch.ops.packed import (PackedModel, packed_run_steps,
                                         packed_step, packed_step_reference)
    from cu2rec_torch.ops.sgd import Hyper, prng_key

    U, I = 20_011, 3_001
    csr = _run_ratings(U, I, seed=F) if hot else _ratings(U, I, seed=F)
    dev = to_device(csr, cuda_device)
    pm = _packed(U, I, F, seed=1, device=cuda_device)
    if dtype == "bfloat16":
        pm = PackedModel(T_u=pm.T_u.bfloat16(), T_i=pm.T_i.bfloat16(),
                         global_bias=pm.global_bias, n_factors=F)
    hp = Hyper(0.05, 0.02, 0.03, 0.04, 0.05)
    start = pm
    for it in (0, 1, 2):
        got = packed_step(pm, dev, hp, prng_key(42), it, collision=collision)
        again = packed_step(pm, dev, hp, prng_key(42), it,
                            collision=collision)
        peak = torch.zeros(pm.T_i.shape, device=cuda_device)
        want = packed_step_reference(pm, dev, hp, prng_key(42), it,
                                     collision=collision, peak=peak)
        torch.cuda.synchronize()
        assert torch.equal(got.T_u, again.T_u)
        assert torch.equal(got.T_i, again.T_i)
        for side in ("T_u", "T_i"):
            g, w, p = (getattr(x, side) for x in (got, want, pm))
            if dtype == "float32":
                scale = torch.maximum(w.abs(), p.abs()).clamp(min=1.0)
                if side == "T_i":
                    scale = torch.maximum(scale, peak)
                assert ((g - w).abs() <= 1e-5 * scale).all(), side
            elif side == "T_i":
                assert _bf16_scaled_error(g, w, p, peak) <= BF16_CHAIN_ULPS
            else:
                assert _bf16_scaled_error(g, w, p) <= 1.0
        pm = got
    run = packed_run_steps(start, dev, hp, prng_key(42), 0, 3, True,
                           collision)
    assert torch.equal(run.T_u, pm.T_u) and torch.equal(run.T_i, pm.T_i)


# ---- K0a's sharded mode (csrc/sgd_sharded.cu) ---------------------------

SHARD_POLICIES = ["first_wins", "twin", "mean", "sum"]


def _shard_steps(mesh, csr, F, policy, dtype, steps=3, train_items=True):
    """The sharded kernel step against the plain local step of this
    rank's blocks, step by step from the same blocks: the largest
    difference (float32), or of bf16 ulps of the operands' scale (bf16:
    the step rounds once).  The item side goes through dT and the apply
    only at dp > 1 (``SHARD_APPLIES``)."""
    from cu2rec_torch.ops import cuda_sgd
    from cu2rec_torch.ops.sgd import Hyper
    from cu2rec_torch.parallel.sharded import (
        ShardedEngine, _local_step_packed,
    )
    from cu2rec_torch.utils.config import Config

    cfg = Config(n_factors=F, collision_policy=policy, dtype=dtype, seed=3)
    eng = ShardedEngine(csr, csr, cfg, mesh=mesh)
    T_u, T_i, mu = eng.init_model(eng.n_users, eng.n_items, 3.5)
    hp = Hyper(0.05, 0.02, 0.03, 0.04, 0.05)
    d = eng.train_dev
    worst = 0.0
    split = train_items and policy != "twin" and mesh.n_dp > 1
    for it in range(steps):
        n0 = cuda_sgd.SHARD_LAUNCHES.total()
        a0 = cuda_sgd.SHARD_APPLIES.total()
        got = cuda_sgd.sgd_step_sharded_cuda(
            T_u, T_i, float(mu), d, hp, eng.key, it, n_factors=F, mesh=mesh,
            n_users_global=eng.n_users, train_items=train_items,
            collision=policy)
        want = _local_step_packed(
            T_u, T_i, mu, d.indptr, d.indices, d.data, hp, eng.key, it,
            eng.n_users, F, d.it_indptr, d.it_users, d.it_vals, mesh=mesh,
            train_items=train_items, collision=policy)
        torch.cuda.synchronize()
        assert cuda_sgd.SHARD_LAUNCHES.total() == n0 + 1
        assert cuda_sgd.SHARD_APPLIES.total() == a0 + int(split)
        for g, w, p in zip(got, want, (T_u, T_i)):
            assert g.dtype == p.dtype
            if dtype == "float32":
                worst = max(worst, float((g - w).abs().max()))
            else:
                worst = max(worst, _bf16_scaled_error(g, w, p))
        if not train_items:
            assert got[1] is T_i
        T_u, T_i = got
    return worst


def _csr_args(csr):
    return (csr.indptr, csr.indices, csr.data, csr.n_users, csr.n_items)


@functools.lru_cache(maxsize=None)
def _dp2_shard_errs(F, dtype):
    """Each policy's worst kernel-against-plain difference over two gloo
    ranks sharing the card as a (2, 1) grid, at F and dtype."""
    from cu2rec_torch.parallel.distributed import launch

    ranks = launch(_gpu_grid_job, 2, "gloo", "cuda",
                   args=(2, 1, _csr_args(_ratings(301, 97, seed=F)), F,
                         dtype), timeout=300)
    return {p: max(r[p] for r in ranks) for p in SHARD_POLICIES}


@pytest.mark.gpu
@pytest.mark.parametrize("n_dp", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", SHARD_POLICIES)
@pytest.mark.parametrize("F", WIDTH_FS)
def test_sharded_step_kernel_matches_plain(cuda_device, F, policy, dtype,
                                           n_dp):
    """Every row width, on a grid of one rank (dp = 1: the item side
    writes the new rows itself) and on two gloo ranks sharing the card
    (dp = 2: the deltas' live columns summed over dp and applied): the
    split kernels against the plain local step, float32 within 1e-5, bf16
    within one ulp of the operands' scale."""
    from cu2rec_torch.parallel.sharded import make_mesh

    if n_dp == 1:
        worst = _shard_steps(make_mesh(1, 1, cuda_device),
                             _ratings(301, 97, seed=F), F, policy, dtype)
    else:
        worst = _dp2_shard_errs(F, dtype)[policy]
    assert worst <= (1e-5 if dtype == "float32" else 1.0)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("policy", ["first_wins", "mean", "sum"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", WIDTH_FS)
def test_sharded_item_side_written_directly_is_the_applied_deltas(
        cuda_device, F, dtype, policy, hot):
    """At dp = 1 the item side writes the new T_i itself, and allocates no
    dT and launches no apply.  The same step's item side written as dT
    (``_sharded_step(..., deltas=True)``, what dp > 1 sums) gives, as
    ``(T_i.float() + dT)`` rounded to the table type and padded with zero
    columns, the same bits: uniform items, and a hot item of ~1,000 pairs
    that the long-run kernel adds a slice of columns a block."""
    from cu2rec_torch.ops import cuda_sgd
    from cu2rec_torch.ops.sgd import Hyper
    from cu2rec_torch.parallel.sharded import ShardedEngine, make_mesh
    from cu2rec_torch.utils.config import Config

    U, I = (3001, 97) if hot else (301, 97)
    csr = _hot_ratings(U, I, seed=F) if hot else _ratings(U, I, seed=F)
    mesh = make_mesh(1, 1, cuda_device)
    cfg = Config(n_factors=F, collision_policy=policy, dtype=dtype, seed=3)
    eng = ShardedEngine(csr, csr, cfg, mesh=mesh)
    T_u, T_i, mu = eng.init_model(eng.n_users, eng.n_items, 3.5)
    hp = Hyper(0.05, 0.02, 0.03, 0.04, 0.05)
    wd = cuda_sgd.delta_width(F)
    kw = dict(n_factors=F, mesh=mesh, n_users_global=eng.n_users,
              collision=policy)
    for it in range(3):
        n0 = cuda_sgd.SHARD_LAUNCHES.total()
        a0 = cuda_sgd.SHARD_APPLIES.total()
        got = cuda_sgd.sgd_step_sharded_cuda(T_u, T_i, float(mu),
                                             eng.train_dev, hp, eng.key, it,
                                             **kw)
        T_u2, dT = cuda_sgd._sharded_step(
            T_u, T_i, float(mu), eng.train_dev, hp, eng.key, it, **kw,
            deltas=True)
        torch.cuda.synchronize()
        assert cuda_sgd.SHARD_LAUNCHES.total() == n0 + 1
        assert cuda_sgd.SHARD_APPLIES.total() == a0
        assert dT.shape == (T_i.shape[0], wd) and dT.dtype == torch.float32
        want = torch.zeros_like(T_i)
        want[:, :wd] = (T_i[:, :wd].float() + dT).to(T_i.dtype)
        assert torch.equal(_bits(got[1]), _bits(want)), it
        assert torch.equal(_bits(got[0]), _bits(T_u2)), it
        assert (got[1] != T_i).any(), it
        T_u, T_i = got


@pytest.mark.gpu
def test_sharded_step_kernel_users_only(cuda_device):
    from cu2rec_torch.parallel.sharded import make_mesh

    worst = _shard_steps(make_mesh(1, 1, cuda_device),
                         _ratings(301, 97, seed=2), 100, "first_wins",
                         "float32", train_items=False)
    assert worst <= 1e-5


def _gpu_grid_job(n_dp, n_ip, csr_args, F=100, dtype="float32"):
    """One gloo rank sharing the card: every policy's kernel steps against
    the plain steps over the grid's collectives."""
    from cu2rec_torch.data.csr import CSRRatings
    from cu2rec_torch.parallel.sharded import make_mesh

    mesh = make_mesh(n_dp, n_ip)
    csr = CSRRatings(*csr_args)
    return {p: _shard_steps(mesh, csr, F, p, dtype)
            for p in SHARD_POLICIES}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_dp,n_ip", [(2, 1), (1, 2), (2, 2)])
def test_sharded_step_kernel_on_gloo_ranks_sharing_the_card(cuda_device,
                                                            n_dp, n_ip,
                                                            dtype):
    """The assembly over ip, the election's MIN over dp, twin's raters and
    the deltas' SUM between ranks (dT and the apply at dp = 2, the rows
    written directly at dp = 1): each rank's kernel steps within 1e-5 of
    its plain steps (bf16: one ulp of the operands' scale)."""
    from cu2rec_torch.parallel.distributed import launch

    ranks = launch(_gpu_grid_job, n_dp * n_ip, "gloo", "cuda",
                   args=(n_dp, n_ip, _csr_args(_ratings(301, 97, seed=5)),
                         100, dtype), timeout=300)
    for errs in ranks:
        assert all(e <= (1e-5 if dtype == "float32" else 1.0)
                   for e in errs.values()), errs


@pytest.mark.gpu
@pytest.mark.parametrize("policy", SHARD_POLICIES)
def test_sharded_engine_on_card_matches_cpu(cuda_device, policy):
    """The engine on the card (K0a's sharded mode, K0b) against the same
    engine on the CPU (the plain step and eval)."""
    from cu2rec_torch.ops.sgd import Hyper
    from cu2rec_torch.parallel.sharded import ShardedEngine, make_mesh
    from cu2rec_torch.utils.config import Config

    csr = _ratings(301, 97, seed=8)
    hp = Hyper(0.05, 0.02, 0.03, 0.04, 0.05)
    out = {}
    for device in ("cpu", cuda_device):
        cfg = Config(n_factors=100, collision_policy=policy, seed=3)
        eng = ShardedEngine(csr, csr, cfg, mesh=make_mesh(1, 1, device))
        st = eng.run(eng.init_model(301, 97, 3.5), hp, 0, 5)
        out[str(device)] = (eng.finalize(st).to("cpu"),
                            eng.evaluate(st, "train"))
    (a, ea), (b, eb) = out.values()
    for x, y in ((a.P, b.P), (a.Q, b.Q), (a.user_bias, b.user_bias),
                 (a.item_bias, b.item_bias)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ea, eb, rtol=1e-6)


def _serving_model(device, U=40, I=3001, F=16, seed=11):
    """Random serving tables (I = 3,001 items: not a multiple of 2 or 4, so
    the last shard holds padding rows) and a CSR of 6-12 ratings a user."""
    from cu2rec_torch.data.csr import csr_from_arrays
    from cu2rec_torch.models.state import model_from_numpy

    rng = np.random.default_rng(seed)
    d = {"p": rng.normal(0, 0.3, (U, F)), "q": rng.normal(0, 0.3, (I, F)),
         "user_bias": rng.normal(0, 0.1, U),
         "item_bias": rng.normal(0, 0.1, I), "global_bias": [3.5]}
    deg = rng.integers(6, 13, U)
    csr = csr_from_arrays(np.repeat(np.arange(U), deg),
                          np.concatenate([rng.choice(I, n, replace=False)
                                          for n in deg]),
                          np.ones(deg.sum(), np.float32), U, I)
    return model_from_numpy(d, device), csr


def _serving_inputs(I, seed=3):
    rng = np.random.default_rng(seed)
    rated = rng.integers(0, I, (20, 9)).astype(np.int32)
    vals = (rng.random((20, 9)) * 3).astype(np.float32)
    return rated, vals, np.ones((20, 9), bool)


@pytest.mark.gpu
@pytest.mark.parametrize("n_ip", [2, 4])
def test_sharded_engine_on_card_matches_cpu_shards(cuda_device, n_ip):
    """The item-sharded engine with its shards on one card against the same
    shards on the CPU: recommends, the explicit fold-in from given rows, and
    the implicit fold-in, whose solve is one K1 launch."""
    from cu2rec_torch.ops import cuda_linalg
    from cu2rec_torch.serve.engine import ShardedServingEngine

    model, csr = _serving_model("cpu")
    gpu = ShardedServingEngine(model.to(cuda_device),
                               devices=[cuda_device] * n_ip)
    cpu = ShardedServingEngine(model, devices=["cpu"] * n_ip)
    assert all(d.type == "cuda" for d in gpu.devices)
    assert len(gpu.shards) == n_ip
    users = list(range(16))
    gv, gi = gpu.recommend_known(users, csr, k=10)
    cv, ci = cpu.recommend_known(users, csr, k=10)
    np.testing.assert_allclose(gv, cv, rtol=1e-4)
    assert np.mean(gi == ci) > 0.95  # ids may swap only at near-ties
    assert (gi < 3001).all()

    rated, vals, mask = _serving_inputs(3001)
    n0 = cuda_linalg.LAUNCHES
    g_rows, _ = gpu.fold_in_implicit(rated, vals, mask)
    assert cuda_linalg.LAUNCHES == n0 + 1
    c_rows, _ = cpu.fold_in_implicit(rated, vals, mask)
    np.testing.assert_allclose(g_rows, c_rows, rtol=RTOL, atol=ATOL)
    init = (np.zeros((20, 16), np.float32) + 0.01,
            np.zeros(20, np.float32))
    gp, gb = gpu.fold_in(rated, vals, mask, init_rows=init)
    cp, cb = cpu.fold_in(rated, vals, mask, init_rows=init)
    np.testing.assert_allclose(gp, cp, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb, cb, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_daemon_stats_name_every_shards_device(cuda_device):
    from cu2rec_torch.serve.daemon import ServingDaemon
    from cu2rec_torch.serve.engine import ShardedServingEngine

    model, csr = _serving_model(cuda_device)
    daemon = ServingDaemon(ShardedServingEngine(
        model, devices=["cuda:0", "cuda:0"]), train_csr=csr,
        window_ms=0.0)
    stats = daemon.submit({"id": 1, "op": "stats"}).result(timeout=60)
    assert stats["n_shards"] == 2
    assert stats["devices"] == ["cuda:0", "cuda:0"]
    assert stats["device"] == "cuda:0"


def _serving_rank_job():
    """A gloo rank sharing the card: the rank-mode engine's implicit fold-in
    and recommends."""
    from cu2rec_torch.ops import cuda_linalg
    from cu2rec_torch.parallel.sharded import make_mesh
    from cu2rec_torch.serve.engine import ShardedServingEngine

    model, csr = _serving_model("cpu")
    eng = ShardedServingEngine(model, mesh=make_mesh(1, 2))
    rated, vals, mask = _serving_inputs(3001)
    n0 = cuda_linalg.LAUNCHES
    rows = eng.fold_in_implicit(rated, vals, mask)[0]
    return (rows, cuda_linalg.LAUNCHES - n0,
            eng.recommend_known(list(range(16)), csr, k=10))


@pytest.mark.gpu
def test_rank_mode_engine_on_gloo_ranks_sharing_the_card(cuda_device):
    """Two ranks, a shard each, the candidates and rows exchanged as CUDA
    tensors through gloo: the same on both ranks, K1 launched on each, and
    the one-process shards' results on the card."""
    from cu2rec_torch.parallel.distributed import launch
    from cu2rec_torch.serve.engine import ShardedServingEngine

    ranks = launch(_serving_rank_job, 2, "gloo", "cuda", timeout=300)
    (r0, n0, (v0, i0)), (r1, n1, (v1, i1)) = ranks
    np.testing.assert_array_equal(r0, r1)
    np.testing.assert_array_equal(i0, i1)
    assert n0 == n1 == 1
    model, csr = _serving_model(cuda_device)
    one = ShardedServingEngine(model, devices=[cuda_device] * 2)
    rated, vals, mask = _serving_inputs(3001)
    np.testing.assert_allclose(r0, one.fold_in_implicit(rated, vals,
                                                        mask)[0],
                               rtol=RTOL, atol=ATOL)
    ov, oi = one.recommend_known(list(range(16)), csr, k=10)
    np.testing.assert_allclose(v0, ov, rtol=1e-5)
    assert np.mean(i0 == oi) > 0.95


# -- K0c, the explicit serving fold-in ----------------------------------------

def _foldin_inputs(device, F, dtype, Bp, Dp, n_rows, seed, source):
    """(T_u, table, index, vals, mask) on ``device``: a catalog of
    ``n_rows`` packed rows in ``dtype``, sampled directly by item id
    ("direct") or through the (Bp·Dp, W) float32 rows assembled from it
    ("assembled"); the mask in a request's order, holes everywhere, every
    third slot empty and slot 1 full, the ids where it is off past the
    catalog (direct) so that a read of one would show."""
    from cu2rec_torch.ops.packed import packed_width

    W = packed_width(F)
    rng = np.random.default_rng(seed)
    T_i = np.zeros((n_rows, W), np.float32)
    T_i[:, :F + 1] = rng.normal(0, 0.1, (n_rows, F + 1))
    T_u = np.zeros((Bp, W), np.float32)
    T_u[:, :F + 1] = rng.normal(0, 0.1, (Bp, F + 1))
    items = rng.integers(0, n_rows, (Bp, Dp)).astype(np.int32)
    vals = (rng.integers(1, 11, (Bp, Dp)) / 2).astype(np.float32)
    mask = rng.random((Bp, Dp)) < 0.6
    mask[::3] = False
    mask[1] = True
    table = torch.from_numpy(T_i).to(device, dtype)
    index = torch.from_numpy(items).to(device)
    if source == "assembled":
        table = table[index.reshape(-1).long()].to(torch.float32)
        index = torch.arange(Bp * Dp, dtype=torch.int32,
                             device=device).reshape(Bp, Dp)
    else:
        index[~torch.from_numpy(mask).to(device)] = n_rows + 7
    return (torch.from_numpy(T_u).to(device), table.contiguous(), index,
            torch.from_numpy(vals).to(device),
            torch.from_numpy(mask).to(device))


def _foldin_check(args, F, n_steps):
    """K0c on ``args`` against ``fold_in_steps``: one launch, rows within
    1e-5 of max(1, |entry|) (the kernel contracts multiply-adds and sums
    the dot in another order), slots with no ratings (and every slot at
    ``n_steps`` 0) bit for bit."""
    from cu2rec_torch.ops import cuda_foldin
    from cu2rec_torch.ops.sgd import Hyper, prng_key
    from cu2rec_torch.serve.engine import fold_in_steps

    hp = Hyper(0.05, 0.02, 0.02, 0.03, 0.02)
    n0 = cuda_foldin.LAUNCHES
    got = cuda_foldin.fold_in_cuda(*args, 3.5, hp, prng_key(42), n_steps, F)
    torch.cuda.synchronize()
    assert cuda_foldin.LAUNCHES == n0 + 1
    want = fold_in_steps(*args, 3.5, hp, prng_key(42), n_steps, F)
    err = (got - want).abs() / want.abs().clamp(min=1.0)
    assert float(err.max()) <= 1e-5
    empty = ~args[4].any(dim=1)
    assert torch.equal(got[empty], args[0][empty])
    if n_steps == 0:
        assert torch.equal(got, args[0])
    else:
        assert not torch.equal(got[~empty], args[0][~empty])


@pytest.mark.gpu
@pytest.mark.parametrize("F", WIDTH_FS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("source", ["direct", "assembled"])
@pytest.mark.parametrize("Dp,n_steps", [(1, 7), (8, 0), (32, 1), (32, 100),
                                        (33, 7), (100, 100)])
def test_foldin_kernel_matches_plain(cuda_device, F, dtype, source, Dp,
                                     n_steps):
    """K0c against ``fold_in_steps`` on the same holey masks, at every
    width and dtype: each of the lanes a row it takes (8: bf16 W = 64; 16:
    float32 W = 64, bf16 W = 128; 32: float32 W = 128)."""
    _foldin_check(_foldin_inputs(cuda_device, F, dtype, 37, Dp, 5000,
                                 F + Dp, source), F, n_steps)


@pytest.mark.gpu
def test_foldin_takes_the_widest_group_of_lanes_that_fits(cuda_device):
    """K0c's build holds one kernel a (W, dtype), with the widest of 8, 16
    and 32 lanes a row that divides the row's 16-byte words and leaves a
    lane at most six float4s (names as ``chip_smoke.py`` reports them)."""
    import importlib.util
    from pathlib import Path

    from cu2rec_torch.csrc import build

    build.load("foldin")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    names = {r[0] for r in smoke._ptxas_report(build.build_log("foldin"))
             if r[0].startswith("foldin_kernel")}
    assert names == {
        "foldin_kernel<64,float32,16>", "foldin_kernel<128,float32,32>",
        "foldin_kernel<256,float32,32>", "foldin_kernel<384,float32,32>",
        "foldin_kernel<512,float32,32>", "foldin_kernel<64,bfloat16,8>",
        "foldin_kernel<128,bfloat16,16>", "foldin_kernel<256,bfloat16,32>",
        "foldin_kernel<384,bfloat16,16>", "foldin_kernel<512,bfloat16,32>"}


@pytest.mark.gpu
def test_foldin_kernel_rejects_what_it_cannot_take(cuda_device):
    from cu2rec_torch.ops.cuda_foldin import fold_in_cuda
    from cu2rec_torch.ops.sgd import Hyper, prng_key

    hp = Hyper(0.05, 0.02, 0.02, 0.02, 0.02)
    T_u, table, index, vals, mask = _foldin_inputs(
        cuda_device, 16, torch.float32, 8, 4, 50, 0, "direct")
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fold_in_cuda(T_u.cpu(), table, index, vals, mask, 3.5, hp,
                     prng_key(0), 3, 16)
    with pytest.raises(ValueError, match="on cpu"):
        fold_in_cuda(T_u, table.cpu(), index, vals, mask, 3.5, hp,
                     prng_key(0), 3, 16)
    with pytest.raises(TypeError, match="int32"):
        fold_in_cuda(T_u, table, index.long(), vals, mask, 3.5, hp,
                     prng_key(0), 3, 16)
    with pytest.raises(TypeError, match="bool"):
        fold_in_cuda(T_u, table, index, vals, mask.to(torch.uint8), 3.5, hp,
                     prng_key(0), 3, 16)


@pytest.mark.gpu
@pytest.mark.parametrize("n_ip", [1, 2])
def test_engine_fold_in_on_card_is_one_foldin_launch(cuda_device, n_ip):
    """One ``fold_in`` on a CUDA engine is one K0c launch (over two shards
    after one assembly of the rows), and matches the CPU engine."""
    from cu2rec_torch.ops import cuda_foldin
    from cu2rec_torch.serve.engine import ShardedServingEngine

    model, _ = _serving_model(cuda_device)
    cpu_model, _ = _serving_model("cpu")
    gpu = ShardedServingEngine(model, devices=[cuda_device] * n_ip)
    cpu = ShardedServingEngine(cpu_model, devices=["cpu"] * n_ip)
    rated, vals, mask = _serving_inputs(3001)
    init = (np.zeros((20, 16), np.float32) + 0.01,
            np.zeros(20, np.float32))
    n0 = cuda_foldin.LAUNCHES
    gp, gb = gpu.fold_in(rated, vals, mask, init_rows=init)
    assert cuda_foldin.LAUNCHES == n0 + 1
    cp, cb = cpu.fold_in(rated, vals, mask, init_rows=init)
    np.testing.assert_allclose(gp, cp, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb, cb, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("n_ip", [1, 2])
def test_engine_fold_in_on_card_takes_the_request_as_it_arrives(cuda_device,
                                                                n_ip):
    """The card engine's fold-in of a request with holes in its mask (an
    empty row, a full one, garbage ids where masked), its default initial
    rows drawn into pinned memory: one K0c launch, the CPU engine's rows,
    and a batch of one gives row 0 of the batch."""
    from cu2rec_torch.ops import cuda_foldin
    from cu2rec_torch.serve.engine import ShardedServingEngine
    from cu2rec_torch.utils.config import Config

    model, _ = _serving_model(cuda_device)
    cpu_model, _ = _serving_model("cpu")
    gpu = ShardedServingEngine(model, devices=[cuda_device] * n_ip)
    cpu = ShardedServingEngine(cpu_model, devices=["cpu"] * n_ip)
    rng = np.random.default_rng(4)
    rated = rng.integers(0, 3001, (20, 40)).astype(np.int32)
    vals = (rng.random((20, 40)) * 3).astype(np.float32)
    mask = rng.random((20, 40)) < 0.5
    mask[3], mask[4] = False, True
    rated[~mask] = -1
    cfg = Config(total_iterations=50, n_factors=16, seed=5, is_train=False)
    n0 = cuda_foldin.LAUNCHES
    gp, gb = gpu.fold_in(rated, vals, mask, cfg)
    assert cuda_foldin.LAUNCHES == n0 + 1
    cp, cb = cpu.fold_in(rated, vals, mask, cfg)
    np.testing.assert_allclose(gp, cp, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb, cb, rtol=0, atol=1e-4)
    init = gpu.fold_in(rated, vals, mask, cfg.replace(total_iterations=0))
    np.testing.assert_array_equal(gp[3], init[0][3])
    one = gpu.fold_in(rated[:1], vals[:1], mask[:1], cfg)
    np.testing.assert_array_equal(one[0][0], gp[0])


# -- K4, the ALS/iALS gather-Gram (ops/cuda_gram.py) --------------------------
# Each sum of K4 is held against the plain version elementwise within
# 1e-5 of the same sum of absolute values (gram_scale, plus the epilogue's
# terms) + 1e-6: float32 sums of up to 8,192 terms in another order.
GRAM_RTOL, GRAM_ATOL = 1e-5, 1e-6


def _gram_chunk(B, D, F, mode, seed, device, R=600):
    """A chunk of B systems of D slots over a table of R rows at width F:
    ``mode`` "als" (the design rows [q | 1 | b | 0…] of width
    4⌈(F+2)/4⌉, last row zero), "ials" (plain F-wide rows), "rows"
    (iALS over B·D rows read in order, as the serving engines' assembled
    rows).  Random holes in the masks, the last system (of several) all
    masked, NaN and garbage under some masked slots.  Returns (args, kwargs) of
    ``gather_gram`` with its epilogue."""
    rng = np.random.default_rng(seed)
    n = F + 1 if mode == "als" else F
    idx = rng.integers(0, R, (B, D))
    vals = (rng.integers(1, 11, (B, D)) / 2).astype(np.float32)
    mask = rng.random((B, D)) < rng.random((B, 1)) * 1.2
    if B > 1:
        mask[-1] = False
    vals[~mask] = rng.choice([0.0, 7e30, -3.0], size=(~mask).sum())
    if B > 2:
        vals[2, ~mask[2]] = np.nan
    kw = {}
    if mode == "als":
        rows = np.zeros((R + 1, -(-(F + 2) // 4) * 4), np.float32)
        rows[:R, :F] = rng.normal(0, 0.3, (R, F))
        rows[:R, F] = 1.0
        rows[:R, F + 1] = rng.normal(0, 0.1, R)
        kw = dict(mu=torch.tensor(3.2, device=device),
                  reg_vec=torch.full((n,), 0.05, device=device),
                  deg=torch.from_numpy(mask.sum(1).astype(np.float32)).to(
                      device))
    else:
        rows = rng.normal(0, 0.3, (B * D if mode == "rows" else R, F)).astype(
            np.float32)
        Y = rng.normal(0, 0.3, (50, F)).astype(np.float32)
        kw = dict(alpha=2.0, G_global=torch.from_numpy(Y.T @ Y).to(device),
                  reg=0.5)
    ids = None if mode == "rows" else torch.from_numpy(idx).to(device)
    args = (torch.from_numpy(rows).to(device), ids,
            torch.from_numpy(vals).to(device),
            torch.from_numpy(mask).to(device), n)
    return args, kw


def _gram_within(got, want, scale):
    """Elementwise |got − want| ≤ GRAM_RTOL·scale + GRAM_ATOL, NaN where
    the plain version has NaN."""
    got, want, scale = (t.cpu() for t in (got, want, scale))
    assert torch.equal(got.isnan(), want.isnan())
    ok = want.isfinite()
    err = (got[ok] - want[ok]).abs()
    lim = GRAM_RTOL * scale[ok] + GRAM_ATOL
    assert bool((err <= lim).all()), float((err - lim).max())


def _gram_plain(args, kw):
    """The plain version on CPU copies, its epilogue included, and each
    sum's scale (the epilogue's terms added in absolute value)."""
    from cu2rec_torch.experiments import gram_times
    from cu2rec_torch.ops import cuda_gram

    cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
    ckw = {k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()}
    G, rhs = cuda_gram.gather_gram(*cpu, **ckw)
    mode = {k: ckw[k] for k in ("mu", "alpha") if k in ckw}
    SG, Sr = gram_times.gram_scale(*cpu, **mode)
    if "reg_vec" in ckw:
        SG = cuda_gram.add_ridge(SG, ckw["reg_vec"], ckw["deg"])
    if "G_global" in ckw:
        SG = cuda_gram.add_global(SG, ckw["G_global"].abs(), ckw["reg"])
    return G, rhs, SG, Sr


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["als", "ials", "rows"])
@pytest.mark.parametrize("F", [8, 64, 100, 300])
@pytest.mark.parametrize("B,D", [(1, 8), (7, 8), (2001, 8), (7, 24),
                                 (2001, 24), (1, 8192), (5, 8192), (9, 3)])
def test_gather_gram_matches_plain(cuda_device, mode, F, B, D):
    """K4 against its plain version, its epilogue included (the ALS ridge
    of each row's degree, YᵀY + λ for iALS), at the bucket widths of the
    sweeps (8, 24, the heavy 8,192) and a serving width of 3, B of one,
    a few and more systems than the card holds blocks: within the Gram
    tolerance, the NaN under a masked slot where the plain version has it,
    G exactly symmetric, one launch a call and the same bits twice."""
    from cu2rec_torch.ops import cuda_gram

    args, kw = _gram_chunk(B, D, F, mode, seed=B + D + F, device=cuda_device)
    n0 = cuda_gram.LAUNCHES
    G, rhs = cuda_gram.gather_gram(*args, **kw)
    G2, rhs2 = cuda_gram.gather_gram(*args, **kw)
    torch.cuda.synchronize()
    assert cuda_gram.LAUNCHES == n0 + 2
    assert torch.equal(G.isnan(), G2.isnan())
    assert torch.equal(G.nan_to_num(), G2.nan_to_num())
    assert torch.equal(rhs.nan_to_num(), rhs2.nan_to_num())
    assert torch.equal(G.nan_to_num(), G.mT.nan_to_num())
    want_G, want_rhs, SG, Sr = _gram_plain(args, kw)
    _gram_within(G, want_G, SG)
    _gram_within(rhs, want_rhs, Sr)


@pytest.mark.gpu
@pytest.mark.parametrize("F", [100, 300])
@pytest.mark.parametrize("family", ["als", "ials"])
def test_gather_gram_heavy_chunk_matches_plain(cuda_device, family, F):
    """A heavy chunk (rows of degree above 8,192, segments of 8,192 slots)
    at F = 100 and 300 (the tiles over several blocks, and the
    workspace): K4's raw segment sums within the Gram tolerance of the
    plain version's, and the heavy rows' systems, summed over their
    segments, within the tolerance of the segments' summed scale."""
    from cu2rec_torch.data.csr import csr_from_arrays, transpose_csr
    from cu2rec_torch.ops import als, cuda_gram
    from cu2rec_torch.ops.ials import gramian, ials_heavy_system

    rng = np.random.default_rng(6)
    U, I = 30_000, 40
    u = np.concatenate([rng.permutation(U)[:n] for n in (9000, 17000,
                                                        20000)])
    i = np.repeat(np.arange(3), (9000, 17000, 20000))
    r = (rng.integers(1, 11, len(u)) / 2.0).astype(np.float32)
    ip, ind, dat = transpose_csr(csr_from_arrays(u, i, r, U, I))
    chunks = als.prepare_chunks(torch.from_numpy(ind).to(cuda_device),
                                torch.from_numpy(dat).to(cuda_device), ip, F,
                                len(ind))
    _, cols, vals, mask, _rows, s0, s1, deg = next(
        c for c in chunks if c[0] == "heavy")
    T = torch.from_numpy(rng.normal(0, 0.1, (U, F + 1)).astype(
        np.float32)).to(cuda_device)
    if family == "als":
        Tx = als.design_table(T, F)
        args = (Tx.rows, cols, vals, mask, F + 1)
        kw = dict(mu=torch.tensor(3.0, device=cuda_device))
    else:
        args = (T[:, :F], cols, vals, mask, F)
        kw = dict(alpha=2.0)
    Gseg, rseg = cuda_gram.gather_gram(*args, **kw)
    want_G, want_rhs, SG, Sr = _gram_plain(args, kw)
    _gram_within(Gseg, want_G, SG)
    _gram_within(rseg, want_rhs, Sr)
    reg = als.reg_vector(0.05, 0.05, F, cuda_device)
    if family == "als":
        G, rhs = als.heavy_system(Tx, cols, vals, mask, 3.0, reg, s0, s1,
                                  deg)
    else:
        G, rhs = ials_heavy_system(T[:, :F], gramian(T[:, :F]), cols, vals,
                                   mask, s0, s1, 2.0, 0.5)
    Sg, Srs = als.segment_sums(SG.to(cuda_device), Sr.to(cuda_device),
                               s0, s1)
    wG, wr = als.segment_sums(want_G.to(cuda_device), want_rhs.to(
        cuda_device), s0, s1)
    if family == "als":
        wG = cuda_gram.add_ridge(wG, reg, deg)
    else:
        wG = cuda_gram.add_global(wG, gramian(T[:, :F]), 0.5)
        Sg = Sg + gramian(T[:, :F]).abs()
    _gram_within(G, wG, Sg)
    _gram_within(rhs, wr, Srs)


@pytest.mark.gpu
def test_train_als_sweep_at_f300_matches_the_blocked_reference(cuda_device):
    """One ``train_als`` sweep at F = 300 (n = 301: K4's tiles over several
    blocks and its workspace, its heavy segments, K1's shared-memory
    kernel) on a planted subset of the ALS-WR configuration (20,000 users,
    1,777 items, 2 M ratings, one item past 8,192 ratings) against the
    blocked float64 reference from the same start: the same start, and
    the norm of each leaf's change within 1e-5 of the reference's (float32
    Grams of up to ~10⁴ terms and a float32 Cholesky; the TF32 control
    reads ~3e-5 at the benchmark's tiny size)."""
    import json
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from benchmark.gen.planted import planted_split
    from benchmark.lib import compare
    from benchmark.reference import mf_als_blocked, mf_sgd
    from cu2rec_torch.data.csr import CSRRatings
    from cu2rec_torch.ops import cuda_gram, cuda_linalg
    from cu2rec_torch.train.als import train_als
    from cu2rec_torch.utils.config import Config
    from cu2rec_torch.utils.metrics import MetricsLogger

    with open(root / "benchmark" / "configs" / "netflix-alswr-f300.json") as f:
        conf = json.load(f)
    conf["sizes"] = {"n_users": 20_000, "n_items": 1_777,
                     "n_ratings": 2_000_000, "test_share": 0.1}
    train, test = planted_split(conf, 7, cuda_device)
    assert np.bincount(train.indices).max() > 8192
    U, I, F = train.n_users, train.n_items, 300
    regs = {k: conf["train"][k] for k in ("P_reg", "Q_reg", "user_bias_reg",
                                          "item_bias_reg")}
    mu = float(train.data.astype(np.float64).mean())
    cfg = Config(seed=7, n_factors=F, total_iterations=1, algo="als",
                 dtype="float32", **regs)

    def csr(x):
        return CSRRatings(indptr=x.indptr, indices=x.indices, data=x.data,
                          n_users=x.n_users, n_items=x.n_items)

    n4, n1 = cuda_gram.LAUNCHES, cuda_linalg.LAUNCHES
    model, _ = train_als(csr(train), csr(test), cfg, mu,
                         logger=MetricsLogger(verbose=False),
                         device=cuda_device)
    torch.cuda.synchronize()
    assert cuda_gram.LAUNCHES > n4 and cuda_linalg.LAUNCHES > n1
    assert cuda_linalg.kernel_for(F + 1) == "shared"

    dev = cuda_device
    start = [t.to(dev, torch.float64)
             for t in mf_sgd.init_tables(U, I, F, 7)]
    u_csr = mf_sgd.to_csr(train, dev)
    i_csr = mf_als_blocked.transpose(*u_csr, I)
    ref = mf_als_blocked.sweep(start, float(np.float32(mu)), u_csr, i_csr,
                               {k: float(np.float32(v))
                                for k, v in regs.items()})
    got = (model.P, model.Q, model.user_bias, model.item_bias)
    d_prog = {k: g.to(dev, torch.float64) - s0
              for k, g, s0 in zip("PQub", got, start)}
    d_ref = {k: r - s0 for k, r, s0 in zip("PQub", ref, start)}
    assert compare.norm_gap(d_prog, d_ref) <= 1e-5
    assert compare.max_gap(d_prog, d_ref) <= 1e-3


@pytest.mark.gpu
def test_gather_gram_runs_in_the_trainers_and_the_fold_in(cuda_device,
                                                           monkeypatch):
    """train_als, train_ials and ials_fold_in launch K4 on the card, and no
    CUDA tensor reaches the plain version."""
    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.ops import cuda_gram
    from cu2rec_torch.ops.ials import ials_fold_in
    from cu2rec_torch.train.als import train_als
    from cu2rec_torch.train.ials import train_ials
    from cu2rec_torch.utils.config import Config

    plain = cuda_gram.gram_rhs_reference

    def cpu_only(rows, *a, **k):
        assert rows.device.type == "cpu", "a CUDA tensor reached the plain " \
            "version"
        return plain(rows, *a, **k)

    monkeypatch.setattr(cuda_gram, "gram_rhs_reference", cpu_only)
    csr = _family_ratings(300, 120, seed=8)
    rng = np.random.default_rng(4)
    d = {"p": rng.normal(0, 0.1, (300, 16)), "q": rng.normal(0, 0.1, (120, 16)),
         "user_bias": np.zeros(300), "item_bias": np.zeros(120),
         "global_bias": [3.0]}
    for train, kw in ((train_als, {"global_bias": 3.0}),
                      (train_ials, {"alpha": 2.0})):
        cfg = Config(total_iterations=2, n_factors=16, P_reg=0.5, Q_reg=0.5)
        n0 = cuda_gram.LAUNCHES
        train(csr, csr, cfg, model=model_from_numpy(d, cuda_device),
              device=cuda_device, **kw)
        assert cuda_gram.LAUNCHES > n0, train.__name__
    n0 = cuda_gram.LAUNCHES
    Y = torch.from_numpy(rng.normal(0, 0.1, (120, 16)).astype(
        np.float32)).to(cuda_device)
    cols = rng.integers(0, 120, (4, 6))
    x = ials_fold_in(Y, cols, np.ones((4, 6), np.float32),
                     np.ones((4, 6), bool), 2.0, 0.5)
    assert cuda_gram.LAUNCHES == n0 + 1 and x.device.type == "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("bad", [-1, 120])
def test_ials_fold_in_holds_its_ids_on_the_card(cuda_device, bad):
    """A masked-in id out of [0, I) raises ValueError before K4 launches
    (K4 reads the rows at the ids unchecked), as on the CPU; masked-out
    slots may hold any id."""
    from cu2rec_torch.ops import cuda_gram
    from cu2rec_torch.ops.ials import ials_fold_in

    rng = np.random.default_rng(6)
    Y = torch.from_numpy(rng.normal(0, 0.1, (120, 16)).astype(
        np.float32)).to(cuda_device)
    cols = rng.integers(0, 120, (4, 6))
    vals = np.ones((4, 6), np.float32)
    mask = np.ones((4, 6), bool)
    mask[2, 4:] = False
    x0 = ials_fold_in(Y, cols, vals, mask, 2.0, 0.5)
    cols[2, 4:] = bad
    assert torch.equal(ials_fold_in(Y, cols, vals, mask, 2.0, 0.5), x0)
    cols[0, 0] = bad
    n0 = cuda_gram.LAUNCHES
    with pytest.raises(ValueError, match=r"ids must lie in \[0, 120\)"):
        ials_fold_in(Y, cols, vals, mask, 2.0, 0.5)
    assert cuda_gram.LAUNCHES == n0
    torch.cuda.synchronize(cuda_device)


# K5: the starting tables drawn on the card.  The benchmark's shapes
# (ML-20M at F = 50, Netflix at F = 300), an ALS-sized bf16 model with the
# items' tables given, each at a seed below and above 32 bits.
_DRAW_SHAPES = [(138_493, 26_744, 50, torch.float32, False),
                (480_189, 17_770, 300, torch.float32, False),
                (6_040, 3_706, 64, torch.bfloat16, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 42, 7 * 2 ** 40 + 99])
@pytest.mark.parametrize("U,I,F,dtype,given", _DRAW_SHAPES)
def test_normal_draw_is_the_cpu_draw(cuda_device, U, I, F, dtype, given,
                                     seed):
    """``init_model`` on the card (K5) gives the CPU's tables bit for bit,
    every table of the model, and counts a card draw."""
    from cu2rec_torch.models.state import init_model
    from cu2rec_torch.ops import cuda_draw
    from cu2rec_torch.utils import timing

    kw = {}
    if given:
        rng = np.random.default_rng(seed)
        kw = dict(Q=rng.normal(size=(I, F)).astype(np.float32),
                  item_bias=rng.normal(size=I).astype(np.float32))
    want = init_model(U, I, F, 3.5, seed=seed, dtype=dtype, device="cpu",
                      **kw)
    assert cuda_draw.device_tables(cuda_device) is not None  # checked once
    n0 = cuda_draw.LAUNCHES[dtype]
    timing.trace_start()
    try:
        got = init_model(U, I, F, 3.5, seed=seed, dtype=dtype,
                         device=cuda_device, **kw)
        torch.cuda.synchronize()
    finally:
        counters = timing.trace_stop()["counters"]
    assert cuda_draw.LAUNCHES[dtype] == n0 + 1
    assert counters.get("model.init.card_draws") == 1
    assert "model.init.cpu_draws" not in counters
    for name in ("P", "Q", "user_bias", "item_bias", "global_bias"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g.cpu(), w), name


@pytest.mark.gpu
def test_normal_draw_time(cuda_device):
    """One Netflix-sized draw (150 M words, F = 300) on the card takes a
    small share of the CPU draw it replaces: under a tenth of it, and
    under 0.1 s."""
    from cu2rec_torch.models.state import init_model

    U, I, F = 480_189, 17_770, 300
    t0 = time.perf_counter()
    init_model(U, I, F, 3.5, seed=5, device="cpu")
    cpu_s = time.perf_counter() - t0
    init_model(U, I, F, 3.5, seed=6, device=cuda_device)  # tables, warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    init_model(U, I, F, 3.5, seed=7, device=cuda_device)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    assert card_s < min(cpu_s / 10, 0.1), (card_s, cpu_s)


@pytest.mark.gpu
def test_forged_tables_raise_on_the_card(cuda_device, monkeypatch):
    """Transforms one ulp off fail K5's self-check on the card: a card
    model's draw raises, naming the first entry that differs, after the
    check's one launch, and nothing is drawn on the CPU in its place."""
    from cu2rec_torch.models.state import init_model
    from cu2rec_torch.ops import cuda_draw
    from cu2rec_torch.utils import timing

    r, cs = cuda_draw.transform_tables()
    monkeypatch.setattr(cuda_draw, "_host_tables",
                        (torch.nextafter(r, torch.tensor(np.inf)), cs))
    monkeypatch.setattr(cuda_draw, "_device_tables", {})
    n0 = cuda_draw.LAUNCHES[torch.float32]
    timing.trace_start()
    try:
        with pytest.raises(RuntimeError, match=r"self-check failed .* "
                           r"first at entry \d+: "):
            init_model(1_000, 300, 16, 3.5, seed=3, device=cuda_device)
    finally:
        counters = timing.trace_stop()["counters"]
    assert counters == {}
    assert cuda_draw.LAUNCHES[torch.float32] == n0 + 1


@pytest.mark.gpu
def test_evals_with_a_plan_copy_nothing_to_the_card(cuda_device):
    """With plans built once, the sampled AUC and the ranking eval on the
    card enqueue no host-to-device copy and read back once each (torch
    profiler), and read bit for bit what they read without a plan and
    what a batch loop over ``recommend_users`` reads, one float a batch."""
    from torch.profiler import ProfilerActivity, profile

    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.ops.bpr import auc_eval, prepare_auc
    from cu2rec_torch.ops.topk import ndcg_at_k, recall_at_k
    from cu2rec_torch.serve.recommend import (
        padded_user_lists, prepare_ranking, ranking_eval, recommend_users,
    )

    U, I, F = 5000, 2000, 50
    train, test = _family_ratings(U, I, seed=11), _family_ratings(U, I, 12)
    rng = np.random.default_rng(6)
    model = model_from_numpy(
        {"p": rng.normal(0, 0.3, (U, F)), "q": rng.normal(0, 0.3, (I, F)),
         "user_bias": np.zeros(U), "item_bias": rng.normal(0, 0.1, I),
         "global_bias": [0.0]}, cuda_device)
    aplan = prepare_auc(train, test, seed=9, device=cuda_device)
    rplan = prepare_ranking(train, test, max_users=2048, device=cuda_device)
    assert len(rplan.batches) == 2

    def evals():
        return (auc_eval(model, train, test, seed=9, plan=aplan),
                ranking_eval(model, train, test, max_users=2048, plan=rplan))

    want = evals()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = evals()
        names = [e.name for e in prof.events()]
        if any("topk" in n.lower() for n in names):
            break
    else:
        pytest.fail("3 profiler sessions recorded no device time")
    assert not [n for n in names if "HtoD" in n]
    assert sum("DtoH" in n for n in names) == 2
    assert got == want
    assert want == (auc_eval(model, train, test, seed=9),
                    ranking_eval(model, train, test, max_users=2048))
    users = np.nonzero(np.diff(test.indptr) > 0)[0][:2048]
    totals = [0.0, 0.0]
    for b0 in range(0, len(users), 1024):
        batch = users[b0:b0 + 1024]
        _, rec = recommend_users(model, batch,
                                 *padded_user_lists(train, batch), k=10)
        rel, relmask = (torch.from_numpy(x).to(cuda_device)
                        for x in padded_user_lists(test, batch))
        for j, fn in enumerate((recall_at_k, ndcg_at_k)):
            totals[j] += float(torch.sum(fn(rec, rel.long(), relmask)))
    assert want[1] == {"recall": totals[0] / len(users),
                       "ndcg": totals[1] / len(users)}
