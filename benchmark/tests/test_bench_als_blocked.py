"""The ALS-WR cell ``netflix-f300.als`` on the CPU: its blocked float64
reference (``reference/mf_als_blocked.py``) gives ``mf_als``'s sweeps, and
the cell, cut to the tiny sizes with F = 300 kept, agrees with it while
the control and each planted fault come out as not correct by the cell's
own limits."""

import pytest
import torch

from bench_util import context

from benchmark.lib import harness
from benchmark.reference import mf_als, mf_als_blocked

CELL = "netflix-f300.als"
# The CPU's sound run at n = 301: the port's plain Gram (float32 sums of
# up to ~20 terms a row here) and plain Cholesky against float64, a few
# float32 roundings amplified by the solve; the TF32 control reads 5-15×
# above each (3.0e-5, 1.6e-5, 6.2e-4, 7.9e-6 at the test's seed).
CPU_BOUND = {"start_gap": 0.0, "update1_gap": 4e-6, "change3_gap": 1e-6,
             "change3_max_gap": 6e-5, "eval_gap": 1e-6}


def _ratings(U, I, n, seed, device="cpu"):
    """A (user CSR, item CSR) pair of power-law items, users 0 and 5 with
    no rating."""
    g = torch.Generator().manual_seed(seed)
    u = torch.randint(0, U, (n,), generator=g)
    i = (I * torch.rand(n, generator=g) ** 2.5).long().clamp(max=I - 1)
    keep = (u != 0) & (u != 5)
    key = torch.unique(u[keep] * I + i[keep])
    u, i = key // I, key % I
    r = torch.randint(1, 11, (len(u),), generator=g).double() / 2
    ptr = torch.zeros(U + 1, dtype=torch.int64)
    ptr[1:] = torch.cumsum(torch.bincount(u, minlength=U), 0)
    user_csr = (ptr.to(device), i.to(torch.int32).to(device), r.float().to(
        device))
    return user_csr, mf_als.transpose(*user_csr, I)


@pytest.mark.parametrize("tf32", [False, True])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("block", [mf_als_blocked.BLOCK, 3000])
def test_blocked_sweep_is_mf_als_sweep(monkeypatch, tf32, skip, block):
    """A sweep of random float64 tables equals ``mf_als``'s to 1e-12
    relative, in one block a side or in many (a block of 3,000 elements
    holds a row or two at F = 9), with the TF32 inputs and a half of the
    users skipped; rows with no rating keep theirs."""
    monkeypatch.setattr(mf_als_blocked, "BLOCK", block)
    U, I, F = 70, 30, 9
    user_csr, item_csr = _ratings(U, I, 900, seed=4)
    g = torch.Generator().manual_seed(1)
    tables = (0.3 * torch.randn((U, F), generator=g, dtype=torch.float64),
              0.3 * torch.randn((I, F), generator=g, dtype=torch.float64),
              0.1 * torch.randn(U, generator=g, dtype=torch.float64),
              0.1 * torch.randn(I, generator=g, dtype=torch.float64))
    regs = {"P_reg": 0.065, "Q_reg": 0.05, "user_bias_reg": 0.02,
            "item_bias_reg": 0.03}
    skip_users = torch.arange(U) % 2 == 1 if skip else None
    want = mf_als.sweep(tables, 3.5, user_csr, item_csr, regs, tf32,
                        skip_users)
    got = mf_als_blocked.sweep(tables, 3.5, user_csr, item_csr, regs, tf32,
                               skip_users)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
    assert torch.equal(got[0][[0, 5]], tables[0][[0, 5]])
    if skip:
        assert torch.equal(got[0][1::2], tables[0][1::2])


def test_blocks_cover_the_rows_within_the_budget():
    deg = torch.tensor([1, 1, 2, 3, 40, 41, 900, 5000]).numpy()
    out = mf_als_blocked.blocks(deg, 10, 2000)
    assert out[0][0] == 0 and out[-1][1] == len(deg)
    assert all(a[1] == b[0] for a, b in zip(out, out[1:]))
    for lo, hi in out:
        assert hi - lo == 1 or (hi - lo) * max(deg[hi - 1], 10) * 10 <= 2000


def _tiny():
    return context(CELL, n_factors=300, seconds=0.0)


def test_sound_run_agrees_with_the_blocked_reference():
    """Also at a window of no seconds: it holds on to sweep 3, the last
    compared."""
    ctx = _tiny()
    record = harness.load_module("drivers", ctx.workload["driver"]).run(ctx)
    assert ctx.counters["sweeps"] == 2
    values = {c["name"]: c["value"] for c in record["checks"]}
    assert set(values) == set(CPU_BOUND)
    for k, v in values.items():
        assert v <= CPU_BOUND[k], (k, v)


@pytest.mark.parametrize("mode", ["control", "unchanged", "half_users",
                                  "altered", "eval_half"])
def test_control_and_faults_are_not_correct(mode):
    """The TF32 reference, and the reference with each fault planted, in
    the program's place, fail at least one of the cell's limits."""
    ctx = _tiny()
    values = harness.load_module("drivers", ctx.workload["driver"]).readings(
        ctx, mode)
    limits = ctx.workload["limits"]
    assert any(values[k] > limits[k] for k in values), values
