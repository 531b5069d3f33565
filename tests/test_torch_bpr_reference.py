"""The port's BPR (``ops/bpr.py``) against the benchmark's plain float64
reference (``benchmark/reference/mf_bpr.py``), on the CPU, on small
planted interactions with unrated users and items.

The draws are integer streams: bit-equal.  The tables after steps 1 and 3
agree within ``TOL`` of each leaf's largest entry: every entry of a step is
a float32 rounding of a few operations on entries of that scale (a dot of
F products, a sigmoid, a scaled add), so three steps leave a few float32
ulps (2^-23) of the scale; the item bias sums the positive and the
negative update, two terms of about lr/2 that nearly cancel, and reads up
to about two ulps of the larger.  2^-19 is 16 ulps.  The AUC is a float32
mean of an exact count over the same pairs: within one rounding.  bf16
tables (8 bits of mantissa) and a step without its item-negative pass land
far outside ``TOL``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import mf_als, mf_bpr, mf_sgd  # noqa: E402

from cu2rec_torch.data.csr import csr_from_arrays, to_device  # noqa: E402
from cu2rec_torch.models.state import (  # noqa: E402
    MFModel, init_model, with_dtype,
)
from cu2rec_torch.ops import bpr  # noqa: E402
from cu2rec_torch.ops.packed import pack, unpack  # noqa: E402
from cu2rec_torch.ops.sgd import Hyper, prng_key  # noqa: E402

TOL = 2.0 ** -19
SEEDS = [3, 2 ** 31 - 1, 2 ** 33 + 17]
HP = {"learning_rate": 0.1, "P_reg": 0.01, "Q_reg": 0.02,
      "user_bias_reg": 0.01, "item_bias_reg": 0.03}
LEAVES = ("P", "Q", "user_bias", "item_bias")


def _split(seed, U=300, I=200, n=7000):
    """(train CSR, test CSR) of planted interactions: users 0 and 7 and
    item 5 have none; popular items and active users, as in the cell."""
    rng = np.random.default_rng(seed % 2 ** 32)
    u = np.minimum((U * rng.power(0.6, n)).astype(np.int64), U - 1)
    i = np.minimum((I * rng.power(0.4, n)).astype(np.int64), I - 1)
    keep = ~np.isin(u, (0, 7)) & (i != 5)
    keys = np.unique(u[keep] * I + i[keep])
    u, i = (keys // I).astype(np.int32), (keys % I).astype(np.int32)
    r = np.ones(len(u), np.float32)
    test = rng.random(len(u)) < 0.1
    return tuple(csr_from_arrays(u[m], i[m], r[m], U, I, use_native=False)
                 for m in (~test, test))


def _ref_csrs(csr):
    tc = tuple(torch.from_numpy(a) for a in (csr.indptr, csr.indices,
                                              csr.data))
    return tc, mf_als.transpose(*tc, csr.n_items)


def _start(csr, F, seed, dtype=torch.float32):
    """The port's starting model as ``train_bpr`` makes it, and the
    reference's, in float64."""
    m = init_model(csr.n_users, csr.n_items, F, 0.0, seed=seed,
                   device="cpu")
    m = MFModel(P=m.P, Q=m.Q, user_bias=torch.zeros_like(m.user_bias),
                item_bias=torch.zeros_like(m.item_bias),
                global_bias=torch.zeros(()))
    ref = [t.to(torch.float64) for t in
           mf_bpr.init_tables(csr.n_users, csr.n_items, F, seed)]
    return pack(with_dtype(m, dtype)), ref


def _hyper():
    return Hyper(*(float(np.float32(HP[k])) for k in (
        "learning_rate", "P_reg", "Q_reg", "user_bias_reg",
        "item_bias_reg")))


def _worst(pm, ref) -> float:
    """The widest gap of an entry, against its leaf's largest entry."""
    m = unpack(pm)
    return max(float((getattr(m, k).to(torch.float64) - r).abs().max())
               / max(float(r.abs().max()), 1e-300)
               for k, r in zip(LEAVES, ref))


def _run(csr, F, seed, dtype=torch.float32, item_negative=True):
    """{step: (port's worst gap against the reference)} after steps 1 and
    3, the reference leaving out the item-negative pass where asked."""
    pm, ref = _start(csr, F, seed, dtype)
    dev = to_device(csr, "cpu", item_major=True)
    tc, itc = _ref_csrs(csr)
    gaps = {}
    for it in range(3):
        pm = bpr.bpr_step(pm, dev, _hyper(), prng_key(seed), it)
        ref = mf_bpr.step(ref, tc, itc, mf_sgd.Hyper(HP),
                          mf_bpr.key_of(seed), it,
                          item_negative=item_negative)
        if it in (0, 2):
            gaps[it + 1] = _worst(pm, ref)
    return gaps


@pytest.mark.parametrize("lean", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_draws_equal_the_reference(seed, lean):
    train, _ = _split(seed)
    dev = to_device(train, "cpu", item_major=True, lean=lean)
    tc, itc = _ref_csrs(train)
    masks = {"i_pos": "has_u", "u_of_y": "has_y", "iv": "has_v"}
    for it in range(3):
        got = bpr.bpr_draws(dev, prng_key(seed), it)
        want = mf_bpr.draws(mf_bpr.key_of(seed), it, tc, itc,
                            train.n_items)
        assert not bool(want["has_u"][0]) and not bool(want["has_y"][5])
        for name in got._fields:
            g, w = getattr(got, name), want[name]
            if name in masks:     # a draw of an empty row is a placeholder
                g, w = g[want[masks[name]]], w[want[masks[name]]]
            assert torch.equal(g.to(w.dtype), w), (it, name)


@pytest.mark.parametrize("F", [8, 50])
@pytest.mark.parametrize("seed", SEEDS)
def test_steps_agree_with_the_reference(seed, F):
    gaps = _run(_split(seed)[0], F, seed)
    assert max(gaps.values()) <= TOL, gaps
    assert min(gaps.values()) > 0.0      # float32 against float64


@pytest.mark.parametrize("seed", SEEDS)
def test_auc_eval_equals_the_reference(seed):
    train, test = _split(seed)
    pm, ref = _start(train, 8, seed)
    dev = to_device(train, "cpu", item_major=True)
    tc, itc = _ref_csrs(train)
    for it in range(2):
        pm = bpr.bpr_step(pm, dev, _hyper(), prng_key(seed), it)
        ref = mf_bpr.step(ref, tc, itc, mf_sgd.Hyper(HP),
                          mf_bpr.key_of(seed), it)
    pairs = mf_bpr.auc_pairs(test, train.n_items, seed)
    assert len(pairs[0]) == test.nnz > 100
    want = mf_bpr.auc(ref, pairs)
    got = bpr.auc_eval(unpack(pm), train, test, seed=seed)
    assert 0.0 < want < 1.0
    assert got == pytest.approx(want, abs=2.0 ** -24)


@pytest.mark.parametrize("F", [8, 50])
def test_bf16_tables_fall_outside_the_tolerance(F):
    gaps = _run(_split(SEEDS[0])[0], F, SEEDS[0], dtype=torch.bfloat16)
    assert min(gaps.values()) > 16 * TOL, gaps


@pytest.mark.parametrize("F", [8, 50])
def test_a_step_without_its_item_negative_pass_falls_outside(F):
    gaps = _run(_split(SEEDS[0])[0], F, SEEDS[0], item_negative=False)
    assert min(gaps.values()) > 1000 * TOL, gaps
