"""K4's plain version (``ops/cuda_gram.py``) and the system functions that
route to it (``ops/als.py``, ``ops/ials.py``), against the TPU package on
the CPU.

Each chunk (F = 8 and 16, widths 8 and 24, masked slots, a system with no
rating, and one heavy row of three segments) goes through the TPU
package's gather, design and einsums and through the port.  The Grams and
right-hand sides are float32 sums in another order: elementwise within
1e-5 of the same sum of absolute values, |X|ᵀ|X| (``gram_scale``), plus
1e-6.  The solves are float32 Cholesky solves of well-conditioned systems:
rtol 1e-4 / atol 1e-5, as in ``test_torch_als.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cu2rec_torch.experiments import gram_times
from cu2rec_torch.ops import als as t_als
from cu2rec_torch.ops import cuda_gram
from cu2rec_torch.ops import ials as t_ials
from cu2rec_tpu.ops import als as j_als
from cu2rec_tpu.ops import ials as j_ials

RTOL, ATOL = 1e-4, 1e-5
GRAM_RTOL, GRAM_ATOL = 1e-5, 1e-6
R = 40                   # rows of the counterpart table
MU, ALPHA, REG = 3.1, 2.0, 0.5


def _chunk(F, D, kind, seed):
    """A packed counterpart table [q | b | 0…] (R, W) and a chunk of it:
    ``kind`` "reg" (9 systems, ragged lengths, system 3 with no rating) or
    "heavy" (one row of three segments of width D, the last one short).
    Masked slots hold zeros, as the chunks do."""
    rng = np.random.default_rng(seed)
    W = -(-(F + 1) // 4) * 4
    T = np.zeros((R, W), np.float32)
    T[:, :F + 1] = rng.normal(0, 0.3, (R, F + 1))
    B = 9 if kind == "reg" else 3
    lens = rng.integers(1, D + 1, B)
    if kind == "reg":
        lens[3] = 0
    else:
        lens[:2] = D
    mask = np.arange(D)[None, :] < lens[:, None]
    cols = np.where(mask, rng.integers(0, R, (B, D)), 0)
    vals = np.where(mask, rng.integers(1, 11, (B, D)) / 2, 0).astype(
        np.float32)
    return T, cols, vals, mask


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _within(got, want, scale):
    got, want, scale = (np.asarray(x, np.float64) for x in
                        (got, want, scale))
    err = np.abs(got - want)
    lim = GRAM_RTOL * scale + GRAM_ATOL
    assert (err <= lim).all(), float((err - lim).max())


def _j_design(T, cols, vals, mask, F):
    """The TPU package's design, as its chunk solves build it: the gather,
    X = [q | 1]·mask and y = (r − μ − b)·mask."""
    other = jnp.asarray(T)[jnp.asarray(cols)]
    q, b = other[..., :F], other[..., F]
    m = jnp.asarray(mask, jnp.float32)[..., None]
    X = jnp.concatenate([q, jnp.ones_like(b)[..., None]], axis=-1) * m
    y = (jnp.asarray(vals) - MU - b) * jnp.asarray(mask)
    return X, y


@pytest.mark.parametrize("F", [8, 16])
@pytest.mark.parametrize("D", [8, 24])
@pytest.mark.parametrize("kind", ["reg", "heavy"])
def test_als_gram_and_solve_match_tpu_package(F, D, kind):
    """The ALS Gram XᵀX and Xᵀy of the plain version against the TPU
    package's design, and the chunk's θ against ``_solve_bucket_weighted``
    (regular) or ``_solve_heavy`` (heavy)."""
    T, cols, vals, mask = _chunk(F, D, kind, seed=F + D)
    Tt, ct, vt, mt = _torch(T, cols, vals, mask)
    Tx = t_als.design_table(Tt, F)
    mu = torch.tensor(MU)
    G, rhs = cuda_gram.gram_rhs_reference(Tx.rows, ct, vt, mt, F + 1,
                                          mu=mu)
    SG, Sr = gram_times.gram_scale(Tx.rows, ct, vt, mt, F + 1, mu=mu)
    X, y = _j_design(T, cols, vals, mask, F)
    _within(G, jnp.einsum("bdf,bdg->bfg", X, X), SG)
    _within(rhs, jnp.einsum("bdf,bd->bf", X, y), Sr)
    reg = t_als.reg_vector(0.05, 0.03, F)
    reg_j = jnp.asarray(reg.numpy())
    if kind == "reg":
        deg = mt.sum(1).to(torch.float32)[:, None]
        Gs, rs = t_als.bucket_system(Tt, ct, vt, mt, mu, reg, deg)
        torch.testing.assert_close(Gs, cuda_gram.add_ridge(G.clone(), reg,
                                                           deg))
        assert torch.equal(rs, rhs)
        got = t_als._solve_bucket_weighted(Tt, ct, vt, mt, mu, reg, deg)
        want = j_als._solve_bucket_weighted(
            jnp.asarray(T), jnp.asarray(cols), jnp.asarray(vals),
            jnp.asarray(mask), jnp.float32(MU), reg_j,
            jnp.asarray(deg.numpy()), solver="blocked")
    else:
        s0, s1 = torch.tensor([0]), torch.tensor([3])
        deg = torch.tensor([float(mask.sum())])
        got = t_als._solve_heavy(Tt, ct, vt, mt, mu, reg, s0, s1, deg)
        want = j_als._solve_heavy(
            jnp.asarray(T), jnp.asarray(cols), jnp.asarray(vals),
            jnp.asarray(mask), jnp.float32(MU), reg_j, jnp.asarray([0]),
            jnp.asarray([3]), jnp.asarray(deg.numpy()), solver="blocked")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("F", [8, 16])
@pytest.mark.parametrize("D", [8, 24])
@pytest.mark.parametrize("kind", ["reg", "heavy"])
def test_ials_gram_and_solve_match_tpu_package(F, D, kind):
    """The iALS correction Σ (α r m) q qᵀ and Σ (1 + α r) m q of the plain
    version against the TPU package's einsums, and the chunk's θ against
    ``_solve_ials_bucket`` (regular) or ``_solve_ials_heavy`` (heavy)."""
    T, cols, vals, mask = _chunk(F, D, kind, seed=F * D)
    T = np.ascontiguousarray(T[:, :F])
    Tt, ct, vt, mt = _torch(T, cols, vals, mask)
    G, rhs = cuda_gram.gram_rhs_reference(Tt, ct, vt, mt, F, alpha=ALPHA)
    SG, Sr = gram_times.gram_scale(Tt, ct, vt, mt, F, alpha=ALPHA)
    q = jnp.asarray(T)[jnp.asarray(cols)]
    m = jnp.asarray(mask, jnp.float32)
    w = ALPHA * jnp.asarray(vals) * m
    _within(G, jnp.einsum("bdf,bdg->bfg", q * w[..., None], q), SG)
    _within(rhs, jnp.einsum("bdf,bd->bf", q,
                            (1.0 + ALPHA * jnp.asarray(vals)) * m), Sr)
    Gg = t_ials.gramian(Tt)
    Gj = j_ials.gramian(jnp.asarray(T))
    args_j = (jnp.asarray(T), Gj, jnp.asarray(cols), jnp.asarray(vals),
              jnp.asarray(mask))
    if kind == "reg":
        got = t_ials._solve_ials_bucket(Tt, Gg, ct, vt, mt, ALPHA, REG)
        want = j_ials._solve_ials_bucket(*args_j, ALPHA, REG,
                                         solver="blocked")
    else:
        s0, s1 = torch.tensor([0]), torch.tensor([3])
        got = t_ials._solve_ials_heavy(Tt, Gg, ct, vt, mt, s0, s1, ALPHA,
                                       REG)
        want = j_ials._solve_ials_heavy(*args_j, jnp.asarray([0]),
                                        jnp.asarray([3]), ALPHA, REG,
                                        solver="blocked")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _modes(F=8, D=8):
    """gather_gram's three callers' arguments on one chunk: ALS over the
    design rows with the ridge, iALS over a table with YᵀY, iALS over rows
    read in order (the serving engines')."""
    T, cols, vals, mask = _chunk(F, D, "reg", seed=5)
    Tt, ct, vt, mt = _torch(T, cols, vals, mask)
    Tx = t_als.design_table(Tt, F)
    q = Tt[:, :F].contiguous()
    G_global = t_ials.gramian(q)
    deg = mt.sum(1).to(torch.float32)
    return {
        "als": ((Tx.rows, ct, vt, mt, F + 1),
                dict(mu=torch.tensor(MU),
                     reg_vec=t_als.reg_vector(0.05, 0.03, F), deg=deg)),
        "ials": ((q, ct, vt, mt, F),
                 dict(alpha=ALPHA, G_global=G_global, reg=REG)),
        "rows": ((q[ct].reshape(-1, F), None, vt, mt, F),
                 dict(alpha=ALPHA, G_global=G_global, reg=REG)),
    }


@pytest.mark.parametrize("mode", ["als", "ials", "rows"])
def test_cpu_tensors_run_the_plain_version(mode):
    """On CPU tensors ``gather_gram`` is the plain version and its
    epilogue, bit for bit, and launches nothing."""
    args, kw = _modes()[mode]
    n0 = cuda_gram.LAUNCHES
    G, rhs = cuda_gram.gather_gram(*args, **kw)
    assert cuda_gram.LAUNCHES == n0
    plain = {k: kw[k] for k in ("mu", "alpha") if k in kw}
    want_G, want_rhs = cuda_gram.gram_rhs_reference(*args, **plain)
    if mode == "als":
        want_G = cuda_gram.add_ridge(want_G, kw["reg_vec"], kw["deg"])
    else:
        want_G = cuda_gram.add_global(want_G, kw["G_global"], kw["reg"])
    assert torch.equal(G, want_G) and torch.equal(rhs, want_rhs)
    assert G.shape == (9, args[4], args[4])
    if mode == "als":  # XᵀX bit for bit; (w·q)ᵀq only up to rounding
        assert torch.equal(G, G.mT)


def test_rows_in_order_match_the_gathered_table():
    """The serving engines' rows read in order give the systems of the
    table they were gathered from (``ials_rows_system`` and
    ``ials_bucket_system`` agree)."""
    modes = _modes()
    (q, ct, vt, mt, F), kw = modes["ials"]
    a = t_ials.ials_bucket_system(q, kw["G_global"], ct, vt, mt, ALPHA, REG)
    b = t_ials.ials_rows_system(q[ct], kw["G_global"], vt, mt, ALPHA, REG)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mode", ["als", "ials", "rows"])
def test_masked_slots_contribute_nothing_but_their_nan(mode):
    """Garbage under masked slots (values, and ids out of range for ALS,
    whose masked slots read the zero row) leaves every sum unchanged; a
    NaN value under a masked slot makes that system's rhs NaN (and its
    iALS G), as the mask multiplies it — the result K4 must give too."""
    args, kw = _modes()[mode]
    G0, r0 = cuda_gram.gather_gram(*args, **kw)
    rows, idx, vals, mask, n = args
    hole = ~mask
    vals = vals.clone()
    vals[hole] = 7e30
    if mode == "als":
        idx = idx.clone()
        idx[hole] = 10 ** 6
    G1, r1 = cuda_gram.gather_gram(rows, idx, vals, mask, n, **kw)
    assert torch.equal(G0, G1) and torch.equal(r0, r1)
    vals[0, hole[0]] = float("nan")
    assert hole[0].any()
    G2, r2 = cuda_gram.gather_gram(rows, idx, vals, mask, n, **kw)
    assert r2[0].isnan().all() and not r2[1:].isnan().any()
    assert G2[0].isnan().all() == (mode != "als")
    assert torch.equal(G2[1:], G0[1:])


def test_gram_rows_widens_and_aligns():
    """``gram_rows``: a float32 table (or a view of its first columns) on a
    16-byte stride is passed through; a bf16 table is widened; rows on a
    stride off 16 bytes are copied with zero columns appended."""
    T = torch.randn(5, 8)
    assert cuda_gram.gram_rows(T) is T
    assert cuda_gram.gram_rows(T[:, :4]).data_ptr() == T.data_ptr()
    wide = cuda_gram.gram_rows(T.to(torch.bfloat16))
    assert wide.dtype == torch.float32
    assert torch.equal(wide, T.to(torch.bfloat16).to(torch.float32))
    assert cuda_gram.gram_rows(T[:, :5]).data_ptr() == T.data_ptr()
    odd = cuda_gram.gram_rows(T[:, :5].contiguous())
    assert odd.shape == (5, 8) and odd.stride(0) == 8
    assert torch.equal(odd[:, :5], T[:, :5]) and not odd[:, 5:].any()


def test_gather_gram_rejects_what_it_cannot_take():
    args, kw = _modes()["als"]
    rows, idx, vals, mask, n = args
    with pytest.raises(ValueError, match="not both"):
        cuda_gram.gather_gram(*args, **kw, alpha=1.0)
    with pytest.raises(ValueError, match="ALS needs"):
        cuda_gram.gather_gram(rows, None, vals, mask, n, mu=kw["mu"])
    with pytest.raises(ValueError, match="ALS needs"):
        cuda_gram.gather_gram(rows, idx, vals, mask, rows.shape[1],
                              mu=kw["mu"])
    with pytest.raises(ValueError, match="W >= n"):
        cuda_gram.gather_gram(rows, idx, vals, mask, rows.shape[1] + 1,
                              alpha=1.0)
    with pytest.raises(TypeError, match="bool"):
        cuda_gram.gather_gram(rows, idx, vals, mask.to(torch.uint8), n,
                              mu=kw["mu"])
    with pytest.raises(ValueError, match="in order"):
        cuda_gram.gather_gram(rows, None, vals, mask, n, alpha=1.0)


@pytest.mark.parametrize("ials", [False, True])
def test_gram_work_by_hand(ials):
    """K4's bound arithmetic at n = 3, two systems of four slots, five of
    them live, over four distinct rows, with the epilogue:
      rows   4 rows · 3 floats · 4 B                       =  48
      slots  8 · (4 B value + 1 B mask + 8 B id)           = 104 (ALS)
             8 · (4 + 1), ids read in order                =  40 (iALS)
      G, rhs 2 · (9 + 3) · 4 B                             =  96
      ALS:   the rows' biases 4 · 4 B = 16, λ and the degrees (3 + 2)·4 B
             = 20: 284 bytes
      iALS:  YᵀY 9 · 4 B = 36: 220 bytes
      flops  5 live slots · (6 triangle + 3 rhs) · 2       =  90
    """
    got = gram_times.gram_work(3, 2, 8, 5, 4, ials=ials, epilogue=True,
                              ids=not ials)
    assert got == ((220, 90) if ials else (284, 90))


@pytest.mark.parametrize("bad", [-1, R])
def test_ials_fold_in_holds_its_ids(bad):
    """``ials_fold_in`` takes ids from outside (``predict --implicit``):
    a masked-in id out of [0, I) raises ValueError before anything runs,
    and masked-out slots may hold any id, the result unchanged."""
    rng = np.random.default_rng(5)
    Y = torch.from_numpy(rng.normal(0, 0.3, (R, 8)).astype(np.float32))
    cols = rng.integers(0, R, (3, 5))
    vals = np.ones((3, 5), np.float32)
    mask = np.ones((3, 5), bool)
    mask[1, 3:] = False
    x0 = t_ials.ials_fold_in(Y, cols, vals, mask, ALPHA, REG)
    held = cols.copy()
    held[1, 3:] = bad
    assert torch.equal(t_ials.ials_fold_in(Y, held, vals, mask, ALPHA, REG),
                       x0)
    held[0, 2] = bad
    with pytest.raises(ValueError, match=r"ids must lie in \[0, 40\)"):
        t_ials.ials_fold_in(Y, held, vals, mask, ALPHA, REG)
