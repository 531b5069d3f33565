"""The port's ALS (``ops/als.py``, ``train/als.py``) against the TPU
package's, on the CPU.

Bucketing and chunk contents are integer bookkeeping: exactly equal.  The
systems and solves are float32 Gram products in another summation order
and float32 Cholesky solves of well-conditioned systems: rtol 1e-4 /
atol 1e-5 for a solve or a half sweep, and per-sweep RMSE/MAE within 1e-4
relative of the TPU package's training run from the same initial tables.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cu2rec_torch.data.csr import csr_from_arrays as t_csr
from cu2rec_torch.data.csr import transpose_csr
from cu2rec_torch.models.state import model_from_numpy
from cu2rec_torch.ops import als as t_als
from cu2rec_torch.ops.cuda_gram import design
from cu2rec_torch.ops.packed import pack as t_pack
from cu2rec_torch.train.als import train_als as t_train
from cu2rec_torch.utils.config import Config
from cu2rec_torch.utils.metrics import MetricsLogger
from cu2rec_tpu.data.csr import csr_from_arrays as j_csr
from cu2rec_tpu.models.state import init_model as j_init_model
from cu2rec_tpu.models.state import model_to_numpy as j_model_to_numpy
from cu2rec_tpu.ops import als as j_als
from cu2rec_tpu.ops.packed import pack as j_pack
from cu2rec_tpu.train.als import train_als as j_train

RTOL, ATOL = 1e-4, 1e-5
SMALL_CAPS = (4, 8)


def _ratings(U=60, I=25, n=700, seed=0, empty=(0, 7)):
    """Power-law item popularity (some items far above the small caps) and
    a few users with no ratings."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, U, n)
    u = u[~np.isin(u, empty)]
    i = np.minimum((I * rng.power(0.4, len(u))).astype(np.int64), I - 1)
    keys = np.unique(u * I + i)
    u, i = (keys // I).astype(np.int32), (keys % I).astype(np.int32)
    r = (rng.integers(1, 11, len(u)) / 2.0).astype(np.float32)
    return u, i, r, U, I


def _both_csrs(*args, **kw):
    u, i, r, U, I = _ratings(*args, **kw)
    return t_csr(u, i, r, U, I), j_csr(u, i, r, U, I, use_native=False)


def _tables(U, I, F, seed):
    rng = np.random.default_rng(seed)
    return {"p": rng.normal(0, 0.3, (U, F)).astype(np.float32),
            "q": rng.normal(0, 0.3, (I, F)).astype(np.float32),
            "user_bias": rng.normal(0, 0.1, U).astype(np.float32),
            "item_bias": rng.normal(0, 0.1, I).astype(np.float32),
            "global_bias": np.array([3.0], np.float32)}


def _j_model(d):
    from cu2rec_tpu.models.state import MFModel
    return MFModel(P=jnp.asarray(d["p"]), Q=jnp.asarray(d["q"]),
                   user_bias=jnp.asarray(d["user_bias"]),
                   item_bias=jnp.asarray(d["item_bias"]),
                   global_bias=jnp.float32(d["global_bias"][0]))


@pytest.mark.parametrize("caps", [j_als.BUCKET_CAPS, SMALL_CAPS, (2, 3, 8)])
@pytest.mark.parametrize("side", ["users", "items"])
def test_bucketing_is_identical(caps, side):
    t, _ = _both_csrs()
    if side == "users":
        ip, ind, dat = t.indptr, t.indices, t.data
    else:
        ip, ind, dat = transpose_csr(t)
    tm, jm = t_als.bucket_meta(ip, caps), j_als.bucket_meta(ip, caps)
    assert len(tm) == len(jm)
    for a, b in zip(tm, jm):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # With a budget of one chunk a bucket, each chunk holds its bucket's
    # slices as the TPU package's host expansion pads them.
    tc = t_als.prepare_chunks(torch.from_numpy(ind), torch.from_numpy(dat),
                              ip, 4, len(ind), caps=caps, budget=1 << 40)
    jb = j_als.bucket_csr(ip, ind, dat, caps)
    assert len(tc) == len(jb.buckets)
    for ch, b in zip(tc, jb.buckets):
        keys = ["cols", "vals", "mask", "row_ids"]
        if ch[0] == "heavy":
            keys += ["seg_start", "seg_end", "deg"]
        assert ch[0] == ("heavy" if "seg_start" in b else "reg")
        assert len(ch) - 1 == len(b) == len(keys)
        for k, a in zip(keys, ch[1:]):
            np.testing.assert_array_equal(a.numpy(), b[k], err_msg=k)
    if caps == SMALL_CAPS and side == "items":
        assert tc[-1][0] == "heavy"      # heavy rows exist


def test_heavy_groups_are_identical():
    seg_end = np.cumsum([3, 1, 5, 2, 2, 7, 1])
    seg_start = seg_end - np.array([3, 1, 5, 2, 2, 7, 1])
    for chunk in (1, 4, 6, 30):
        assert t_als._heavy_groups(seg_start, seg_end, chunk) == \
            j_als._heavy_groups(seg_start, seg_end, chunk)


def _to_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _chunks(ip, ind, dat, F, caps=SMALL_CAPS, **kw):
    """The port's chunks of one CSR side, built from CPU tensors."""
    return t_als.prepare_chunks(torch.from_numpy(ind), torch.from_numpy(dat),
                                ip, F, len(ind), caps=caps, **kw)


CHUNK_DTYPES = {"reg": (torch.int64, torch.float32, torch.bool, torch.int64),
                "heavy": (torch.int64, torch.float32, torch.bool, torch.int64,
                          torch.int64, torch.int64, torch.float32)}


@pytest.mark.parametrize("budget", [10_000, 64 << 20])
def test_chunks_match_both_tpu_package_builders(budget):
    """The one chunk builder against both of the TPU package's, its host
    ``prepare_chunks(bucket_csr(...))`` and its ``prepare_chunks_device``:
    each chunk equals theirs without their padding rows, in the dtypes the
    half sweeps read."""
    t, _ = _both_csrs()
    ip, ind, dat = transpose_csr(t)
    F, n = 4, t.n_items
    port = _chunks(ip, ind, dat, F, budget=budget)
    host = j_als.prepare_chunks(j_als.bucket_csr(ip, ind, dat, SMALL_CAPS),
                                F, n, budget=budget)
    dev = j_als.prepare_chunks_device(
        jnp.asarray(ind), jnp.asarray(dat), ip, F, n, t.nnz,
        caps=SMALL_CAPS, budget=budget)
    tags = [c[0] for c in port]
    assert tags == [c[0] for c in host] == [c[0] for c in dev]
    assert "heavy" in tags
    for p, h, d in zip(port, host, dev):
        assert tuple(a.dtype for a in p[1:]) == CHUNK_DTYPES[p[0]]
        nseg, nrows = p[1].shape[0], p[4].shape[0]
        for j in (h, d):
            for k, (a, b) in enumerate(zip(p[1:], j[1:])):
                n_kept = nseg if k < 3 else nrows
                np.testing.assert_array_equal(a.numpy(),
                                              _to_numpy(b)[:n_kept])


@pytest.mark.parametrize("n_ranks", [2, 3, 4])
def test_row_sharded_chunks_deal_every_row_once(n_ranks):
    """With a row sharding of n ranks, rank r keeps rows [s + rB/n,
    s + (r+1)B/n) of each regular chunk [s, s + B) and the heavy chunks
    k ≡ r (mod n), each the unsharded chunk's own slice: every rated row
    is dealt to exactly one rank."""
    from types import SimpleNamespace

    t, _ = _both_csrs()
    ip, ind, dat = t.indptr, t.indices, t.data
    whole = _chunks(ip, ind, dat, 4, budget=300)
    regs = [c for c in whole if c[0] == "reg"]
    heavies = [c for c in whole if c[0] == "heavy"]
    assert len(regs) > n_ranks and len(heavies) > n_ranks
    dealt = []
    for r in range(n_ranks):
        mine = _chunks(ip, ind, dat, 4, budget=300,
                       row_sharding=SimpleNamespace(size=n_ranks, rank=r))
        want = []
        for c in regs:
            B = c[1].shape[0]
            lo, hi = r * B // n_ranks, (r + 1) * B // n_ranks
            if hi > lo:
                want.append(("reg", *(x[lo:hi] for x in c[1:])))
        want += heavies[r::n_ranks]
        assert [c[0] for c in mine] == [c[0] for c in want]
        for a, b in zip(mine, want):
            assert all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))
        dealt += [c[4] for c in mine]
    rows = torch.cat(dealt).sort().values
    assert torch.equal(rows, torch.cat([c[4] for c in whole]).sort().values)
    assert torch.equal(rows.unique(), rows)


def _chunk_inputs():
    """The item side's chunks (small caps, so heavy ones too) of both
    packages, and packed user tables of both."""
    t, j = _both_csrs(seed=2)
    ip, ind, dat = transpose_csr(t)
    d = _tables(t.n_users, t.n_items, 8, seed=1)
    t_pm = t_pack(model_from_numpy(d, "cpu"))
    j_pm = j_pack(_j_model(d))
    tc = _chunks(ip, ind, dat, 8, budget=2000)
    jc = j_als.prepare_chunks(j_als.bucket_csr(ip, ind, dat, SMALL_CAPS), 8,
                              t.n_items, budget=2000)
    return t_pm, j_pm, tc, jc


@pytest.mark.parametrize("solver", ["blocked", "pallas"])
def test_chunk_solves_match(solver):
    """Every chunk's solve against the TPU package's blocked solver; the
    Pallas solver (interpret mode) on one small regular and one heavy
    chunk only."""
    t_pm, j_pm, tc, jc = _chunk_inputs()
    reg_t = t_als.reg_vector(0.05, 0.03, 8)
    reg_j = jnp.asarray(reg_t.numpy())
    mu_t = torch.tensor(3.1, dtype=torch.float32)
    pairs = list(zip(tc, jc))
    if solver == "pallas":
        pairs = [next(p for p in pairs if p[0][0] == "reg"),
                 next(p for p in pairs if p[0][0] == "heavy")]
    for th, jh in pairs:
        if th[0] == "reg":
            cols, vals, mask, _rows = th[1:]
            deg = mask.sum(1).to(torch.float32)[:, None]
            got = t_als._solve_bucket_weighted(
                t_pm.T_u, cols, vals, mask, mu_t, reg_t, deg)
            jcols, jvals, jmask, _ = jh[1:]
            want = j_als._solve_bucket_weighted(
                j_pm.T_u, jcols, jvals, jmask, jnp.float32(3.1), reg_j,
                jmask.sum(1).astype(jnp.float32)[:, None], solver=solver)
        else:
            cols, vals, mask, _rows, s0, s1, deg = th[1:]
            got = t_als._solve_heavy(t_pm.T_u, cols, vals, mask, mu_t, reg_t,
                                     s0, s1, deg)
            want = j_als._solve_heavy(j_pm.T_u, *jh[1:4], jnp.float32(3.1),
                                      reg_j, *jh[5:8], solver=solver)
        want = np.asarray(want)[:got.shape[0]]
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_system_assembly_is_what_the_solve_solves():
    """``bucket_system``/``heavy_system`` return the (G, rhs) the solves
    finish: G symmetric with the degree-scaled ridge on its diagonal."""
    t_pm, _, tc, _ = _chunk_inputs()
    reg = t_als.reg_vector(0.05, 0.03, 8)
    mu = torch.tensor(3.1)
    reg_ch = next(c for c in tc if c[0] == "reg")
    cols, vals, mask, _ = reg_ch[1:]
    deg = mask.sum(1).to(torch.float32)[:, None]
    G, rhs = t_als.bucket_system(t_pm.T_u, cols, vals, mask, mu, reg, deg)
    torch.testing.assert_close(G, G.mT, rtol=0, atol=0)
    X, y = design(t_als.design_table(t_pm.T_u, 8).rows, cols, vals, mask,
                  mu, 9)
    torch.testing.assert_close(
        G - torch.diag_embed(reg[None] * deg.clamp(min=1)), X.mT @ X,
        rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        t_als._ridge_finish(G, rhs),
        t_als._solve_bucket_weighted(t_pm.T_u, cols, vals, mask, mu, reg,
                                     deg))
    heavy = next(c for c in tc if c[0] == "heavy")
    G, rhs = t_als.heavy_system(t_pm.T_u, *heavy[1:4], mu, reg, *heavy[5:8])
    assert G.shape == (heavy[4].shape[0], 9, 9)
    # Row 0's Gram is the sum over its own segments.
    X, y = design(t_als.design_table(t_pm.T_u, 8).rows, *heavy[1:4], mu,
                  9)
    s0, s1 = int(heavy[5][0]), int(heavy[6][0])
    Xr = X[s0:s1].reshape(-1, 9)
    want = Xr.T @ Xr + torch.diag(reg * heavy[7][0].clamp(min=1))
    torch.testing.assert_close(G[0], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("weight_by_degree", [True, False])
@pytest.mark.parametrize("side", ["users", "items"])
def test_half_sweep_matches(weight_by_degree, side):
    t, _ = _both_csrs(seed=4)
    d = _tables(t.n_users, t.n_items, 8, seed=3)
    t_pm, j_pm = t_pack(model_from_numpy(d, "cpu")), j_pack(_j_model(d))
    if side == "users":
        ip, ind, dat = t.indptr, t.indices, t.data
        selves = (t_pm.T_u, t_pm.T_i), (j_pm.T_u, j_pm.T_i)
    else:
        ip, ind, dat = transpose_csr(t)
        selves = (t_pm.T_i, t_pm.T_u), (j_pm.T_i, j_pm.T_u)
    n = selves[0][0].shape[0]
    tc = _chunks(ip, ind, dat, 8, budget=3000)
    jc = j_als.prepare_chunks(j_als.bucket_csr(ip, ind, dat, SMALL_CAPS), 8,
                              n, budget=3000)
    kw = dict(factor_reg=0.05, bias_reg=0.02, n_factors=8,
              weight_by_degree=weight_by_degree)
    got = t_als.als_half_sweep(*selves[0], tc, 3.2, **kw)
    want = np.asarray(j_als.als_half_sweep(*selves[1], jc, 3.2, **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    empty = np.diff(ip) == 0
    assert empty.any() or side == "items"
    assert torch.equal(got[torch.from_numpy(empty)],
                       selves[0][0][torch.from_numpy(empty)])
    assert not torch.equal(got, selves[0][0])


def test_half_sweep_refuses_what_is_not_ported():
    """A row sharding over a grid of one rank solves every row, as the
    sweep without one does (the multi-rank sweeps: test_torch_parallel.py);
    a chunk of an unknown tag is refused."""
    from cu2rec_torch.parallel.sharded import make_mesh

    t, _ = _both_csrs()
    d = _tables(t.n_users, t.n_items, 4, seed=0)
    pm = t_pack(model_from_numpy(d, "cpu"))
    chunks = _chunks(t.indptr, t.indices, t.data, 4, caps=t_als.BUCKET_CAPS)
    mesh = make_mesh(1, 1, "cpu")
    sharded = _chunks(t.indptr, t.indices, t.data, 4, row_sharding=mesh)
    got = t_als.als_half_sweep(pm.T_u, pm.T_i, sharded, 3.0, 0.1, 0.1, 4,
                               row_sharding=mesh)
    want = t_als.als_half_sweep(pm.T_u, pm.T_i, chunks, 3.0, 0.1, 0.1, 4)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="unknown chunk tag"):
        t_als.als_half_sweep(pm.T_u, pm.T_i, [("odd",) + chunks[0][1:]],
                             3.0, 0.1, 0.1, 4)


def _train_both(sweeps, device_buckets, cur=0, model=None):
    u, i, r, U, I = _ratings(U=80, I=40, n=1500, seed=6)
    cut = np.random.default_rng(0).random(len(u)) < 0.85
    t_tr, t_te = (t_csr(u[s], i[s], r[s], U, I) for s in (cut, ~cut))
    j_tr, j_te = (j_csr(u[s], i[s], r[s], U, I, use_native=False)
                  for s in (cut, ~cut))
    gb = float(np.mean(r[cut]))
    init = j_model_to_numpy(j_init_model(U, I, 8, gb, seed=5))
    runs = {}
    for name in ("port", "jax"):
        cfg = Config(total_iterations=sweeps, n_factors=8, seed=5,
                     P_reg=0.05, Q_reg=0.05, user_bias_reg=0.02,
                     item_bias_reg=0.02, cur_iterations=cur)
        logger = MetricsLogger(verbose=False)
        if name == "port":
            m = model_from_numpy(init, "cpu") if model is None else model
            out = t_train(t_tr, t_te, cfg, gb, model=m, logger=logger,
                          device="cpu")
        else:
            out = j_train(j_tr, j_te, cfg, gb, model=j_init_model(
                U, I, 8, gb, seed=5), logger=logger,
                device_buckets=device_buckets)
        runs[name] = (out, [r for r in logger.history
                            if r["event"] == "eval"], cfg)
    return runs


@pytest.mark.parametrize("device_buckets", [False, True])
def test_train_als_matches_per_sweep(device_buckets):
    """Three sweeps against the TPU package's, with either of its chunk
    builders (``device_buckets``); the port has one."""
    runs = _train_both(3, device_buckets)
    (t_model, t_losses), t_hist, t_cfg = runs["port"]
    (_j_model_out, j_losses), j_hist, _ = runs["jax"]
    assert [r["iteration"] for r in t_hist] == [1, 2, 3]
    for a, b in zip(t_hist, j_hist):
        for k in ("train_rmse", "train_mae", "test_rmse", "test_mae"):
            assert a[k] == pytest.approx(b[k], rel=1e-4), k
        assert len(a["half_sweep_ms"]) == 2
    assert t_losses.keys() == j_losses.keys()
    assert t_hist[-1]["train_rmse"] < t_hist[0]["train_rmse"]
    assert t_cfg.cur_iterations == 3
    np.testing.assert_allclose(t_model.P.numpy(),
                               np.asarray(_j_model_out.P), rtol=1e-3,
                               atol=1e-3)


def test_train_als_resume_equals_straight_run():
    u, i, r, U, I = _ratings(U=50, I=30, n=900, seed=8)
    csr = t_csr(u, i, r, U, I)
    init = model_from_numpy(_tables(U, I, 6, seed=2), "cpu")
    kw = dict(device="cpu", logger=MetricsLogger(verbose=False))

    def cfg(total, cur=0):
        return Config(total_iterations=total, n_factors=6, seed=1,
                      P_reg=0.05, Q_reg=0.05, cur_iterations=cur)

    straight, losses = t_train(csr, csr, cfg(4), 3.0, model=init, **kw)
    half, _ = t_train(csr, csr, cfg(2), 3.0, model=init, **kw)
    c = cfg(4, cur=2)
    resumed, rest = t_train(csr, csr, c, 3.0, model=half, **kw)
    assert sorted(rest) == [3, 4] and c.cur_iterations == 4
    for a, b in zip((straight.P, straight.Q, straight.user_bias,
                     straight.item_bias), (resumed.P, resumed.Q,
                                           resumed.user_bias,
                                           resumed.item_bias)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert rest[4] == losses[4]


@pytest.mark.parametrize("device_buckets", [False, True])
def test_als_sweep_in_bf16_matches(device_buckets):
    """One sweep on bf16 tables from the TPU package's bf16 draw: the
    solved rows are written rounded to bf16 in both packages, and every
    entry lands within 4 bf16 ulps of the TPU package's, with either of
    its chunk builders (``device_buckets``)."""
    from test_torch_bf16 import to_torch, ulp_distance

    u, i, r, U, I = _ratings(U=80, I=40, n=1500, seed=6)
    t_tr, j_tr = t_csr(u, i, r, U, I), j_csr(u, i, r, U, I, use_native=False)
    gb = float(np.mean(r))
    jm = j_init_model(U, I, 8, gb, seed=5, dtype=jnp.bfloat16)
    from cu2rec_torch.models.state import MFModel
    tm = MFModel(P=to_torch(jm.P), Q=to_torch(jm.Q),
                 user_bias=to_torch(jm.user_bias),
                 item_bias=to_torch(jm.item_bias),
                 global_bias=torch.tensor(np.float32(gb)))
    runs = {}
    for name in ("port", "jax"):
        cfg = Config(total_iterations=1, n_factors=8, seed=5, P_reg=0.05,
                     Q_reg=0.05, user_bias_reg=0.02, item_bias_reg=0.02,
                     dtype="bfloat16")
        logger = MetricsLogger(verbose=False)
        if name == "port":
            runs[name] = t_train(t_tr, t_tr, cfg, gb, model=tm,
                                 logger=logger, device="cpu")[0]
        else:
            runs[name] = j_train(j_tr, j_tr, cfg, gb, model=jm,
                                 logger=logger,
                                 device_buckets=device_buckets)[0]
    t_out, j_out = runs["port"], runs["jax"]
    for name in ("P", "Q", "user_bias", "item_bias"):
        got = getattr(t_out, name)
        assert got.dtype == torch.bfloat16, name
        assert ulp_distance(got.contiguous(), getattr(j_out, name)) <= 4
    assert not torch.equal(t_out.P, tm.P)


def test_train_als_in_bf16_draws_and_keeps_bf16_tables():
    csr, _ = _both_csrs()
    cfg = Config(total_iterations=2, n_factors=4, dtype="bfloat16")
    model, losses = t_train(csr, csr, cfg, 3.5, device="cpu",
                            logger=MetricsLogger(verbose=False))
    assert model.P.dtype == model.Q.dtype == torch.bfloat16
    assert sorted(losses) == [1, 2]
    assert all(np.isfinite(v) for v in losses.values())


@pytest.mark.parametrize("trace", [True, False])
def test_half_sweeps_count_their_gram_slots(trace):
    """With the trace on, one sweep counts ``als.gram_slots``, each chunk's
    padded B × D (a heavy chunk's segments × cap), and
    ``als.gram_live_slots``, its ratings: 2 × nnz a sweep.  With it off,
    nothing is recorded."""
    from cu2rec_torch.train.als import sweep_chunks
    from cu2rec_torch.utils import timing

    csr, _ = _both_csrs()
    chunks = sweep_chunks(csr, 4, "cpu")
    padded = sum(c[1].numel() for side in chunks for c in side)
    assert sum(c.slots for c in chunks) == padded > 2 * csr.nnz
    timing.trace_stop()
    if trace:
        timing.trace_start()
    t_train(csr, csr, Config(total_iterations=1, n_factors=4), 3.5,
            device="cpu", logger=MetricsLogger(verbose=False))
    counters = timing.trace_stop()["counters"]
    if trace:
        assert counters["als.gram_slots"] == padded
        assert counters["als.gram_live_slots"] == 2 * csr.nnz
    else:
        assert counters == {}
