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
                    reg=0.1)
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


# ---- the half sweeps and the trainer ---------------------------------------

def _implicit_csrs(seed=0, U=70, I=30, n=900):
    """Both packages' CSRs of implicit ratings (counts 1-3), popular items
    above the small bucket caps, and user 0 with no ratings."""
    from cu2rec_torch.data.csr import csr_from_arrays as t_csr
    from cu2rec_tpu.data.csr import csr_from_arrays as j_csr

    rng = np.random.default_rng(seed)
    u = rng.integers(1, U, n)
    i = np.minimum((I * rng.power(0.4, n)).astype(np.int64), I - 1)
    keys = np.unique(u * I + i)
    u, i = (keys // I).astype(np.int32), (keys % I).astype(np.int32)
    r = rng.integers(1, 4, len(u)).astype(np.float32)
    return (t_csr(u, i, r, U, I),
            j_csr(u, i, r, U, I, use_native=False))


def _sides(csr, side):
    from cu2rec_torch.data.csr import transpose_csr
    if side == "users":
        return csr.indptr, csr.indices, csr.data
    return transpose_csr(csr)


@pytest.mark.parametrize("solver", ["blocked", "pallas"])
def test_ials_heavy_solve_matches(solver):
    from cu2rec_torch.ops import als as t_als
    from cu2rec_torch.ops import ials as t_ials
    from cu2rec_tpu.ops import als as j_als
    from cu2rec_tpu.ops import ials as j_ials

    t, _ = _implicit_csrs(seed=1)
    ip, ind, dat = _sides(t, "items")
    X = np.random.default_rng(3).normal(0, 0.3, (t.n_users, 8)).astype(
        np.float32)
    tc = t_als.prepare_chunks(torch.from_numpy(ind), torch.from_numpy(dat),
                              ip, 8, len(ind), caps=(4, 8), budget=2000)
    jc = j_als.prepare_chunks(j_als.bucket_csr(ip, ind, dat, (4, 8)), 8,
                              t.n_items, budget=2000)
    th, jh = next((a, b) for a, b in zip(tc, jc) if a[0] == "heavy")
    Xt, Xj = torch.from_numpy(X), jnp.asarray(X)
    got = t_ials._solve_ials_heavy(Xt, t_gramian(Xt), *th[1:4], th[5], th[6],
                                   40.0, 0.1)
    want = j_ials._solve_ials_heavy(Xj, j_gramian(Xj), *jh[1:4], jh[5],
                                    jh[6], jnp.float32(40.0),
                                    jnp.float32(0.1), solver=solver)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:got.shape[0]],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("side", ["users", "items"])
def test_ials_half_sweep_matches(side):
    from cu2rec_torch.ops import als as t_als
    from cu2rec_torch.ops.ials import ials_half_sweep as t_sweep
    from cu2rec_tpu.ops import als as j_als
    from cu2rec_tpu.ops.ials import ials_half_sweep as j_sweep

    t, _ = _implicit_csrs(seed=2)
    ip, ind, dat = _sides(t, side)
    rng = np.random.default_rng(4)
    n_self = len(ip) - 1
    n_other = t.n_items if side == "users" else t.n_users
    S = rng.normal(0, 0.3, (n_self, 8)).astype(np.float32)
    O = rng.normal(0, 0.3, (n_other, 8)).astype(np.float32)
    tc = t_als.prepare_chunks(torch.from_numpy(ind), torch.from_numpy(dat),
                              ip, 8, len(ind), caps=(4, 8), budget=2500)
    jc = j_als.prepare_chunks(j_als.bucket_csr(ip, ind, dat, (4, 8)), 8,
                              n_self, budget=2500)
    got = t_sweep(torch.from_numpy(S), torch.from_numpy(O), tc, 40.0, 0.1)
    want = np.asarray(j_sweep(jnp.asarray(S), jnp.asarray(O), jc, 40.0,
                              0.1))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    empty = torch.from_numpy(np.diff(ip) == 0)
    assert torch.equal(got[empty], torch.from_numpy(S)[empty])


def test_train_ials_matches():
    """train_ials from the TPU package's initial tables: per sweep the same
    AUC (the same pairs; a comparison may flip only at a near-tie, 1e-3)
    and recall@k/NDCG@k within 1e-3 (top-k lists of continuous scores)."""
    from cu2rec_torch.data.csr import csr_from_arrays as t_csr
    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.train.ials import train_ials as t_train
    from cu2rec_torch.utils.config import Config
    from cu2rec_torch.utils.metrics import MetricsLogger
    from cu2rec_tpu.data.csr import csr_from_arrays as j_csr
    from cu2rec_tpu.data.synth import generate_planted_implicit, \
        split_arrays
    from cu2rec_tpu.models.state import init_model as j_init
    from cu2rec_tpu.models.state import model_to_numpy as j_to_numpy
    from cu2rec_tpu.train.ials import train_ials as j_train

    d, _oracle = generate_planted_implicit(150, 60, 3000, n_factors=8,
                                           seed=1)
    tr, te = split_arrays(d.users, d.items, d.ratings, 0.8, seed=2)
    hist = {}
    for name, build, train, init in (
            ("port", t_csr, t_train, lambda m: model_from_numpy(
                j_to_numpy(m), "cpu")),
            ("jax", j_csr, j_train, lambda m: m)):
        csrs = [build(*s, 150, 60) for s in (tr, te)]
        logger = MetricsLogger(verbose=False)
        cfg = Config(total_iterations=3, n_factors=8, seed=3, P_reg=0.05,
                     Q_reg=0.05)
        kw = {"device": "cpu"} if name == "port" else {}
        model, losses = train(*csrs, cfg, alpha=10.0, logger=logger,
                              model=init(j_init(150, 60, 8, 0.0, seed=3)),
                              **kw)
        hist[name] = [r for r in logger.history if r["event"] == "eval"]
        assert sorted(losses) == [1, 2, 3]
        assert float(model.user_bias.sum()) == 0.0
    for a, b in zip(hist["port"], hist["jax"]):
        assert a["iteration"] == b["iteration"]
        for k in ("auc", "recall_at_k", "ndcg_at_k", "objective"):
            assert a[k] == pytest.approx(b[k], abs=1e-3), k
        assert len(a["half_sweep_ms"]) == 2


def test_ials_sweep_from_bf16_tables_matches():
    """A bfloat16 config: the TPU package draws the initial tables in bf16
    and sweeps on float32 copies of them, and so does the port.  One sweep
    from the same bf16 draw: the tables within 4 bf16 ulps (in fact within
    the float32 tolerance of the other iALS tests)."""
    from test_torch_bf16 import to_torch

    from cu2rec_torch.models.state import MFModel
    from cu2rec_torch.train.ials import train_ials as t_train
    from cu2rec_torch.utils.config import Config
    from cu2rec_torch.utils.metrics import MetricsLogger
    from cu2rec_tpu.models.state import init_model as j_init
    from cu2rec_tpu.train.ials import train_ials as j_train

    t, j = _implicit_csrs(seed=3)
    jm = j_init(t.n_users, t.n_items, 8, 0.0, seed=3, dtype=jnp.bfloat16)
    tm = MFModel(P=to_torch(jm.P), Q=to_torch(jm.Q),
                 user_bias=to_torch(jm.user_bias),
                 item_bias=to_torch(jm.item_bias),
                 global_bias=torch.tensor(0.0))
    out = {}
    for name, train, csr, model, kw in (
            ("port", t_train, t, tm, {"device": "cpu"}),
            ("jax", j_train, j, jm, {})):
        cfg = Config(total_iterations=1, n_factors=8, seed=3, P_reg=0.1,
                     Q_reg=0.1, dtype="bfloat16")
        out[name] = train(csr, csr, cfg, alpha=10.0, model=model,
                          logger=MetricsLogger(verbose=False), **kw)[0]
    for name in ("P", "Q"):
        got = getattr(out["port"], name)
        want = np.asarray(getattr(out["jax"], name))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        # 4 bf16 ulps at the entries' scale.
        assert np.all(np.abs(got.numpy() - want)
                      <= 4 * 2.0 ** -8 * np.abs(want) + ATOL)


def test_train_ials_draws_its_bf16_tables_in_bf16():
    """The initial tables of a bfloat16 config are the float32 draw
    rounded to bf16: the first sweep starts from them."""
    from cu2rec_torch.train import ials as t_ials_train
    from cu2rec_torch.utils.config import Config
    from cu2rec_torch.utils.metrics import MetricsLogger

    csr, _ = _implicit_csrs()
    seen = []
    sweep = t_ials_train.ials_half_sweep

    def spy(T_self, T_other, *a, **kw):
        seen.append((T_self.clone(), T_other.clone()))
        return sweep(T_self, T_other, *a, **kw)

    for dtype in ("float32", "bfloat16"):
        t_ials_train.ials_half_sweep = spy
        try:
            t_ials_train.train_ials(csr, csr, Config(
                total_iterations=1, n_factors=4, dtype=dtype),
                device="cpu", logger=MetricsLogger(verbose=False))
        finally:
            t_ials_train.ials_half_sweep = sweep
    (X32, Y32), _, (Xbf, Ybf), _ = seen
    assert Xbf.dtype == torch.float32
    assert torch.equal(Xbf, X32.to(torch.bfloat16).to(torch.float32))
    assert torch.equal(Ybf, Y32.to(torch.bfloat16).to(torch.float32))
    assert not torch.equal(Xbf, X32)
