"""The port's item-sharded serving (``serve/engine.ShardedServingEngine``,
``parallel/serving.py``) against the TPU package's and against the port's
one-device engine.

One process, a CPU device for each of n_ip ∈ {2, 3, 4} shards, against the
TPU package's engine over as many of its virtual CPU devices: the shards'
packed rows, known-user recommends, a chunked scan whose chunks straddle
the shard boundaries, tiny shards (k above the rows a shard holds), the
explicit fold-in with injected initial rows, the holey-mask compaction,
the implicit fold-in and fold-in + recommend.  Then a rank for each shard
(gloo, CPU; one ``launch`` a world of 2 and of 4, each under
RANK_TIMEOUT): ``distributed_topk``, the sharded ranking evals and the
rank-mode engine against the TPU package's single-process grid.

Tolerances against the TPU package: scores rtol 1e-5; explicit fold-in
rows atol 1e-5 after 50 iterations; implicit rows rtol 1e-3 / atol 1e-4
(float32 Cholesky; the TPU package solves with XLA's, the port with K1's
plain version); the rank-mode implicit rows rtol 1e-5 / atol 1e-6 against
the single-process grid, as tests/test_distributed.py holds that package's
ranks.  Against the port's one-device engine: scores rtol 1e-6, fold-in
rows atol 1e-6 (each sampled row comes from one shard, so the sum over the
shards is that shard's bits), implicit rows rtol 1e-5 / atol 1e-6 (the
Gramian is a sum of the shards' Grams, in another order).  Item ids must
match wherever the scores are not tied.

The module imports no JAX at its top: the ranks import it to find their
job.
"""

import functools

import numpy as np
import pytest
import torch

from _torch_serving_util import (
    MODELS, assert_topk_match, planted_arrays, port_engine,
)
from cu2rec_torch.data.csr import CSRRatings, csr_from_arrays
from cu2rec_torch.models.state import model_from_numpy
from cu2rec_torch.ops.sgd import prng_key
from cu2rec_torch.parallel.distributed import launch
from cu2rec_torch.parallel.serving import (
    distributed_topk, sharded_ranking_eval, sharded_recall_at_k,
)
from cu2rec_torch.parallel.sharded import make_mesh, pad_model
from cu2rec_torch.serve.engine import ShardedServingEngine
from cu2rec_torch.serve.recommend import padded_user_lists, ranking_eval
from cu2rec_torch.utils.config import Config

N_IP = [2, 3, 4]
RANK_TIMEOUT = 60.0


def _jax_engine(jmodel, n_ip: int, **kw):
    import jax

    from cu2rec_tpu.serve.engine import ShardedServingEngine as JEngine
    return JEngine(jmodel, devices=jax.devices()[:n_ip], **kw)


@functools.lru_cache(maxsize=None)
def _engines(name: str, n_ip: int):
    """(model, CSR, the TPU package's engine, the port's sharded engine,
    the port's one-device engine), shared by the tests of one model and
    shard count."""
    jmodel, csr = MODELS[name]()
    return (jmodel, csr, _jax_engine(jmodel, n_ip),
            port_engine(jmodel, n_ip), port_engine(jmodel))


def _fold_cfg(F: int = 4, iters: int = 50):
    return Config(total_iterations=iters, n_factors=F, learning_rate=0.05,
                  seed=42, is_train=False)


def _fold_inputs():
    rated = np.array([[0, 2, 4], [1, 3, 3], [4, 0, 0]], np.int32)
    vals = np.array([[5.0, 4.5, 5.0], [1.0, 1.5, 1.5], [2.0, 0, 0]],
                    np.float32)
    mask = np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0]], bool)
    return rated, vals, mask


def _implicit_inputs(n_items: int, B: int = 6, D: int = 5, seed: int = 1):
    rng = np.random.default_rng(seed)
    rated = rng.integers(0, n_items, (B, D)).astype(np.int32)
    vals = (rng.random((B, D)) * 3).astype(np.float32)
    mask = rng.random((B, D)) > 0.3
    mask[:, 0] = True
    return rated, vals, mask


# -- one process, a device for each shard ----------------------------------

@pytest.mark.parametrize("n_ip", N_IP)
def test_shards_hold_the_tpu_packages_blocks(n_ip):
    """Shard s holds rows [s·I_loc, (s+1)·I_loc) of the packed catalog
    padded with zero rows: the TPU package's block s, row for row."""
    for name in sorted(MODELS):
        _, _, jeng, teng, _ = _engines(name, n_ip)
        blocks = sorted(jeng.T_i.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        assert len(teng.shards) == len(blocks) == n_ip
        assert teng.I_pad == jeng.I_pad
        for (off, T), js in zip(teng.shards, blocks):
            assert off == (js.index[0].start or 0)
            np.testing.assert_array_equal(T.numpy(), np.asarray(js.data))
        assert teng.devices == [torch.device("cpu")] * n_ip


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("n_ip", N_IP)
def test_recommend_known_matches(name, n_ip):
    _, csr, jeng, teng, one = _engines(name, n_ip)
    users = list(range(csr.n_users))[::-1][:12]
    k = 3 if name == "toy" else 10
    tv, ti = teng.recommend_known(users, csr, k=k)
    jv, ji = jeng.recommend_known(users, csr, k=k)
    assert tv.shape == (len(users), k)
    assert_topk_match(tv, ti, jv, ji)
    ov, oi = one.recommend_known(users, csr, k=k)
    assert_topk_match(tv, ti, ov, oi, rtol=1e-6)
    for b, u in enumerate(users):  # rated items never come back
        rated = set(csr.indices[csr.indptr[u]:csr.indptr[u + 1]].tolist())
        assert not rated & set(ti[b][tv[b] > -1e30].tolist())


@pytest.mark.parametrize("n_ip", N_IP)
def test_chunked_scan_across_shard_boundaries(n_ip):
    """3,001 items in chunks of 700: each shard's block (1,501, 1,001 or
    751 rows) ends in a clamped chunk, and the rated items sit on both
    sides of every shard boundary."""
    from cu2rec_tpu.models.state import init_model as j_init

    jmodel = j_init(20, 3001, 8, 3.0, seed=13)
    rng = np.random.default_rng(5)
    p = np.asarray(jmodel.P)[:9]
    ub = np.asarray(jmodel.user_bias)[:9]
    rated = rng.integers(0, 3001, (9, 10)).astype(np.int32)
    rated[0] = [750, 751, 1000, 1001, 1500, 1501, 2001, 2002, 2252, 3000]
    rated[1] = [699, 700, 1400, 1401, 2100, 2101, 2253, 2800, 2801, 0]
    rmask = rng.random((9, 10)) > 0.2
    rmask[:2] = True
    tv, ti = port_engine(jmodel, n_ip, chunk_items=700).recommend(
        p, ub, rated, rmask, k=10)
    jv, ji = _jax_engine(jmodel, n_ip, chunk_items=700).recommend(
        p, ub, rated, rmask, k=10)
    assert_topk_match(tv, ti, jv, ji)
    ov, oi = port_engine(jmodel).recommend(p, ub, rated, rmask, k=10)
    assert_topk_match(tv, ti, ov, oi, rtol=1e-6)
    for b in range(9):
        assert not set(rated[b][rmask[b]].tolist()) & set(ti[b].tolist())


@pytest.mark.parametrize("n_ip", N_IP)
def test_tiny_shards_pad_their_candidates(n_ip):
    """The toy's 5 items over n_ip shards of 3, 2 or 2 rows, k = 4 above
    them: the padding rows (ids 5 and up) never come back, and a user with
    fewer unrated items than k gets the one-device engine's sentinels."""
    jmodel, csr, jeng, teng, one = _engines("toy", n_ip)
    P, ub = np.asarray(jmodel.P), np.asarray(jmodel.user_bias)
    rated = np.array([[0, 0], [1, 3], [0, 1]], np.int32)
    rmask = np.array([[False, False], [True, True], [True, True]])
    tv, ti = teng.recommend(P[:3], ub[:3], rated, rmask, k=4)
    jv, ji = jeng.recommend(P[:3], ub[:3], rated, rmask, k=4)
    ov, oi = one.recommend(P[:3], ub[:3], rated, rmask, k=4)
    assert_topk_match(tv, ti, jv, ji)
    assert_topk_match(tv, ti, ov, oi, rtol=1e-6)
    real = tv > -1e30
    assert (real.sum(axis=1) == [4, 3, 3]).all()
    assert (ti[real] < 5).all()
    # 1-D rated lists (one rated item a user), as tests/test_serve.py
    tv, ti = teng.recommend(P[:2], ub[:2], np.array([3, 1], np.int32),
                            np.array([True, True]), k=3)
    assert 3 not in ti[0] and 1 not in ti[1]


@pytest.mark.parametrize("n_ip", N_IP)
def test_fold_in_with_injected_init_matches(n_ip):
    from cu2rec_tpu.models.state import init_model as j_init

    jmodel, _, jeng, teng, one = _engines("toy", n_ip)
    cfg = _fold_cfg()
    rated, vals, mask = _fold_inputs()
    init = j_init(3, jmodel.n_items, 4, 3.0, seed=9)
    init_rows = (np.asarray(init.P), np.asarray(init.user_bias))
    tp, tb = teng.fold_in(rated, vals, mask, cfg, init_rows=init_rows)
    jp, jb = jeng.fold_in(rated, vals, mask, cfg, init_rows=init_rows)
    np.testing.assert_allclose(tp, np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(tb, np.asarray(jb), atol=1e-5)
    op, ob = one.fold_in(rated, vals, mask, cfg, init_rows=init_rows)
    np.testing.assert_allclose(tp, op, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb, ob, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_ip", N_IP)
def test_fold_in_holey_mask(n_ip):
    """fold_in([i0, GARBAGE, i2], mask=[T,F,T]) == fold_in([i0, i2],
    mask=[T,T]) over the shards, and equals the TPU package's holey
    result."""
    from cu2rec_tpu.models.state import init_model as j_init

    jmodel, _, jeng, teng, _ = _engines("toy", n_ip)
    cfg = _fold_cfg(iters=40)
    init = j_init(1, jmodel.n_items, 4, 3.0, seed=cfg.seed)
    init_rows = (np.asarray(init.P), np.asarray(init.user_bias))
    holey = (np.array([[0, 3, 4]], np.int32),
             np.array([[5.0, -77.0, 4.0]], np.float32),
             np.array([[True, False, True]]))
    th = teng.fold_in(*holey, cfg, init_rows=init_rows)
    tc = teng.fold_in(np.array([[0, 4, 1]], np.int32),
                      np.array([[5.0, 4.0, -77.0]], np.float32),
                      np.array([[True, True, False]]), cfg,
                      init_rows=init_rows)
    np.testing.assert_allclose(th[0], tc[0], atol=1e-6)
    np.testing.assert_allclose(th[1], tc[1], atol=1e-6)
    jh = jeng.fold_in(*holey, cfg, init_rows=init_rows)
    np.testing.assert_allclose(th[0], np.asarray(jh[0]), atol=1e-5)


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("n_ip", N_IP)
def test_fold_in_implicit_matches(name, n_ip):
    jmodel, _, jeng, teng, one = _engines(name, n_ip)
    rated, vals, mask = _implicit_inputs(jmodel.n_items)
    tr, tb = teng.fold_in_implicit(rated, vals, mask, alpha=5.0, reg=0.3)
    jr, _ = jeng.fold_in_implicit(rated, vals, mask, alpha=5.0, reg=0.3)
    np.testing.assert_allclose(tr, np.asarray(jr), rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(tb, np.zeros(6, np.float32))
    orows, _ = one.fold_in_implicit(rated, vals, mask, alpha=5.0, reg=0.3)
    np.testing.assert_allclose(tr, orows, rtol=1e-5, atol=1e-6)
    tv, ti = (t.numpy()[:6] for t in
              teng.fold_in_implicit_and_recommend_padded(
                  rated, vals, mask, alpha=5.0, reg=0.3, k=3))
    jv, ji = jeng.recommend(jr, np.zeros(6, np.float32), rated, mask, k=3)
    assert_topk_match(tv, ti, jv, ji, rtol=1e-3)


@pytest.mark.parametrize("n_ip", N_IP)
def test_fold_in_and_recommend_matches(n_ip):
    """The predict journey over the shards: the one-device engine's result
    (the same default initial rows and streams), the TPU package's fold-in
    from those rows then its recommend, and no rated item back."""
    jmodel, _, jeng, teng, one = _engines("toy", n_ip)
    cfg = _fold_cfg()
    rated, vals, mask = _fold_inputs()
    tv, ti = teng.fold_in_and_recommend(rated, vals, mask, cfg, k=2)
    ov, oi = one.fold_in_and_recommend(rated, vals, mask, cfg, k=2)
    assert_topk_match(tv, ti, ov, oi, rtol=1e-6)
    T0 = teng._default_init(8, prng_key(cfg.seed)).numpy()[:3]
    jp, jb = jeng.fold_in(rated, vals, mask, cfg,
                          init_rows=(T0[:, :4], T0[:, 4]))
    jv, ji = jeng.recommend(np.asarray(jp), np.asarray(jb), rated, mask, k=2)
    assert_topk_match(tv, ti, jv, ji)
    for b in range(3):
        assert not set(rated[b][mask[b]].tolist()) & set(ti[b].tolist())


@pytest.mark.parametrize("mode", ["sgd", "implicit"])
def test_foldin_ranking_eval_takes_the_sharded_engine(mode):
    """``foldin_ranking_eval`` over 3 item shards gives the one-device
    engine's metrics (the same fold-ins and recommends)."""
    from cu2rec_torch.serve.recommend import foldin_ranking_eval

    jmodel, _, _, teng, one = _engines("planted", 3)
    _, train, test = _eval_data()
    got, want = (foldin_ranking_eval(e, train, test, _fold_cfg(F=16),
                                     mode=mode, alpha=5.0)
                 for e in (teng, one))
    assert got["n_users"] == want["n_users"] > 0
    for m in ("recall", "ndcg"):
        assert abs(got[m] - want[m]) < 1e-6, m


def test_sharded_ranking_eval_in_a_world_of_one_is_ranking_eval():
    tables, train, test = _eval_data()
    model = model_from_numpy(tables, "cpu")
    mesh = make_mesh(1, 1, "cpu")
    got = sharded_ranking_eval(mesh, model, train, test, k=10,
                               batch_size=16)
    assert got == ranking_eval(model, train, test, k=10, batch_size=16)
    assert sharded_recall_at_k(mesh, model, train, test, k=10,
                               batch_size=16) == got["recall"]


def test_engine_takes_devices_or_a_mesh():
    model = model_from_numpy(planted_arrays()[0], "cpu")
    with pytest.raises(ValueError, match="not both"):
        ShardedServingEngine(model, devices=["cpu"],
                             mesh=make_mesh(1, 1, "cpu"))
    with pytest.raises(ValueError, match="at least one"):
        ShardedServingEngine(model, devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedServingEngine(model)


# -- a rank for each shard ---------------------------------------------------

def _eval_data():
    """The planted tables, and a train / test split of their ratings
    (every third rating of a user held out), as the port's CSRs."""
    tables, (users, items, vals) = planted_arrays()
    U, I = tables["p"].shape[0], tables["q"].shape[0]
    held = np.zeros(len(users), bool)
    held[2::3] = True
    train = csr_from_arrays(users[~held], items[~held], vals[~held], U, I)
    test = csr_from_arrays(users[held], items[held], vals[held], U, I)
    return tables, train, test


def _csr_args(csr):
    return (csr.indptr, csr.indices, csr.data, csr.n_users, csr.n_items)


def _rank_job(tables, train_args, test_args):
    """One rank of the ip grid: ``distributed_topk``, the sharded ranking
    evals and the rank-mode engine (known-user recommends, the implicit
    fold-in and fold-in + recommend, the explicit fold-in)."""
    model = model_from_numpy(tables, "cpu")
    train, test = CSRRatings(*train_args), CSRRatings(*test_args)
    world = torch.distributed.get_world_size()
    mesh = make_mesh(1, world, "cpu")
    I_pad = -(-model.n_items // world) * world
    padded = pad_model(model, model.n_users, I_pad)
    users = np.arange(0, model.n_users, 3)
    rated, rmask = padded_user_lists(train, users)
    uids = torch.from_numpy(users)
    out = {"topk": [t.numpy() for t in distributed_topk(
        mesh, padded.P[uids], padded.user_bias[uids], padded.Q,
        padded.item_bias, float(model.global_bias), rated, rmask, k=10,
        n_items=model.n_items)]}
    out["eval"] = sharded_ranking_eval(mesh, model, train, test, k=10,
                                       batch_size=16)
    out["recall"] = sharded_recall_at_k(mesh, model, train, test, k=10,
                                        batch_size=16)
    eng = ShardedServingEngine(model, mesh=mesh)
    out["known"] = eng.recommend_known(users, train, k=10)
    items, vals, mask = _implicit_inputs(model.n_items)
    out["ifold"] = eng.fold_in_implicit(items, vals, mask, alpha=5.0,
                                        reg=0.1)[0]
    out["ifoldrec"] = [t.numpy()[:6] for t in
                       eng.fold_in_implicit_and_recommend_padded(
                           items, vals, mask, alpha=5.0, reg=0.1, k=5)]
    out["fold"] = eng.fold_in(items, vals + 2.0, mask, _fold_cfg(F=16))
    return out


@functools.lru_cache(maxsize=None)
def _world(world: int):
    tables, train, test = _eval_data()
    return launch(_rank_job, world, "gloo", "cpu", args=(
        tables, _csr_args(train), _csr_args(test)), timeout=RANK_TIMEOUT)


def _jax_planted(n_ip: int):
    """The TPU package on a single-process 1 × n_ip grid: its model, the
    train / test CSRs, its grid and engine."""
    from _torch_serving_util import planted

    from cu2rec_tpu.data.csr import csr_from_arrays as j_csr
    from cu2rec_tpu.parallel.sharded import make_mesh as j_mesh

    jmodel, _ = planted()
    _, train, test = _eval_data()

    def j(c):
        return j_csr(np.repeat(np.arange(c.n_users), np.diff(c.indptr)),
                     c.indices, c.data, c.n_users, c.n_items)

    return jmodel, j(train), j(test), j_mesh(1, n_ip), _jax_engine(
        jmodel, n_ip)


def _ranks_agree(ranks, key):
    """Every rank's ``key`` (an array, a tuple of them or a dict of
    numbers) is rank 0's, bit for bit."""
    def parts(x):
        if isinstance(x, dict):
            return [x[k] for k in sorted(x)]
        return list(x) if isinstance(x, (list, tuple)) else [x]

    for r in ranks[1:]:
        assert len(parts(r[key])) == len(parts(ranks[0][key]))
        for a, b in zip(parts(ranks[0][key]), parts(r[key])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_topk_and_ranking_evals_match_the_tpu_package(world):
    import jax.numpy as jnp

    from cu2rec_tpu.parallel.serving import distributed_topk as j_topk
    from cu2rec_tpu.parallel.serving import sharded_ranking_eval as j_eval
    from cu2rec_tpu.parallel.sharded import pad_model as j_pad

    ranks = _world(world)
    for key in ("topk", "eval", "recall"):
        _ranks_agree(ranks, key)
    jmodel, jtrain, jtest, mesh, _ = _jax_planted(world)
    users = np.arange(0, jmodel.n_users, 3)
    rated, rmask = padded_user_lists(jtrain, users)
    padded = j_pad(jmodel, jmodel.n_users,
                   -(-jmodel.n_items // world) * world)
    uids = jnp.asarray(users)
    jv, ji = j_topk(mesh, padded.P[uids], padded.user_bias[uids], padded.Q,
                    padded.item_bias, float(jmodel.global_bias), rated,
                    rmask, k=10, n_items=jmodel.n_items)
    tv, ti = ranks[0]["topk"]
    assert_topk_match(tv, ti, jv, ji)
    want = j_eval(mesh, jmodel, jtrain, jtest, k=10, batch_size=16)
    for m in ("recall", "ndcg"):
        assert abs(ranks[0]["eval"][m] - want[m]) < 1e-6, m
    assert ranks[0]["recall"] == ranks[0]["eval"]["recall"]


@pytest.mark.parametrize("world", [2, 4])
def test_rank_mode_engine_matches_one_process_and_the_tpu_package(world):
    ranks = _world(world)
    for key in ("known", "ifold", "ifoldrec", "fold"):
        _ranks_agree(ranks, key)
    r0 = ranks[0]
    jmodel, jtrain, _, _, jeng = _jax_planted(world)
    items, vals, mask = _implicit_inputs(jmodel.n_items)
    jr, _ = jeng.fold_in_implicit(items, vals, mask, alpha=5.0, reg=0.1)
    np.testing.assert_allclose(r0["ifold"], np.asarray(jr), rtol=1e-5,
                               atol=1e-6)
    jv, ji = jeng.fold_in_implicit_and_recommend_padded(
        items, vals, mask, alpha=5.0, reg=0.1, k=5)
    np.testing.assert_array_equal(r0["ifoldrec"][1], np.asarray(ji)[:6])
    np.testing.assert_allclose(r0["ifoldrec"][0], np.asarray(jv)[:6],
                               rtol=1e-4, atol=1e-5)
    users = np.arange(0, jmodel.n_users, 3)
    assert_topk_match(*r0["known"], *jeng.recommend_known(users, jtrain,
                                                          k=10))
    # the same engine with its shards in one process
    one = port_engine(jmodel, world)
    tr, _ = one.fold_in_implicit(items, vals, mask, alpha=5.0, reg=0.1)
    np.testing.assert_allclose(r0["ifold"], tr, rtol=1e-5, atol=1e-6)
    op, ob = one.fold_in(items, vals + 2.0, mask, _fold_cfg(F=16))
    np.testing.assert_allclose(r0["fold"][0], op, rtol=0, atol=1e-6)
    np.testing.assert_allclose(r0["fold"][1], ob, rtol=0, atol=1e-6)
    train = _eval_data()[1]
    ov, oi = one.recommend_known(users, train, k=10)
    assert_topk_match(*r0["known"], ov, oi, rtol=1e-6)
