"""The port's one-device ``ServingEngine`` against the TPU package's
``ShardedServingEngine`` on one and two (CPU) devices: known-user
recommendations (one-pass and chunked catalog scans), explicit SGD fold-in
with injected initial rows, the holey-mask compaction, and the implicit
ridge fold-in.

Tolerances: recommendation scores rtol 1e-5 (one float32 dot product of
width F plus biases; as tests/test_serve.py); fold-in rows atol 1e-5 after
50 SGD iterations (as tests/test_serve.py); implicit rows rtol 1e-3 /
atol 1e-4 (float32 Cholesky, as test_torch_ials.py).  Item ids must match
wherever the scores are not tied."""

import jax
import numpy as np
import pytest
import torch

from _torch_serving_util import MODELS, assert_topk_match
from _torch_serving_util import port_engine as _port
from _torch_serving_util import toy as _toy
from cu2rec_tpu.models.state import init_model as j_init
from cu2rec_tpu.serve.engine import ShardedServingEngine
from cu2rec_tpu.utils.config import Config


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("n_ip", [1, 2])
def test_recommend_known_matches(name, n_ip):
    jmodel, csr = MODELS[name]()
    users = list(range(csr.n_users))[::-1][:12]
    k = 3 if name == "toy" else 10
    jeng = ShardedServingEngine(jmodel, devices=jax.devices()[:n_ip])
    teng = _port(jmodel)
    jv, ji = jeng.recommend_known(users, csr, k=k)
    tv, ti = teng.recommend_known(users, csr, k=k)
    assert tv.shape == (len(users), k)
    assert_topk_match(tv, ti, jv, ji)
    for b, u in enumerate(users):  # rated items never come back
        rated = set(csr.indices[csr.indptr[u]:csr.indptr[u + 1]].tolist())
        assert not rated & set(ti[b][tv[b] > -1e30].tolist())


@pytest.mark.parametrize("chunk", [None, 700])
def test_recommend_chunked_catalog_matches(chunk):
    """A catalog under one chunk, and one scanned in 5 chunks of 700 (the
    last clamped to overlap its predecessor) with rated-item masking that
    straddles chunks."""
    jmodel = j_init(20, 3001, 8, 3.0, seed=13)
    rng = np.random.default_rng(5)
    p = np.asarray(jmodel.P)[:9]
    ub = np.asarray(jmodel.user_bias)[:9]
    rated = rng.integers(0, 3001, (9, 7)).astype(np.int32)
    rated[0] = [2099, 2100, 2101, 2800, 2801, 3000, 0]
    rmask = rng.random((9, 7)) > 0.3
    jeng = ShardedServingEngine(jmodel, devices=jax.devices()[:1],
                                chunk_items=chunk)
    teng = _port(jmodel, chunk_items=chunk)
    jv, ji = jeng.recommend(p, ub, rated, rmask, k=10)
    tv, ti = teng.recommend(p, ub, rated, rmask, k=10)
    assert_topk_match(tv, ti, jv, ji)
    # the port's chunked scan equals its own one-pass scan
    ov, oi = _port(jmodel).recommend(p, ub, rated, rmask, k=10)
    np.testing.assert_array_equal(ti, oi)
    np.testing.assert_array_equal(tv, ov)


def test_recommend_1d_rated_and_exhausted_catalog():
    jmodel, csr = _toy()
    teng = _port(jmodel)
    users = np.array([0, 1])
    v, i = teng.recommend(np.asarray(jmodel.P)[users],
                          np.asarray(jmodel.user_bias)[users],
                          np.array([3, 1], np.int32), np.array([True, True]),
                          k=3)
    assert v.shape == (2, 3) and 3 not in i[0] and 1 not in i[1]
    # user 0 rated 4 of 5 items: k=3 leaves 2 sentinel slots
    v, i = teng.recommend_known([0], csr, k=3)
    assert (v[0] > -1e30).sum() == 1


def _fold_cfg():
    return Config(total_iterations=50, n_factors=4, learning_rate=0.05,
                  seed=42, is_train=False)


@pytest.mark.parametrize("n_ip", [1, 2])
def test_fold_in_matches_with_injected_init(n_ip):
    jmodel, _ = _toy()
    cfg = _fold_cfg()
    rated = np.array([[0, 2, 4], [1, 3, 3], [4, 0, 0]], np.int32)
    vals = np.array([[5.0, 4.5, 5.0], [1.0, 1.5, 1.5], [2.0, 0, 0]],
                    np.float32)
    mask = np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0]], bool)
    init = j_init(3, jmodel.n_items, 4, 3.0, seed=9)
    init_rows = (np.asarray(init.P), np.asarray(init.user_bias))
    jeng = ShardedServingEngine(jmodel, devices=jax.devices()[:n_ip])
    jp, jb = jeng.fold_in(rated, vals, mask, cfg, init_rows=init_rows)
    tp, tb = _port(jmodel).fold_in(rated, vals, mask, cfg,
                                   init_rows=init_rows)
    np.testing.assert_allclose(tp, np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(tb, np.asarray(jb), atol=1e-5)


def test_fold_in_holey_mask():
    """fold_in([i0, GARBAGE, i2], mask=[T,F,T]) == fold_in([i0, i2],
    mask=[T,T]) in the port, and equals the TPU package's holey result."""
    jmodel, _ = _toy()
    cfg = _fold_cfg().replace(total_iterations=40)
    init = j_init(1, jmodel.n_items, 4, 3.0, seed=cfg.seed)
    init_rows = (np.asarray(init.P), np.asarray(init.user_bias))
    teng = _port(jmodel)
    holey = teng.fold_in(np.array([[0, 3, 4]], np.int32),
                         np.array([[5.0, -77.0, 4.0]], np.float32),
                         np.array([[True, False, True]]), cfg,
                         init_rows=init_rows)
    compact = teng.fold_in(np.array([[0, 4, 1]], np.int32),
                           np.array([[5.0, 4.0, -77.0]], np.float32),
                           np.array([[True, True, False]]), cfg,
                           init_rows=init_rows)
    np.testing.assert_allclose(holey[0], compact[0], atol=1e-6)
    np.testing.assert_allclose(holey[1], compact[1], atol=1e-6)
    jeng = ShardedServingEngine(jmodel, devices=jax.devices()[:2])
    jh = jeng.fold_in(np.array([[0, 3, 4]], np.int32),
                      np.array([[5.0, -77.0, 4.0]], np.float32),
                      np.array([[True, False, True]]), cfg,
                      init_rows=init_rows)
    np.testing.assert_allclose(holey[0], np.asarray(jh[0]), atol=1e-5)


def test_fold_in_default_init_is_seeded_and_batch_independent():
    """The default init (a torch.Generator, so it cannot match the TPU
    package's threefry draw) is deterministic for a seed, and a batch of
    one reproduces row 0 of a larger batch."""
    jmodel, _ = _toy()
    teng = _port(jmodel)
    cfg = _fold_cfg()
    rated = np.array([[0, 2], [1, 3]] * 9, np.int32)
    vals = np.full((18, 2), 4.0, np.float32)
    mask = np.ones((18, 2), bool)
    a = teng.fold_in(rated, vals, mask, cfg)
    b = teng.fold_in(rated, vals, mask, cfg)
    np.testing.assert_array_equal(a[0], b[0])
    one = teng.fold_in(rated[:1], vals[:1], mask[:1], cfg)
    np.testing.assert_allclose(one[0][0], a[0][0], atol=1e-6)
    c = teng.fold_in(rated, vals, mask, cfg.replace(seed=7))
    assert not np.array_equal(a[0], c[0])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fold_in_implicit_matches(name):
    jmodel, _ = MODELS[name]()
    rng = np.random.default_rng(1)
    I = jmodel.n_items
    rated = rng.integers(0, I, (6, 5)).astype(np.int32)
    vals = (rng.random((6, 5)) * 3).astype(np.float32)
    mask = rng.random((6, 5)) > 0.3
    mask[:, 0] = True
    jeng = ShardedServingEngine(jmodel, devices=jax.devices()[:1])
    jr, jb = jeng.fold_in_implicit(rated, vals, mask, alpha=5.0, reg=0.3)
    teng = _port(jmodel)
    tr, tb = teng.fold_in_implicit(rated, vals, mask, alpha=5.0, reg=0.3)
    np.testing.assert_allclose(tr, np.asarray(jr), rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(tb, np.zeros(6, np.float32))
    # and through the recommend that follows it on the serving path
    tv, ti = (x[:6] for x in map(
        lambda t: t.numpy(), teng.fold_in_implicit_and_recommend_padded(
            rated, vals, mask, alpha=5.0, reg=0.3, k=3)))
    jv, ji = jeng.recommend(jr, jb, rated, mask, k=3)
    assert_topk_match(tv, ti, jv, ji, rtol=1e-3)


def test_programs_record_padded_signatures_once():
    jmodel, csr = _toy()
    teng = _port(jmodel)
    teng.recommend_known([0, 1, 2], csr, k=2)
    teng.recommend_known([3, 4], csr, k=2)      # same (8, 8, 2) signature
    assert [k for k in teng._programs if k[0] == "rec"] == [
        ("rec", 8, 8, 2, None)]
    teng.fold_in_implicit(np.array([[0]]), np.array([[1.0]]),
                          np.array([[True]]))
    assert ("igram",) in teng._programs and ("ifold", 8, 8) in \
        teng._programs
    assert isinstance(teng._programs[("igram",)], torch.Tensor)
    assert teng.bench_qps(batch_size=8, k=2, n_batches=2) > 0
