"""The explicit serving fold-in's plain version (``serve/engine.py::
fold_in_steps``, the oracle of kernel K0c) and the engine around it, on
the CPU.

- ``fold_in_steps`` over the catalog block with item ids (one shard) and
  over the (Bp·Dp, W) float32 rows assembled once (several shards) gives
  the same bits, for float32 and bf16 catalogs: a bf16 row read as float32
  is the row the assembly writes;
- ``fold_in_steps`` on the request's masked arrays as they arrive (holes,
  empty slots, all-true rows; Dp of 1, 8, 33, 100) gives the same bits as
  on the form the TPU package compacts on the host (a stable argsort of
  the mask, valid entries front-packed);
- the engine's fold-in on 1 and 2 shards against the TPU package's on
  masks with holes, empty rows and full rows, a width past 32 columns;
- the engine's request staging (one buffer: ids, ratings, mask, padding
  masked out) and the default init it stages: a batch of one gives row 0
  of a big batch's init, bit for bit, through the whole path;
- the engine's fold-in on 1 and 2 item shards against the TPU package's
  ``ShardedServingEngine.fold_in`` with injected initial rows, atol 1e-5
  after 50 iterations (as tests/test_serve.py), a user with no ratings
  among them;
- slots with no ratings come back unchanged, bit for bit;
- over several shards the engine assembles the rows once a fold-in
  (``_rows`` is called once, whatever the iterations);
- a rated item id outside the catalog raises before any launch (masked
  entries may hold anything);
- ``fold_in_cuda`` takes CUDA tensors only.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_serving_util import planted, planted_arrays, port_engine
from cu2rec_torch.models.state import model_from_numpy
from cu2rec_torch.ops.cuda_foldin import fold_in_cuda
from cu2rec_torch.ops.packed import pack
from cu2rec_torch.ops.sgd import Hyper, prng_key
from cu2rec_torch.serve.engine import (ShardedServingEngine,
                                       compact_ratings, fold_in_steps)
from cu2rec_torch.utils.config import Config

HP = Hyper(0.05, 0.02, 0.02, 0.03, 0.02)
F = 16


def _catalog(dtype):
    """The planted F=16 catalog's packed (I, W) block in ``dtype``."""
    tables, _ = planted_arrays()
    return pack(model_from_numpy(tables, "cpu")).T_i.to(dtype)


def _batch(n_items, Bp=16, Dp=8, seed=3):
    """(T_u, item ids, ratings, mask) of a padded batch, two slots empty
    and the others holding 1..Dp front-packed ratings."""
    rng = np.random.default_rng(seed)
    W = 64
    T_u = np.zeros((Bp, W), np.float32)
    T_u[:, :F + 1] = rng.normal(0, 0.1, (Bp, F + 1))
    items = rng.integers(0, n_items, (Bp, Dp)).astype(np.int32)
    vals = rng.integers(1, 11, (Bp, Dp)).astype(np.float32) / 2
    lens = rng.integers(1, Dp + 1, Bp)
    lens[[2, 9]] = 0
    lens[0] = 1
    mask = np.arange(Dp)[None, :] < lens[:, None]
    return (torch.from_numpy(T_u), torch.from_numpy(items),
            torch.from_numpy(vals), torch.from_numpy(mask))


def _holey(n_items, Bp, Dp, seed):
    """(T_u, item ids, ratings, mask) in a request's own column order:
    holes everywhere, slot 1 full, slots 2 and 5 empty, and ids past the
    catalog wherever the mask is off."""
    T_u, items, vals, _ = _batch(n_items, Bp, Dp, seed)
    rng = np.random.default_rng(seed + 1)
    mask = rng.random((Bp, Dp)) < 0.55
    mask[1] = True
    mask[[2, 5]] = False
    items = torch.where(torch.from_numpy(mask), items, 10 ** 7)
    return T_u, items, vals, torch.from_numpy(mask)


def _host_compacted(items, vals, mask):
    """The TPU package's host compaction (``fold_in_padded``): each row's
    valid entries to the front by a stable argsort of the mask, the mask
    then front-packed."""
    m = mask.numpy()
    order = np.argsort(~m, axis=1, kind="stable")
    lens = m.sum(axis=1)
    return (torch.from_numpy(np.take_along_axis(items.numpy(), order, 1)),
            torch.from_numpy(np.take_along_axis(vals.numpy(), order, 1)),
            torch.from_numpy(np.arange(m.shape[1])[None, :]
                             < lens[:, None]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_steps", [1, 37])
def test_direct_and_assembled_sources_give_the_same_bits(dtype, n_steps):
    T_i = _catalog(dtype)
    T_u, items, vals, mask = _batch(T_i.shape[0])
    Bp, Dp = items.shape
    key = prng_key(42)
    direct = fold_in_steps(T_u, T_i, items, vals, mask, 3.5, HP, key,
                           n_steps, F)
    rows = T_i[items.reshape(-1).long()].to(torch.float32)
    index = torch.arange(Bp * Dp, dtype=torch.int32).reshape(Bp, Dp)
    assembled = fold_in_steps(T_u, rows, index, vals, mask, 3.5, HP, key,
                              n_steps, F)
    assert torch.equal(direct, assembled)
    assert not torch.equal(direct, T_u)
    assert torch.isfinite(direct).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slots_with_no_ratings_are_unchanged(dtype):
    T_i = _catalog(dtype)
    T_u, items, vals, mask = _batch(T_i.shape[0])
    out = fold_in_steps(T_u, T_i, items, vals, mask, 3.5, HP, prng_key(7),
                        20, F)
    empty = ~mask.any(dim=1)
    assert torch.equal(out[empty], T_u[empty])
    assert not torch.equal(out[~empty], T_u[~empty])
    # The padding columns past the bias never move.
    assert torch.equal(out[:, F + 1:], T_u[:, F + 1:])


@pytest.mark.parametrize("n_ip", [1, 2])
def test_engine_fold_in_matches_the_tpu_package(n_ip):
    from cu2rec_tpu.serve.engine import ShardedServingEngine as JEngine
    from cu2rec_tpu.utils.config import Config as JConfig

    jmodel, _ = planted()
    jeng = JEngine(jmodel, devices=jax.devices()[:n_ip])
    teng = port_engine(jmodel, n_ip)
    assert teng.n_ip == n_ip
    rng = np.random.default_rng(5)
    B, D = 11, 12
    rated = rng.integers(0, jmodel.n_items, (B, D)).astype(np.int32)
    vals = rng.integers(1, 11, (B, D)).astype(np.float32) / 2
    mask = rng.random((B, D)) > 0.4
    mask[4] = False                      # a user with no ratings
    init = (rng.normal(0, 0.1, (B, F)).astype(np.float32),
            rng.normal(0, 0.1, B).astype(np.float32))
    kw = dict(total_iterations=50, n_factors=F, learning_rate=0.05,
              seed=42, is_train=False)
    tp, tb = teng.fold_in(rated, vals, mask, Config(**kw), init_rows=init)
    jp, jb = jeng.fold_in(rated, vals, mask, JConfig(**kw), init_rows=init)
    np.testing.assert_allclose(tp, np.asarray(jp), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb, np.asarray(jb), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tp[4], init[0][4])
    assert tb[4] == init[1][4]


@pytest.mark.parametrize("n_steps", [1, 30])
def test_sharded_engine_assembles_the_rows_once_a_fold_in(monkeypatch,
                                                          n_steps):
    tables, _ = planted_arrays()
    eng = ShardedServingEngine(model_from_numpy(tables, "cpu"),
                               devices=["cpu"] * 2)
    calls = []
    rows = eng._rows
    monkeypatch.setattr(eng, "_rows", lambda ids, F=None: calls.append(
        tuple(ids.shape)) or rows(ids, F))
    rng = np.random.default_rng(1)
    rated = rng.integers(0, tables["q"].shape[0], (5, 6)).astype(np.int32)
    vals = np.full((5, 6), 3.0, np.float32)
    cfg = Config(total_iterations=n_steps, n_factors=F, is_train=False)
    eng.fold_in(rated, vals, np.ones((5, 6), bool), cfg)
    assert calls == [(8, 8)]             # (Bp, Dp), once


@pytest.mark.parametrize("n_ip", [1, 2])
@pytest.mark.parametrize("bad", [-1, 10**6])
def test_engine_fold_in_rejects_item_ids_outside_the_catalog(n_ip, bad):
    tables, _ = planted_arrays()
    eng = ShardedServingEngine(model_from_numpy(tables, "cpu"),
                               devices=["cpu"] * n_ip)
    rated = np.zeros((3, 4), np.int32)
    vals = np.full((3, 4), 3.0, np.float32)
    mask = np.ones((3, 4), bool)
    cfg = Config(total_iterations=5, n_factors=F, is_train=False)
    rated[1, 2] = bad
    mask[1, 2] = False                   # a masked entry may hold anything
    eng.fold_in(rated, vals, mask, cfg)
    mask[1, 2] = True
    with pytest.raises(ValueError, match="item ids must lie in"):
        eng.fold_in(rated, vals, mask, cfg)


def test_fold_in_cuda_takes_cuda_tensors_only():
    T_i = _catalog(torch.float32)
    T_u, items, vals, mask = _batch(T_i.shape[0])
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fold_in_cuda(T_u, T_i, items, vals, mask, 3.5, HP, prng_key(1), 5,
                     F)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dp", [1, 8, 33, 100])
def test_holey_masks_give_the_host_compacted_bits(dtype, Dp):
    T_i = _catalog(dtype)
    T_u, items, vals, mask = _holey(T_i.shape[0], 24, Dp, seed=Dp)
    assert (~mask.any(dim=1)).sum() >= 2 and bool(mask[1].all())
    key = prng_key(11)
    holey = fold_in_steps(T_u, T_i, items, vals, mask, 3.5, HP, key, 30, F)
    packed = fold_in_steps(T_u, T_i, *_host_compacted(items, vals, mask),
                           3.5, HP, key, 30, F)
    assert torch.equal(holey, packed)
    empty = ~mask.any(dim=1)
    assert torch.equal(holey[empty], T_u[empty])
    assert not torch.equal(holey[~empty], T_u[~empty])


def test_compact_ratings_is_the_stable_host_compaction():
    _, items, vals, mask = _holey(300, 12, 33, seed=4)
    got_i, got_v, lens = compact_ratings(items, vals, mask)
    want_i, want_v, want_m = _host_compacted(items, vals, mask)
    assert torch.equal(lens, mask.sum(dim=1))
    for b in range(12):
        n = int(lens[b])
        assert torch.equal(got_i[b, :n], want_i[b, :n])
        assert torch.equal(got_v[b, :n], want_v[b, :n])
        assert bool(want_m[b, :n].all()) and not bool(want_m[b, n:].any())


@pytest.mark.parametrize("n_ip", [1, 2])
@pytest.mark.parametrize("D", [5, 33])
def test_engine_fold_in_on_holey_masks_matches_the_tpu_package(n_ip, D):
    from cu2rec_tpu.serve.engine import ShardedServingEngine as JEngine
    from cu2rec_tpu.utils.config import Config as JConfig

    jmodel, _ = planted()
    jeng = JEngine(jmodel, devices=jax.devices()[:n_ip])
    teng = port_engine(jmodel, n_ip)
    rng = np.random.default_rng(D + n_ip)
    B = 6
    rated = rng.integers(0, jmodel.n_items, (B, D)).astype(np.int32)
    vals = rng.integers(1, 11, (B, D)).astype(np.float32) / 2
    mask = rng.random((B, D)) < 0.5
    mask[0] = True                       # every column
    mask[2] = False                      # no ratings
    mask[3] = False
    mask[3, D - 1] = True                # one, in the last column
    rated[~mask] = -5                    # masked entries may hold anything
    init = (rng.normal(0, 0.1, (B, F)).astype(np.float32),
            rng.normal(0, 0.1, B).astype(np.float32))
    kw = dict(total_iterations=40, n_factors=F, learning_rate=0.05,
              seed=3, is_train=False)
    tp, tb = teng.fold_in(rated, vals, mask, Config(**kw), init_rows=init)
    jp, jb = jeng.fold_in(rated, vals, mask, JConfig(**kw), init_rows=init)
    np.testing.assert_allclose(tp, np.asarray(jp), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb, np.asarray(jb), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tp[2], init[0][2])
    assert not np.array_equal(tp[3], init[0][3])


def test_engine_stages_the_request_as_it_arrives():
    tables, _ = planted_arrays()
    eng = ShardedServingEngine(model_from_numpy(tables, "cpu"),
                               devices=["cpu"])
    rng = np.random.default_rng(2)
    rated = rng.integers(0, 300, (5, 6)).astype(np.int64)
    vals = rng.random((5, 6)).astype(np.float32)
    mask = rng.random((5, 6)) < 0.5
    items, ratings, valid = eng._upload(
        eng._pack_request(rated, vals, mask, 8, 8), 8, 8)
    assert (items.dtype, ratings.dtype, valid.dtype) == (
        torch.int32, torch.float32, torch.bool)
    np.testing.assert_array_equal(items[:5, :6].numpy(), rated)
    np.testing.assert_array_equal(ratings[:5, :6].numpy(), vals)
    np.testing.assert_array_equal(valid[:5, :6].numpy(), mask)
    for t in (items, ratings, valid):
        assert not t[5:].any() and not t[:, 6:].any()


def test_default_init_of_a_batch_of_one_is_row_0_of_a_big_batch():
    tables, _ = planted_arrays()
    eng = ShardedServingEngine(model_from_numpy(tables, "cpu"),
                               devices=["cpu"])
    key = prng_key(9)
    big, one = eng._default_init(64, key), eng._default_init(8, key)
    assert big.dtype == torch.float32 and big.shape == (64, 64)
    assert torch.equal(one[0], big[0])
    assert not big[:, F + 1:].any()
    rated = np.arange(40, dtype=np.int32).reshape(20, 2)
    vals = np.full((20, 2), 4.0, np.float32)
    cfg = Config(total_iterations=0, n_factors=F, seed=9, is_train=False)
    p20, b20 = eng.fold_in(rated, vals, np.ones((20, 2), bool), cfg)
    p1, b1 = eng.fold_in(rated[:1], vals[:1], np.ones((1, 2), bool), cfg)
    np.testing.assert_array_equal(p1[0], p20[0])
    assert b1[0] == b20[0]
    np.testing.assert_array_equal(p20, big[:20, :F].numpy())


def test_each_fold_in_batch_draws_its_own_initial_rows(monkeypatch):
    tables, _ = planted_arrays()
    eng = ShardedServingEngine(model_from_numpy(tables, "cpu"),
                               devices=["cpu"])
    draws = []
    default_init = eng._default_init
    monkeypatch.setattr(eng, "_default_init", lambda Bp, key: draws.append(
        (Bp, key)) or default_init(Bp, key))
    rated = np.arange(12, dtype=np.int32).reshape(6, 2)
    vals = np.full((6, 2), 4.0, np.float32)
    mask = np.ones((6, 2), bool)
    cfg = Config(total_iterations=10, n_factors=F, seed=3, is_train=False)
    a = eng.fold_in(rated, vals, mask, cfg)
    b = eng.fold_in(rated, vals, mask, cfg)
    np.testing.assert_array_equal(a[0], b[0])
    assert draws == [(8, prng_key(3))] * 2
    zero = eng.fold_in(rated, vals, mask, cfg.replace(total_iterations=0))
    eng.fold_in_padded(rated, vals, mask,
                       cfg.replace(total_iterations=0)).add_(1.0)
    np.testing.assert_array_equal(
        eng.fold_in(rated, vals, mask, cfg.replace(total_iterations=0))[0],
        zero[0])                  # a returned table is the caller's own
