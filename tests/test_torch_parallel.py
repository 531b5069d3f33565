"""The PyTorch port's multi-device training on the CPU: gloo ranks on a
(dp × ip) grid against the TPU package's sharded engines on its 8 virtual
CPU devices (conftest), and against the port's one-device engines.

Every grid size is one ``launch`` of ranks that runs all of its cases
(``_world``, cached), each rank under a 60 s limit.  The module imports no
JAX at its top, so that the ranks, which import it to find their job,
import only the port.

Tolerances (the TPU package's own tests of its sharded engine): sampled
items and election winners bit-equal; tables within 1e-6 under first_wins
and twin, 1e-5 under mean and sum; the eval within rtol 1e-5.  Row-sharded
ALS and iALS within ``test_torch_als.py``'s rtol 1e-4 / atol 1e-5; BPR's
ids bit-equal and its tables within 1e-6.
"""

import functools

import numpy as np
import pytest
import torch

from cu2rec_torch.data.csr import CSRRatings, csr_from_arrays, to_device
from cu2rec_torch.models.state import model_from_numpy, model_to_numpy
from cu2rec_torch.ops.sgd import Hyper, prng_key, sample_items
from cu2rec_torch.parallel.distributed import launch
from cu2rec_torch.parallel.sharded import (
    Mesh, ShardedEngine, elect_local, make_mesh, pad_model,
    shard_ratings, shard_ratings_item_major, trim_model,
)
from cu2rec_torch.utils.config import Config
from cu2rec_torch.utils.metrics import MetricsLogger

POLICIES = ("first_wins", "twin", "mean", "sum")
ATOL = {"first_wins": 1e-6, "twin": 1e-6, "mean": 1e-5, "sum": 1e-5}
EVAL_RTOL = 1e-5
FAM_RTOL, FAM_ATOL = 1e-4, 1e-5
GRIDS = {2: [(2, 1)], 4: [(4, 1), (2, 2), (1, 4)]}
FAMILY_GRID = {2: (2, 1), 4: (2, 2)}
STEPS = 10
GB = 3.5556
SMALL_CAPS = (2, 4, 8)
RANK_TIMEOUT = 60.0


def _hp():
    return Hyper(*(float(np.float32(v)) for v in (0.05, 0.1, 0.1, 0.1, 0.1)))


def _cfg(policy, **kw):
    return Config(total_iterations=10, n_factors=4, learning_rate=0.05,
                  check_error=5, P_reg=0.1, Q_reg=0.1, user_bias_reg=0.1,
                  item_bias_reg=0.1, collision_policy=policy, **kw)


def _args(csr):
    return (np.asarray(csr.indptr), np.asarray(csr.indices),
            np.asarray(csr.data), csr.n_users, csr.n_items)


def _family_data():
    """60 users x 25 items, about 600 ratings, split 85/15 (port CSRs)."""
    rng = np.random.default_rng(11)
    n = 700
    u = rng.integers(0, 60, n)
    i = np.minimum((25 * rng.power(0.4, n)).astype(np.int64), 24)
    r = (rng.integers(1, 11, n) / 2.0).astype(np.float32)
    key = np.unique(u * 25 + i, return_index=True)[1]
    u, i, r = u[key], i[key], r[key]
    cut = np.random.default_rng(0).random(len(u)) < 0.85
    return tuple(csr_from_arrays(u[s], i[s], r[s], 60, 25, use_native=False)
                 for s in (cut, ~cut))


def _family_cfg(**kw):
    base = dict(n_factors=4, seed=7, P_reg=0.1, Q_reg=0.1,
                user_bias_reg=0.1, item_bias_reg=0.1)
    base.update(kw)
    return Config(**base)


# -- the ranks' job --------------------------------------------------------

def _engine_cases(mesh, csr, small, model_d):
    """Each policy's run, the sampling and election at two iterations, the
    eval of a smaller test split, and the twin guard on one grid."""
    model = model_from_numpy(model_d, "cpu")
    res = {"rank": mesh.rank}
    for policy in POLICIES:
        eng = ShardedEngine(csr, csr, _cfg(policy), mesh=mesh)
        st = eng.run(eng.prepare(model), _hp(), 0, STEPS)
        res[policy] = (model_to_numpy(eng.finalize(st)),
                       eng.evaluate(st, "train"))
    eng = ShardedEngine(csr, small, _cfg("first_wins"), mesh=mesh)
    d = eng.train_dev
    res["draws"] = {}
    for it in (0, 3):
        items, _r, has = sample_items(eng.key, it, d.indptr, d.indices,
                                      d.data, user_offset=eng.user_offset)
        best, _cand = elect_local(items, has, mesh, eng.I_loc, eng.n_users,
                                  it)
        res["draws"][it] = (items.numpy(), has.numpy(), best.numpy())
    res["blocks"] = (eng.user_offset, eng.U_loc, eng.item_offset, eng.I_loc)
    res["small_eval"] = eng.evaluate(eng.prepare(model), "test")
    cfg = _cfg("first_wins")
    eng = ShardedEngine(csr, csr, cfg, mesh=mesh)
    cfg.collision_policy = "twin"
    try:
        eng.run(eng.prepare(model), _hp(), 0, 2)
        res["guard"] = None
    except ValueError as e:
        res["guard"] = str(e)
    return res


def _family_cases(mesh, train, test, model_d):
    """ALS and iALS (trainers and half sweeps with heavy rows, host and
    device chunks) and BPR (its ids and its training) on one grid."""
    from cu2rec_torch.ops.als import (
        als_half_sweep, bucket_csr, prepare_chunks, prepare_chunks_device,
    )
    from cu2rec_torch.ops.ials import ials_half_sweep
    from cu2rec_torch.ops.packed import pack
    from cu2rec_torch.parallel.bpr import ShardedBPR
    from cu2rec_torch.train.als import train_als
    from cu2rec_torch.train.bpr import train_bpr
    from cu2rec_torch.train.ials import train_ials

    quiet = MetricsLogger(verbose=False)
    out = {"rank": mesh.rank}
    model = model_from_numpy(model_d, "cpu")
    for buckets in (False, True):
        m, losses = train_als(train, test, _family_cfg(total_iterations=2),
                              3.0, model=model, logger=quiet, mesh=mesh,
                              device_buckets=buckets)
        out["als", buckets] = (model_to_numpy(m), losses)
    m, losses = train_ials(train, test, _family_cfg(total_iterations=2),
                           alpha=5.0, model=model, logger=quiet, mesh=mesh,
                           device_buckets=False)
    out["ials"] = (model_to_numpy(m), losses)
    pm = pack(model)
    host = bucket_csr(train.indptr, train.indices, train.data, SMALL_CAPS)
    dev = to_device(train, "cpu")
    for name, chunks in (
            ("host", prepare_chunks(host, 4, train.n_users, mesh)),
            ("device", prepare_chunks_device(
                dev.indices, dev.data, train.indptr, 4, train.n_users,
                train.nnz, caps=SMALL_CAPS, row_sharding=mesh))):
        out["sweep", name] = (
            als_half_sweep(pm.T_u, pm.T_i, chunks, 3.0, 0.05, 0.02, 4,
                           row_sharding=mesh).numpy(),
            ials_half_sweep(model.P, model.Q, chunks, 5.0, 0.1,
                            row_sharding=mesh).numpy(),
            len(chunks))
    cfg = _family_cfg(total_iterations=30, check_error=15,
                      learning_rate=0.1)
    eng = ShardedBPR(train, cfg, mesh=mesh, model=model)
    out["bpr_draws"] = {it: [t.numpy() for t in
                             eng.draws(prng_key(cfg.seed), it)]
                        for it in (0, 7)}
    out["bpr_blocks"] = (mesh.dp_index * eng.U_loc, eng.U_loc,
                         mesh.ip_index * eng.I_loc, eng.I_loc)
    m, losses = train_bpr(train, test, cfg, model=model, logger=quiet,
                          mesh=mesh)
    out["bpr"] = (model_to_numpy(m), losses)
    return out


def _world_job(grids, family_grid, toy, small, model_d, fam, fam_model_d):
    """Every case of one world size, in each rank."""
    toy, small = CSRRatings(*toy), CSRRatings(*small)
    out = {grid: _engine_cases(make_mesh(*grid, "cpu"), toy, small, model_d)
           for grid in grids}
    train, test = (CSRRatings(*a) for a in fam)
    out["families"] = _family_cases(make_mesh(*family_grid, "cpu"), train,
                                    test, fam_model_d)
    return out


# -- the parent's side -----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _inputs():
    """(toy CSR, smaller test split, initial model, family CSRs, family
    model), all port objects built from the TPU package's fixtures."""
    import pathlib

    from cu2rec_tpu.data import build_csr, read_ratings_csv
    from cu2rec_tpu.models.state import init_model
    from cu2rec_tpu.models.state import model_to_numpy as j_to_numpy

    path = pathlib.Path(__file__).parent / "data" / "test_ratings.csv"
    toy = build_csr(read_ratings_csv(str(path)))
    toy = CSRRatings(np.asarray(toy.indptr), np.asarray(toy.indices),
                     np.asarray(toy.data), toy.n_users, toy.n_items)
    hi = int(toy.indptr[3])
    small = CSRRatings(toy.indptr[:4], toy.indices[:hi], toy.data[:hi], 3,
                       toy.n_items)
    model_d = j_to_numpy(init_model(toy.n_users, toy.n_items, 4, GB,
                                    seed=42))
    fam = _family_data()
    fam_model_d = j_to_numpy(init_model(60, 25, 4, 3.0, seed=7))
    return toy, small, model_d, fam, fam_model_d


@functools.lru_cache(maxsize=None)
def _world(world: int):
    """The results of every rank of one launch of ``world`` gloo ranks."""
    toy, small, model_d, fam, fam_model_d = _inputs()
    return launch(_world_job, world, "gloo", "cpu", args=(
        GRIDS[world], FAMILY_GRID[world], _args(toy), _args(small), model_d,
        tuple(_args(c) for c in fam), fam_model_d), timeout=RANK_TIMEOUT)


def _world_of(grid):
    return 2 if grid == (2, 1) else 4


def _jax_csr(csr):
    from cu2rec_tpu.data.csr import CSRRatings as JCSR
    return JCSR(indptr=csr.indptr, indices=csr.indices, data=csr.data,
                n_users=csr.n_users, n_items=csr.n_items)


@functools.lru_cache(maxsize=None)
def _jax_engine(grid, policy):
    """The TPU package's ShardedEngine on the same grid: (components,
    train eval)."""
    import jax.numpy as jnp

    from cu2rec_tpu.models.state import model_to_numpy as j_to_numpy
    from cu2rec_tpu.ops.sgd import Hyper as JHyper
    from cu2rec_tpu.parallel.sharded import ShardedEngine as JEngine
    from cu2rec_tpu.parallel.sharded import make_mesh as j_mesh
    from cu2rec_tpu.models.state import init_model

    toy, _small, _m, _f, _fm = _inputs()
    jcsr = _jax_csr(toy)
    hp = JHyper(*(jnp.float32(v) for v in (0.05, 0.1, 0.1, 0.1, 0.1)))
    eng = JEngine(jcsr, jcsr, _cfg(policy), mesh=j_mesh(*grid))
    st = eng.run(init_model(toy.n_users, toy.n_items, 4, GB, seed=42), hp,
                 0, STEPS)
    return j_to_numpy(eng.finalize(st)), eng.evaluate(st, "train")


@functools.lru_cache(maxsize=None)
def _one_device(policy):
    """The port's one-device engine on the CPU: (components, train
    eval)."""
    from cu2rec_torch.train.trainer import SingleChipEngine

    toy, _small, model_d, _f, _fm = _inputs()
    eng = SingleChipEngine(toy, toy, _cfg(policy), device="cpu")
    st = eng.run(eng.prepare(model_from_numpy(model_d, "cpu")), _hp(), 0,
                 STEPS)
    return model_to_numpy(eng.finalize(st)), eng.evaluate(st, "train")


def _close(a: dict, b: dict, atol: float) -> None:
    for k in ("p", "q", "user_bias", "item_bias", "global_bias"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol, err_msg=k)


ALL_GRIDS = [(2, 1), (4, 1), (2, 2), (1, 4)]


# -- in-process ------------------------------------------------------------

def test_mesh_layout_is_the_tpu_packages():
    """Rank d·n_ip + i holds grid cell (d, i), as ``devices.reshape(n_dp,
    n_ip)`` lays the TPU package's mesh out; a grid of one needs no
    world, and a grid of more ranks than the world raises."""
    from cu2rec_torch.parallel.distributed import WORLD_OF_ONE

    m = Mesh(4, 2, 5, torch.device("cpu"), WORLD_OF_ONE, WORLD_OF_ONE,
             WORLD_OF_ONE)
    assert m.shape == {"dp": 4, "ip": 2} and m.size == 8
    assert (m.dp_index, m.ip_index) == (2, 1)
    one = make_mesh(1, 1, "cpu")
    assert (one.n_dp, one.n_ip, one.rank, one.dp.size) == (1, 1, 0, 1)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh(2, 2, "cpu")


@pytest.mark.parametrize("n_dp,n_ip", [(1, 1), (2, 1), (4, 1), (2, 2),
                                       (4, 2), (1, 4)])
def test_shard_ratings_match_the_tpu_package(n_dp, n_ip):
    """The user-block shards and the item-block item-major shards are the
    TPU package's, array for array, and reassemble the CSR."""
    from cu2rec_tpu.parallel.sharded import shard_ratings as j_shard
    from cu2rec_tpu.parallel.sharded import \
        shard_ratings_item_major as j_item_major

    toy = _inputs()[0]
    got = shard_ratings(toy, n_dp, n_ip)
    want = j_shard(_jax_csr(toy), n_dp, n_ip)
    for f in ("indptr", "indices", "data", "row_ids", "nnz"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), f)
    assert (got.total_nnz, got.n_users_padded, got.n_items_padded) == \
        (want.total_nnz, want.n_users_padded, want.n_items_padded)
    U_loc = got.n_users_padded // n_dp
    for d in range(n_dp):
        loc = got.local(d, "cpu")
        for u in range(U_loc):
            g = min(d * U_loc + u, toy.n_users)
            lo, hi = toy.indptr[g], toy.indptr[min(g + 1, toy.n_users)]
            np.testing.assert_array_equal(
                loc.indices[loc.indptr[u]:loc.indptr[u + 1]].numpy(),
                toy.indices[lo:hi])
    assert int(got.nnz.sum()) == toy.nnz

    it = shard_ratings_item_major(toy, n_ip)
    jit = j_item_major(_jax_csr(toy), n_ip)
    np.testing.assert_array_equal(it.it_indptr, np.asarray(jit.it_indptr))
    pairs = np.asarray(jit.it_pair).reshape(n_ip, -1, 2)
    for i in range(n_ip):
        n = int(it.nnz[i])
        np.testing.assert_array_equal(it.it_users[i, :n], pairs[i, :n, 0])
        np.testing.assert_array_equal(
            it.it_vals[i, :n], pairs[i, :n, 1].view(np.float32))


def test_pad_and_trim_match_the_tpu_package():
    from cu2rec_tpu.models.state import init_model
    from cu2rec_tpu.models.state import model_to_numpy as j_to_numpy
    from cu2rec_tpu.parallel.sharded import pad_model as j_pad
    from cu2rec_tpu.parallel.sharded import trim_model as j_trim

    jm = init_model(6, 5, 4, 3.5, seed=3)
    tm = model_from_numpy(j_to_numpy(jm), "cpu")
    got = model_to_numpy(pad_model(tm, 8, 8))
    want = j_to_numpy(j_pad(jm, 8, 8))
    _close(got, want, 0.0)
    _close(model_to_numpy(trim_model(pad_model(tm, 8, 8), 6, 5)),
           j_to_numpy(j_trim(j_pad(jm, 8, 8), 6, 5)), 0.0)


# -- across ranks ----------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("grid", ALL_GRIDS)
def test_sharded_engine_matches_the_tpu_package_and_one_device(grid,
                                                               policy):
    ranks = [r[grid] for r in _world(_world_of(grid))]
    got, ev = ranks[0][policy]
    for r in ranks[1:]:
        _close(r[policy][0], got, 0.0)      # every rank: the same model
        assert r[policy][1] == ev
    want, jev = _jax_engine(grid, policy)
    _close(got, want, ATOL[policy])
    np.testing.assert_allclose(ev, jev, rtol=EVAL_RTOL)
    one, ev1 = _one_device(policy)
    _close(got, one, ATOL[policy])
    np.testing.assert_allclose(ev, ev1, rtol=EVAL_RTOL)


@pytest.mark.parametrize("grid", ALL_GRIDS)
def test_sampled_items_and_winners_are_one_devices_bit_for_bit(grid):
    """Each rank's sampled items (its users' draws on the stream of their
    global ids) and its items' election winners (over the grid) are the
    one-device draws and election, and the TPU package's."""
    import jax.numpy as jnp

    from cu2rec_tpu.data.csr import to_device as j_to_device
    from cu2rec_tpu.ops.sgd import elect_winners as j_elect
    from cu2rec_tpu.ops.sgd import rotated_priority as j_prio
    from cu2rec_tpu.ops.sgd import sample_items as j_sample
    import jax

    toy = _inputs()[0]
    jdev = j_to_device(_jax_csr(toy))
    key = jax.random.PRNGKey(42)
    for r in _world(_world_of(grid)):
        res = r[grid]
        u0, U_loc, i0, I_loc = res["blocks"]
        for it, (items, has, best) in res["draws"].items():
            ji, _jr, jh = j_sample(key, jnp.int32(it), jdev.indptr,
                                   jdev.indices, jdev.data)
            jb, _c = j_elect(ji, jh, j_prio(toy.n_users, jnp.int32(it), 0,
                                            toy.n_users), toy.n_items)
            ji, jh, jb = (np.asarray(x) for x in (ji, jh, jb))
            n = max(min(U_loc, toy.n_users - u0), 0)
            np.testing.assert_array_equal(has[:n], jh[u0:u0 + n])
            assert not has[n:].any()
            np.testing.assert_array_equal(items[:n][has[:n]],
                                          ji[u0:u0 + n][jh[u0:u0 + n]])
            m = max(min(I_loc, toy.n_items - i0), 0)
            np.testing.assert_array_equal(best[:m], jb[i0:i0 + m])


@pytest.mark.parametrize("grid", ALL_GRIDS)
def test_sharded_eval_with_a_smaller_test_split(grid):
    """A test split whose users end before the train split's: the engine
    aligns its dimensions before sharding, so each shard evaluates its own
    users (JAX ``test_parallel.py``'s case)."""
    from cu2rec_tpu.data.csr import normalize_csr_dims, to_device as j_dev
    from cu2rec_tpu.models.state import init_model
    from cu2rec_tpu.ops.loss import evaluate as j_eval

    toy, small, _m, _f, _fm = _inputs()
    jm = init_model(toy.n_users, toy.n_items, 4, GB, seed=42)
    want = j_eval(jm, j_dev(normalize_csr_dims(_jax_csr(small), toy.n_users,
                                               toy.n_items)))
    for r in _world(_world_of(grid)):
        np.testing.assert_allclose(r[grid]["small_eval"], want,
                                   rtol=EVAL_RTOL)


def test_twin_after_construction_raises():
    for r in _world(2):
        assert r[(2, 1)]["guard"] and "twin" in r[(2, 1)]["guard"]


# -- the families across ranks -------------------------------------------

@functools.lru_cache(maxsize=None)
def _families_one_device():
    from cu2rec_torch.ops.als import (
        als_half_sweep, bucket_csr, prepare_chunks,
    )
    from cu2rec_torch.ops.ials import ials_half_sweep
    from cu2rec_torch.ops.packed import pack
    from cu2rec_torch.train.als import train_als
    from cu2rec_torch.train.bpr import train_bpr
    from cu2rec_torch.train.ials import train_ials

    _t, _s, _m, (train, test), fam_model_d = _inputs()
    quiet = MetricsLogger(verbose=False)
    model = model_from_numpy(fam_model_d, "cpu")
    out = {}
    m, losses = train_als(train, test, _family_cfg(total_iterations=2), 3.0,
                          model=model, logger=quiet, device="cpu",
                          device_buckets=False)
    out["als"] = (model_to_numpy(m), losses)
    m, losses = train_ials(train, test, _family_cfg(total_iterations=2),
                           alpha=5.0, model=model, logger=quiet,
                           device="cpu", device_buckets=False)
    out["ials"] = (model_to_numpy(m), losses)
    pm = pack(model)
    chunks = prepare_chunks(bucket_csr(train.indptr, train.indices,
                                       train.data, SMALL_CAPS), 4,
                            train.n_users)
    out["sweep"] = (
        als_half_sweep(pm.T_u, pm.T_i, chunks, 3.0, 0.05, 0.02, 4).numpy(),
        ials_half_sweep(model.P, model.Q, chunks, 5.0, 0.1).numpy())
    cfg = _family_cfg(total_iterations=30, check_error=15, learning_rate=0.1)
    m, losses = train_bpr(train, test, cfg, model=model, logger=quiet,
                          device="cpu")
    out["bpr"] = (model_to_numpy(m), losses)
    return out


@functools.lru_cache(maxsize=None)
def _jax_families(grid):
    from cu2rec_tpu.models.state import init_model
    from cu2rec_tpu.models.state import model_to_numpy as j_to_numpy
    from cu2rec_tpu.parallel.sharded import make_mesh as j_mesh
    from cu2rec_tpu.train.als import train_als
    from cu2rec_tpu.train.ials import train_ials

    _t, _s, _m, (train, test), _fm = _inputs()
    quiet = MetricsLogger(verbose=False)
    jm = init_model(60, 25, 4, 3.0, seed=7)
    out = {}
    m, losses = train_als(_jax_csr(train), _jax_csr(test),
                          _family_cfg(total_iterations=2), 3.0, model=jm,
                          logger=quiet, mesh=j_mesh(*grid),
                          device_buckets=False)
    out["als"] = (j_to_numpy(m), losses)
    m, losses = train_ials(_jax_csr(train), _jax_csr(test),
                           _family_cfg(total_iterations=2), alpha=5.0,
                           model=jm, logger=quiet, mesh=j_mesh(*grid),
                           device_buckets=False)
    out["ials"] = (j_to_numpy(m), losses)
    return out


def _ranks_agree(ranks, key):
    for r in ranks[1:]:
        _close(r["families"][key][0], ranks[0]["families"][key][0], 0.0)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("family", ["als", "ials"])
def test_row_sharded_sweeps_match_one_device_and_the_tpu_package(world,
                                                                  family):
    """Two sweeps with the ridge solves dealt over the grid (dp × ip
    flattened) against the one-device port and the TPU package's
    ``train_als``/``train_ials(mesh=...)``; ALS from host chunks and from
    chunks built on the device."""
    ranks = _world(world)
    keys = [("als", False), ("als", True)] if family == "als" else ["ials"]
    one = _families_one_device()[family]
    jax_run = _jax_families(FAMILY_GRID[world])[family]
    for key in keys:
        _ranks_agree(ranks, key)
        got, losses = ranks[0]["families"][key]
        for want, want_losses in (one, jax_run):
            assert sorted(losses) == sorted(want_losses)
            np.testing.assert_allclose([losses[k] for k in sorted(losses)],
                                       [want_losses[k] for k in
                                        sorted(want_losses)],
                                       rtol=FAM_RTOL)
            for c in ("p", "q", "user_bias", "item_bias"):
                np.testing.assert_allclose(got[c], want[c], rtol=FAM_RTOL,
                                           atol=FAM_ATOL, err_msg=c)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("chunks", ["host", "device"])
def test_row_sharded_half_sweeps_with_heavy_rows(world, chunks):
    """Half sweeps whose rows run past the largest bucket (heavy chunks,
    dealt whole to one rank each) from host and device chunks: every rank
    holds the one-device table, every rank solved some of it."""
    ranks = _world(world)
    als_want, ials_want = _families_one_device()["sweep"]
    for r in ranks:
        als_got, ials_got, n_chunks = r["families"]["sweep", chunks]
        assert n_chunks > 0
        np.testing.assert_allclose(als_got, als_want, rtol=FAM_RTOL,
                                   atol=FAM_ATOL)
        np.testing.assert_allclose(ials_got, ials_want, rtol=FAM_RTOL,
                                   atol=FAM_ATOL)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_bpr_matches_train_bpr(world):
    """ShardedBPR's ids bit-equal to the one-device draws, and its trained
    tables within 1e-6 of ``train_bpr``'s on one device."""
    from cu2rec_torch.ops.bpr import bpr_draws

    _t, _s, _m, (train, _test), _fm = _inputs()
    dev = to_device(train, "cpu", item_major=True)
    ranks = _world(world)
    for r in ranks:
        u0, U_loc, i0, I_loc = r["families"]["bpr_blocks"]
        n = max(min(U_loc, train.n_users - u0), 0)
        m = max(min(I_loc, train.n_items - i0), 0)
        for it, got in r["families"]["bpr_draws"].items():
            want = [t.numpy() for t in bpr_draws(dev, prng_key(7), it)]
            us, its = slice(u0, u0 + n), slice(i0, i0 + m)
            has_u, has_y, has_v = want[1][us], want[4][its], want[8][its]
            np.testing.assert_array_equal(got[1][:n], has_u)
            np.testing.assert_array_equal(got[0][:n][has_u],
                                          want[0][us][has_u])
            np.testing.assert_array_equal(got[2][:n], want[2][us])
            np.testing.assert_array_equal(got[4][:m], has_y)
            np.testing.assert_array_equal(got[3][:m][has_y],
                                          want[3][its][has_y])
            np.testing.assert_array_equal(got[5][:m], want[5][its])
            np.testing.assert_array_equal(got[6][:m], want[6][its])
            np.testing.assert_array_equal(got[8][:m], has_v)
            np.testing.assert_array_equal(got[7][:m][has_v],
                                          want[7][its][has_v])
    _ranks_agree(ranks, "bpr")
    got, losses = ranks[0]["families"]["bpr"]
    want, want_losses = _families_one_device()["bpr"]
    assert losses == pytest.approx(want_losses, abs=1e-6)
    _close(got, want, 1e-6)


def test_mf_devices_two_on_the_cpu_matches_one_device(tmp_path, data_dir,
                                                      monkeypatch):
    """``mf --devices 2 --device cpu`` (two gloo ranks) writes the CSVs
    and the checkpoint ``--devices 1`` writes, within the sharded
    engine's tolerance."""
    from cu2rec_torch.cli import mf
    from cu2rec_torch.parallel import distributed
    from cu2rec_torch.utils.checkpoint import load_checkpoint

    monkeypatch.setattr(distributed, "LAUNCH_TIMEOUT", RANK_TIMEOUT)

    cfg = tmp_path / "cfg.txt"
    cfg.write_text("0 30 8 0.05 42 0.02 0.02 0.02 0.02 32 10 2 0.2\n")
    train = str(data_dir / "test_ratings.csv")
    comps = {}
    for n in (1, 2):
        out = tmp_path / f"out{n}"
        assert mf.main(["-c", str(cfg), train, train, "--device", "cpu",
                        "--devices", str(n), "--outdir", str(out),
                        "--checkpoint", str(tmp_path / f"ck{n}.npz")]) == 0
        comps[n] = {c: np.loadtxt(out / f"test_ratings_f8_{c}.csv",
                                  delimiter=",", skiprows=1, ndmin=1)
                    for c in ("p", "q", "user_bias", "item_bias")}
        model, cfg_r, _ = load_checkpoint(str(tmp_path / f"ck{n}.npz"),
                                          device="cpu")
        assert cfg_r.cur_iterations == 30
        comps[n]["ck"] = model.P.numpy()
    for c in comps[1]:
        np.testing.assert_allclose(comps[2][c], comps[1][c], rtol=0,
                                   atol=1e-6, err_msg=c)


# -- the unpacked step and eval (one device) ------------------------------

def _unpacked_data(dtype: str):
    """40 users x 15 items, 300 ratings (users 0-3 none), and the TPU
    package's tables in ``dtype``, for both packages."""
    from cu2rec_tpu.data.csr import csr_from_arrays as j_csr
    from cu2rec_tpu.models.state import init_model
    from cu2rec_tpu.models.state import model_to_numpy as j_to_numpy

    rng = np.random.default_rng(5)
    n = 300
    u, i = rng.integers(4, 40, n), rng.integers(0, 15, n)
    r = (rng.integers(1, 11, n) / 2.0).astype(np.float32)
    tcsr = csr_from_arrays(u, i, r, 40, 15, use_native=False)
    jcsr = j_csr(u, i, r, 40, 15)
    jm = init_model(40, 15, 4, 3.2, seed=9)
    if dtype == "bfloat16":
        import jax.numpy as jnp
        from cu2rec_tpu.models.state import MFModel as JModel
        jm = JModel(P=jm.P.astype(jnp.bfloat16), Q=jm.Q.astype(jnp.bfloat16),
                    user_bias=jm.user_bias.astype(jnp.bfloat16),
                    item_bias=jm.item_bias.astype(jnp.bfloat16),
                    global_bias=jm.global_bias)
    from cu2rec_torch.models.state import with_dtype
    tm = with_dtype(model_from_numpy(j_to_numpy(jm), "cpu"), dtype)
    return tcsr, jcsr, tm, jm


def _as_np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("collision", ["first_wins", "mean"])
def test_unpacked_sgd_step_and_item_deltas_match_the_tpu_package(collision,
                                                                  dtype):
    """``sgd_step`` (user side and per-row item deltas) and
    ``apply_item_deltas`` (the deltas added in row order, a rounding to
    the table dtype after each add) against the TPU package's: float32
    within 1e-6, bf16 within one bf16 ulp."""
    import jax
    import jax.numpy as jnp

    from cu2rec_torch.ops import sgd as t_sgd
    from cu2rec_tpu.data.csr import to_device as j_to_device
    from cu2rec_tpu.ops import sgd as j_sgd

    tcsr, jcsr, tm, jm = _unpacked_data(dtype)
    jdev = j_to_device(jcsr)
    tdev = to_device(tcsr, "cpu")
    jhp = j_sgd.Hyper(*(jnp.float32(v) for v in (0.05, 0.1, 0.1, 0.1, 0.1)))
    rtol = 0 if dtype == "float32" else 2.0 ** -7
    for it in (0, 2):
        ji, jr, jh = j_sgd.sample_items(jax.random.PRNGKey(9), jnp.int32(it),
                                        jdev.indptr, jdev.indices, jdev.data)
        jb, jc = j_sgd.elect_winners(ji, jh, j_sgd.rotated_priority(
            40, jnp.int32(it), 0, 40), 15)
        jw = j_sgd.win_mask(jb, ji, jc, jh)
        jout = j_sgd.sgd_step(jm.P, jm.Q, jm.user_bias, jm.item_bias,
                              jm.global_bias, ji, jr, jh, jw, jhp,
                              collision=collision)
        japply = j_sgd.apply_item_deltas(jm.Q, jm.item_bias, ji, *jout[2:])

        ti, tr, th = t_sgd.sample_items(prng_key(9), it, tdev.indptr,
                                        tdev.indices, tdev.data)
        tb, tc = t_sgd.elect_winners(ti, th, t_sgd.rotated_priority(
            40, it, 0, 40), 15)
        tw = t_sgd.win_mask(tb, ti, tc, th)
        tout = t_sgd.sgd_step(tm.P, tm.Q, tm.user_bias, tm.item_bias,
                              tm.global_bias, ti, tr, th, tw, _hp(),
                              collision=collision)
        tapply = t_sgd.apply_item_deltas(tm.Q, tm.item_bias, ti, *tout[2:])
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        for name, a, b in zip(("P", "user_bias", "dq", "dib", "Q",
                               "item_bias"), tout + tapply, jout + japply):
            assert a.dtype == getattr(torch, dtype), name
            np.testing.assert_allclose(_as_np(a), _as_np(b), rtol=rtol,
                                       atol=1e-6, err_msg=name)


def test_error_sums_match_the_tpu_package():
    from cu2rec_torch.ops.loss import error_sums
    from cu2rec_tpu.data.csr import to_device as j_to_device
    from cu2rec_tpu.ops.loss import error_sums as j_error_sums

    tcsr, jcsr, tm, jm = _unpacked_data("float32")
    jdev = j_to_device(jcsr)
    n = jcsr.nnz
    mask = np.arange(n) % 7 != 3
    want = j_error_sums(jm.P, jm.Q, jm.user_bias, jm.item_bias,
                        jm.global_bias, jdev.row_ids[:n], jdev.indices[:n],
                        jdev.data[:n], mask, chunk_size=64)
    tdev = to_device(tcsr, "cpu")
    got = error_sums(tm.P, tm.Q, tm.user_bias, tm.item_bias, tm.global_bias,
                     tdev.row_ids, tdev.indices, tdev.data,
                     torch.from_numpy(mask), chunk_size=64)
    np.testing.assert_allclose(got.numpy(), [float(w) for w in want],
                               rtol=1e-5)


@pytest.mark.parametrize("collision", ["first_wins", "mean"])
def test_single_chip_engine_unpacked_matches_the_tpu_package(collision):
    """``SingleChipEngine(packed=False)``: the unpacked step and eval through
    the engine interface, ten steps from the TPU package's tables."""
    import jax.numpy as jnp

    from cu2rec_torch.train.trainer import SingleChipEngine
    from cu2rec_tpu.models.state import model_to_numpy as j_to_numpy
    from cu2rec_tpu.ops.sgd import Hyper as JHyper
    from cu2rec_tpu.train.trainer import SingleChipEngine as JEngine

    tcsr, jcsr, tm, jm = _unpacked_data("float32")
    cfg = _cfg(collision, seed=9)
    teng = SingleChipEngine(tcsr, tcsr, cfg, packed=False, device="cpu")
    jeng = JEngine(jcsr, jcsr, cfg, packed=False)
    ts = teng.run(teng.prepare(tm), _hp(), 0, STEPS)
    js = jeng.run(jeng.prepare(jm), JHyper(*(jnp.float32(v) for v in
                                             (0.05, 0.1, 0.1, 0.1, 0.1))),
                  0, STEPS)
    _close(model_to_numpy(teng.finalize(ts)), j_to_numpy(jeng.finalize(js)),
           1e-6)
    np.testing.assert_allclose(teng.evaluate(ts, "test"),
                               jeng.evaluate(js, "test"), rtol=EVAL_RTOL)
