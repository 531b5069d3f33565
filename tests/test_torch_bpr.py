"""The port's BPR (``ops/bpr.py``, ``train/bpr.py``) and its threefry
``fold_in`` against the TPU package's, on the CPU.

Keys and sampled ids are integer streams: bit-identical.  Three steps'
tables agree within 1e-6 (float32 sums of a row in another order, and
sigmoid); a short training run's AUC, recall@k and NDCG@k within 1e-3 (the
same pairs and lists; a comparison could flip only at a near-tie).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cu2rec_torch.data.csr import csr_from_arrays as t_csr
from cu2rec_torch.data.csr import to_device as t_to_device
from cu2rec_torch.models.state import model_from_numpy
from cu2rec_torch.ops import bpr as t_bpr
from cu2rec_torch.ops.packed import pack as t_pack
from cu2rec_torch.ops.sgd import Hyper as THyper
from cu2rec_torch.ops.sgd import fold_in, prng_key
from cu2rec_torch.train.bpr import train_bpr as t_train
from cu2rec_torch.utils.config import Config
from cu2rec_torch.utils.metrics import MetricsLogger
from cu2rec_tpu.data.csr import csr_from_arrays as j_csr
from cu2rec_tpu.data.csr import to_device as j_to_device
from cu2rec_tpu.models.state import init_model as j_init
from cu2rec_tpu.models.state import model_to_numpy as j_to_numpy
from cu2rec_tpu.ops import bpr as j_bpr
from cu2rec_tpu.ops.packed import pack as j_pack
from cu2rec_tpu.ops.sgd import GATHER_LANES, counter_uniform, fetch_pairs, \
    gather_1d, sample_items
from cu2rec_tpu.train.bpr import train_bpr as j_train

SEEDS = [0, 1, 42, 7_777_777, 2 ** 31 - 1, 2 ** 32 + 5, -1]


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_is_bit_exact(seed):
    kd = np.asarray(jax.random.PRNGKey(seed))
    assert prng_key(seed) == tuple(int(x) for x in kd)
    for tag in (0, 1, 2, 3, 4, 250, 2 ** 31, 2 ** 32 - 1):
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), tag))
        assert fold_in(prng_key(seed), tag) == tuple(int(x) for x in want)
    assert fold_in(prng_key(42), 1) == (64467757, 2916123636)
    # Folding twice, as nested streams would.
    k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), 3), 9)
    assert fold_in(fold_in(prng_key(seed), 3), 9) == \
        tuple(int(x) for x in np.asarray(k))


@pytest.mark.parametrize("n_draws,n_range,tag,offset,it", [
    (1000, 37, 1, 0, 0), (777, 138_000, 2, 500, 9), (5000, 27_000, 3, 1234,
                                                      4095)])
def test_uniform_ids_are_bit_exact(n_draws, n_range, tag, offset, it):
    got = t_bpr._uniform_ids(prng_key(11), it, n_draws, n_range, tag,
                             offset=offset)
    want = j_bpr._uniform_ids(jax.random.PRNGKey(11), jnp.int32(it),
                              n_draws, n_range, tag, offset=offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.min()) >= 0 and int(got.max()) < n_range


def _data(seed=0, U=90, I=40, n=800):
    """Both packages' CSRs with users 0 and 5 and item 3 unrated."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, U, n)
    i = rng.integers(0, I, n)
    keep = ~np.isin(u, (0, 5)) & (i != 3)
    keys = np.unique(u[keep] * I + i[keep])
    u, i = (keys // I).astype(np.int32), (keys % I).astype(np.int32)
    r = np.ones(len(u), np.float32)
    return (t_csr(u, i, r, U, I), j_csr(u, i, r, U, I, use_native=False),
            U, I)


def _jax_draws(dev, key, it, U, I):
    """The ids the TPU package's ``bpr_step`` samples (its own lines)."""
    i_pos, _r, has_u = sample_items(key, it, dev.indptr, dev.indices,
                                    dev.data, pair_pack=dev.pair_pack)
    j_neg = j_bpr._uniform_ids(key, it, U, I, tag=1)
    u_of_y, _r, has_y = sample_items(key, it, dev.it_indptr, None, None,
                                     user_offset=dev.n_users,
                                     pair_pack=dev.it_pair_pack)
    jn_y = j_bpr._uniform_ids(key, it, I, I, tag=2, offset=U)
    v = j_bpr._uniform_ids(key, it, I, U, tag=3, offset=U + I)
    U_lanes = -(-U // GATHER_LANES) * GATHER_LANES
    starts = jnp.pad(dev.indptr[:-1], (0, U_lanes - U))
    lens = jnp.pad(dev.indptr[1:] - dev.indptr[:-1], (0, U_lanes - U))
    start_v, len_v = gather_1d(starts, v), gather_1d(lens, v)
    u01 = counter_uniform(jax.random.fold_in(key, 4), it,
                          jnp.arange(I, dtype=jnp.uint32)
                          + jnp.uint32(2 * U))
    pos_v = start_v + jnp.minimum((u01 * len_v).astype(jnp.int32),
                                  jnp.maximum(len_v - 1, 0))
    iv, _rv = fetch_pairs(dev.pair_pack, pos_v)
    return dict(i_pos=i_pos, has_u=has_u, j_neg=j_neg, u_of_y=u_of_y,
                has_y=has_y, jn_y=jn_y, v=v, iv=iv, has_v=len_v > 0)


def _same_draws(got, want):
    masks = {"i_pos": "has_u", "u_of_y": "has_y", "iv": "has_v"}
    for name in got._fields:
        g, w = getattr(got, name).numpy(), np.asarray(want[name])
        if name in masks:     # a draw of an empty row is a placeholder
            has = np.asarray(want[masks[name]])
            g, w = g[has], w[has]
        np.testing.assert_array_equal(g, w, err_msg=name)


def _hyper():
    return THyper(*(float(np.float32(v)) for v in
                    (0.1, 0.01, 0.02, 0.0, 0.03)))


@pytest.mark.parametrize("lean", [False, True])
def test_three_bpr_steps_match(lean):
    t, j, U, I = _data()
    t_dev = t_to_device(t, "cpu", item_major=True, lean=lean)
    j_dev = j_to_device(j, item_major=True)
    m = j_init(U, I, 8, 0.0, seed=2)
    t_pm, j_pm = t_pack(model_from_numpy(j_to_numpy(m), "cpu")), j_pack(m)
    hp = _hyper()
    j_hp = j_bpr.Hyper(*(jnp.float32(x) for x in hp))
    for it in (0, 1, 2):
        _same_draws(t_bpr.bpr_draws(t_dev, prng_key(42), it),
                    _jax_draws(j_dev, jax.random.PRNGKey(42),
                               jnp.int32(it), U, I))
        t_new = t_bpr.bpr_step(t_pm, t_dev, hp, prng_key(42), it)
        j_pm = j_bpr.bpr_step(j_pm, j_dev, j_hp, jax.random.PRNGKey(42),
                              jnp.int32(it))
        for side in ("T_u", "T_i"):
            np.testing.assert_allclose(getattr(t_new, side).numpy(),
                                       np.asarray(getattr(j_pm, side)),
                                       rtol=0, atol=1e-6)
        # Unrated users 0 and 5 keep their rows; item 3 takes only the
        # negative pass's update and its reg.
        assert torch.equal(t_new.T_u[[0, 5]], t_pm.T_u[[0, 5]])
        t_pm = t_new
    assert t_bpr.bpr_draws(t_dev, prng_key(42), 0).has_y[3].item() is False
    run = t_bpr.bpr_run_steps(
        t_pack(model_from_numpy(j_to_numpy(m), "cpu")), t_dev, hp,
        prng_key(42), 0, 3)
    torch.testing.assert_close(run.T_i, t_pm.T_i, rtol=0, atol=0)


def test_bpr_step_needs_item_major_arrays():
    t, _, U, I = _data()
    pm = t_pack(model_from_numpy(j_to_numpy(j_init(U, I, 4, 0.0)), "cpu"))
    with pytest.raises(ValueError, match="item_major"):
        t_bpr.bpr_step(pm, t_to_device(t, "cpu"), _hyper(), prng_key(0), 0)


def test_train_bpr_matches():
    from cu2rec_tpu.data.synth import generate_planted_implicit, \
        split_arrays

    d, _ = generate_planted_implicit(160, 50, 3000, n_factors=8, seed=4)
    tr, te = split_arrays(d.users, d.items, d.ratings, 0.8, seed=1)
    hist = {}
    for name, build, train in (("port", t_csr, t_train),
                               ("jax", j_csr, j_train)):
        csrs = [build(*s, 160, 50) for s in (tr, te)]
        cfg = Config(total_iterations=60, check_error=25, n_factors=8,
                     seed=6, learning_rate=0.1, P_reg=0.01, Q_reg=0.01,
                     user_bias_reg=0.01, item_bias_reg=0.01)
        logger = MetricsLogger(verbose=False)
        m = j_init(160, 50, 8, 0.0, seed=6)
        if name == "port":
            m = model_from_numpy(j_to_numpy(m), "cpu")
            model, losses = train(*csrs, cfg, model=m, logger=logger,
                                  device="cpu")
        else:
            model, losses = train(*csrs, cfg, model=m, logger=logger)
        hist[name] = [r for r in logger.history if r["event"] == "eval"]
        assert sorted(losses) == [1, 25, 50, 60]
        assert cfg.cur_iterations == 60
    for a, b in zip(hist["port"], hist["jax"]):
        assert a["iteration"] == b["iteration"]
        for k in ("auc", "recall_at_k", "ndcg_at_k", "objective"):
            assert a[k] == pytest.approx(b[k], abs=1e-3), k
    # n_devices=2: two gloo ranks (parallel/bpr.py), each returning the
    # same model as the one-device run within 1e-6 and the same metrics.
    from cu2rec_torch.models.state import model_to_numpy
    from cu2rec_torch.parallel.distributed import launch

    csrs = [t_csr(*s, 160, 50) for s in (tr, te)]

    def fresh():  # a run counts its iterations into its config
        return Config(total_iterations=60, check_error=25, n_factors=8,
                      seed=6, learning_rate=0.1, P_reg=0.01, Q_reg=0.01,
                      user_bias_reg=0.01, item_bias_reg=0.01)

    m = model_from_numpy(j_to_numpy(j_init(160, 50, 8, 0.0, seed=6)), "cpu")
    one = t_train(*csrs, fresh(), model=m,
                  logger=MetricsLogger(verbose=False), device="cpu")
    ranks = launch(t_train, 2, "gloo", "cpu", args=(*csrs, fresh()),
                   kwargs=dict(model=m, logger=MetricsLogger(verbose=False),
                               n_devices=2), timeout=60)
    want = model_to_numpy(one[0])
    for model, losses in ranks:
        assert losses == pytest.approx(one[1], abs=1e-6)
        got = model_to_numpy(model)
        for c in want:
            np.testing.assert_allclose(got[c], want[c], rtol=0, atol=1e-6)


def test_twenty_bpr_steps_in_bf16_match():
    """bf16 tables, float32 arithmetic, stored back in bf16 as in the TPU
    package: each step draws bit-identical ids (the table dtype does not
    enter the sampling), and after 20 steps every entry is within 4 bf16
    ulps of the TPU package's."""
    from test_torch_bf16 import to_torch, ulp_distance

    from cu2rec_torch.ops.packed import PackedModel

    t, j, U, I = _data(seed=3)
    t_dev = t_to_device(t, "cpu", item_major=True)
    j_dev = j_to_device(j, item_major=True)
    j_pm = j_pack(j_init(U, I, 8, 0.0, seed=2, dtype=jnp.bfloat16))
    t_pm = PackedModel(T_u=to_torch(j_pm.T_u), T_i=to_torch(j_pm.T_i),
                       global_bias=torch.tensor(0.0), n_factors=8)
    hp = _hyper()
    j_hp = j_bpr.Hyper(*(jnp.float32(x) for x in hp))
    for it in range(20):
        _same_draws(t_bpr.bpr_draws(t_dev, prng_key(42), it),
                    _jax_draws(j_dev, jax.random.PRNGKey(42),
                               jnp.int32(it), U, I))
        t_pm = t_bpr.bpr_step(t_pm, t_dev, hp, prng_key(42), it)
        j_pm = j_bpr.bpr_step(j_pm, j_dev, j_hp, jax.random.PRNGKey(42),
                              jnp.int32(it))
    assert t_pm.T_u.dtype == t_pm.T_i.dtype == torch.bfloat16
    assert ulp_distance(t_pm.T_u, j_pm.T_u) <= 4
    assert ulp_distance(t_pm.T_i, j_pm.T_i) <= 4


def test_train_bpr_in_bf16_keeps_bf16_tables():
    csr, _, _, _ = _data()
    cfg = Config(total_iterations=3, check_error=3, n_factors=4,
                 dtype="bfloat16")
    model, losses = t_train(csr, csr, cfg, device="cpu",
                            logger=MetricsLogger(verbose=False))
    assert model.P.dtype == model.Q.dtype == torch.bfloat16
    assert sorted(losses) == [1, 3]
