"""The port's small serving ops against the TPU package's: pair prediction,
catalog scoring, rated-item masking, top-k, the packed tables and their
reg vectors, and the ``serve/recommend.py`` helpers.

Tolerance: scores rtol 1e-5 / atol 1e-5 (one float32 dot product of width
F plus biases, summed in another order); packing and masking are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cu2rec_torch.models.state import model_from_numpy
from cu2rec_torch.ops import model as t_model
from cu2rec_torch.ops import packed as t_packed
from cu2rec_torch.ops import topk as t_topk
from cu2rec_torch.ops.sgd import Hyper as THyper
from cu2rec_torch.serve import recommend as t_rec
from cu2rec_tpu.models.state import init_model as j_init
from cu2rec_tpu.models.state import model_to_numpy
from cu2rec_tpu.ops import model as j_model
from cu2rec_tpu.ops import packed as j_packed
from cu2rec_tpu.ops import topk as j_topk
from cu2rec_tpu.ops.sgd import Hyper as JHyper
from cu2rec_tpu.serve import recommend as j_rec
from cu2rec_tpu.utils.config import Config

RTOL, ATOL = 1e-5, 1e-5


def _models(U=9, I=40, F=6, seed=3):
    jm = j_init(U, I, F, 3.25, seed=seed)
    return jm, model_from_numpy(model_to_numpy(jm), device="cpu")


def _rated(B, I, R=5, seed=0):
    rng = np.random.default_rng(seed)
    items = rng.integers(0, I, (B, R)).astype(np.int32)
    mask = rng.random((B, R)) > 0.3
    items[0, :2] = items[0, 0]          # a repeated id is harmless
    mask[0, :2] = True
    return items, mask


def test_predict_pairs_and_score_catalog_match():
    jm, tm = _models()
    rng = np.random.default_rng(1)
    users = rng.integers(0, 9, 30)
    items = rng.integers(0, 40, 30)
    want = np.asarray(j_model.predict_pairs(
        jm.P, jm.Q, jm.user_bias, jm.item_bias, jm.global_bias,
        jnp.asarray(users), jnp.asarray(items)))
    got = t_model.predict_pairs(tm.P, tm.Q, tm.user_bias, tm.item_bias,
                                tm.global_bias, torch.from_numpy(users),
                                torch.from_numpy(items))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    want = np.asarray(j_model.score_catalog(
        jm.P[:4], jm.user_bias[:4], jm.Q, jm.item_bias, jm.global_bias))
    got = t_model.score_catalog(tm.P[:4], tm.user_bias[:4], tm.Q,
                                tm.item_bias, tm.global_bias)
    assert got.dtype == torch.float32 and got.shape == (4, 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_mask_rated_and_topk_match():
    rng = np.random.default_rng(2)
    scores = rng.normal(size=(6, 40)).astype(np.float32)
    items, mask = _rated(6, 40)
    want = np.asarray(j_topk.mask_rated(jnp.asarray(scores),
                                        jnp.asarray(items),
                                        jnp.asarray(mask)))
    got = t_topk.mask_rated(torch.from_numpy(scores),
                            torch.from_numpy(items), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(t_topk.NEG_INF) == float(j_topk.NEG_INF)
    jv, ji = j_topk.topk_scores(jnp.asarray(want), 7)
    tv, ti = t_topk.topk_scores(got, 7)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("F", [4, 63, 64, 100, 300])
def test_packed_tables_match(F):
    jm, tm = _models(U=5, I=7, F=F)
    assert t_packed.packed_width(F) == j_packed.packed_width(F)
    jp, tp = j_packed.pack(jm), t_packed.pack(tm)
    assert tp.width == jp.width and tp.n_factors == F
    np.testing.assert_array_equal(tp.T_u.numpy(), np.asarray(jp.T_u))
    np.testing.assert_array_equal(tp.T_i.numpy(), np.asarray(jp.T_i))
    back = t_packed.unpack(tp)
    for name in ("P", "Q", "user_bias", "item_bias"):
        assert torch.equal(getattr(back, name), getattr(tm, name))


def test_reg_vectors_match():
    cfg = Config(P_reg=0.02, Q_reg=0.03, user_bias_reg=0.5,
                 item_bias_reg=0.7)
    want = j_packed._reg_vectors(JHyper.from_config(cfg), 6, 64)
    got = t_packed._reg_vectors(THyper.from_config(cfg), 6, 64)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_recommend_helpers_match():
    jm, tm = _models()
    users = np.array([8, 0, 3, 3])
    items, mask = _rated(4, 40, seed=4)
    jv, ji = j_rec.recommend_users(jm, users, items, mask, k=5)
    tv, ti = t_rec.recommend_users(tm, users, items, mask, k=5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for b in range(4):
        assert not set(items[b][mask[b]].tolist()) & set(ti[b].tolist())
    want = np.asarray(j_rec.predict_all_items(
        jm.P[2], jm.user_bias[2], jm.Q, jm.item_bias, jm.global_bias))
    got = t_rec.predict_all_items(tm.P[2], tm.user_bias[2], tm.Q,
                                  tm.item_bias, tm.global_bias)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    ranked = t_rec.ranked_items(got)
    assert [i for _, i in ranked] == [i for _, i in j_rec.ranked_items(
        got.numpy())]
    assert ranked[0][0] == float(got.max())
