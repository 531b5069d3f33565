"""The port's ``foldin_ranking_eval`` against the TPU package's, on the
planted cases of ``tests/test_serve.py`` (explicit SGD fold-in) and
``tests/test_ials.py`` (implicit ridge fold-in), JAX on the CPU.

Both engines serve the same catalog (trained by the TPU package, carried
over).  The explicit fold-in starts from the TPU engine's own default rows
(threefry, which torch cannot draw), handed to the port's engine.  Checked:
the same ``n_users``, the same recommended lists batch by batch, and the
metrics within 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from cu2rec_torch.data.csr import csr_from_arrays as t_csr_from_arrays
from cu2rec_torch.models.state import model_from_numpy
from cu2rec_torch.serve.engine import ServingEngine
from cu2rec_torch.serve.recommend import foldin_ranking_eval
from cu2rec_torch.utils.config import Config as TConfig
from cu2rec_tpu.data.csr import csr_from_arrays
from cu2rec_tpu.models.state import model_to_numpy
from cu2rec_tpu.serve.engine import ShardedServingEngine
from cu2rec_tpu.serve.recommend import foldin_ranking_eval as j_eval
from cu2rec_tpu.train.als import train_als
from cu2rec_tpu.train.ials import train_ials
from cu2rec_tpu.utils.config import Config
from cu2rec_tpu.utils.metrics import MetricsLogger

U, I = 40, 30


def _split(full, rng, liked_only: bool):
    """Per-user 50/50 split of the same ratings into input and holdout
    rows (holdout: liked items only where ``liked_only``)."""
    in_rows, out_rows = [], []
    for u in range(U):
        lo, hi = full.indptr[u], full.indptr[u + 1]
        perm = rng.permutation(hi - lo)
        half = (hi - lo) // 2
        for j in perm[:half]:
            in_rows.append((u, full.indices[lo + j], full.data[lo + j]))
        for j in perm[half:]:
            if not liked_only or full.data[lo + j] >= 4.0:
                out_rows.append((u, full.indices[lo + j], full.data[lo + j]))
    return in_rows, out_rows


def _both(make, rows):
    a = np.asarray(rows)
    args = (a[:, 0].astype(np.int32), a[:, 1].astype(np.int32),
            a[:, 2].astype(np.float32), U, I)
    return make(*args)


def _spy(engine, log: list):
    """Record every list the engine recommends."""
    recommend = engine.recommend

    def spy(*a, **kw):
        vals, idx = recommend(*a, **kw)
        log.append(np.asarray(idx))
        return vals, idx

    engine.recommend = spy


def _compare(jmodel, in_rows, out_rows, seed, **kw):
    jeng = ShardedServingEngine(jmodel)
    teng = ServingEngine(model_from_numpy(model_to_numpy(jmodel), "cpu"),
                         device="cpu")
    # The explicit fold-in's initial rows: the TPU engine's draw.
    teng._default_init = lambda Bp, key: torch.from_numpy(np.array(
        jeng._default_init(Bp, jax.random.PRNGKey(seed))))
    jrec, trec = [], []
    _spy(jeng, jrec)
    _spy(teng, trec)
    want = j_eval(jeng, _both(csr_from_arrays, in_rows),
                  _both(csr_from_arrays, out_rows), **kw)
    tkw = dict(kw)
    if "cfg" in tkw:
        tkw["cfg"] = TConfig(**{k: getattr(kw["cfg"], k)
                                for k in ("total_iterations", "n_factors",
                                          "learning_rate", "P_reg",
                                          "user_bias_reg", "seed")})
    got = foldin_ranking_eval(teng, _both(t_csr_from_arrays, in_rows),
                              _both(t_csr_from_arrays, out_rows), **tkw)
    assert got["n_users"] == want["n_users"]
    assert len(trec) == len(jrec) > 0
    for t, j in zip(trec, jrec):
        np.testing.assert_array_equal(t, j)
    for m in ("recall", "ndcg"):
        assert got[m] == pytest.approx(want[m], abs=1e-6)
    return got


def test_explicit_foldin_ranking_eval_matches():
    rng = np.random.default_rng(5)
    rows = []
    for u in range(U):
        block = (u % 2) * (I // 2)
        liked = rng.choice(I // 2, size=10, replace=False) + block
        other = rng.choice(I // 2, size=3, replace=False) + (I // 2 - block)
        for i in liked:
            rows.append((u, i, float(rng.integers(4, 6))))
        for i in other:
            rows.append((u, i, float(rng.integers(1, 3))))
    full = _both(csr_from_arrays, rows)
    cfg = Config(total_iterations=8, n_factors=8, P_reg=0.05, Q_reg=0.05,
                 user_bias_reg=0.05, item_bias_reg=0.05, seed=3)
    model, _ = train_als(full, full, cfg, float(full.data.mean()),
                         logger=MetricsLogger(verbose=False))
    in_rows, out_rows = _split(full, rng, liked_only=True)
    fold_cfg = Config(total_iterations=60, n_factors=8, learning_rate=0.1,
                      P_reg=0.05, user_bias_reg=0.05, seed=3)
    got = _compare(model, in_rows, out_rows, 3, cfg=fold_cfg, k=7)
    assert got["n_users"] > U * 0.8
    assert got["recall"] > 0.55, got


def test_implicit_foldin_ranking_eval_matches():
    rng = np.random.default_rng(11)
    rows = []
    for u in range(U):
        block = (u % 2) * (I // 2)
        for i in rng.choice(I // 2, size=10, replace=False) + block:
            rows.append((u, i, 1.0))
    full = _both(csr_from_arrays, rows)
    cfg = Config(total_iterations=6, n_factors=8, P_reg=0.1, Q_reg=0.1,
                 seed=2)
    model, _ = train_ials(full, full, cfg, alpha=20.0,
                          logger=MetricsLogger(verbose=False))
    in_rows, out_rows = _split(full, rng, liked_only=False)
    got = _compare(model, in_rows, out_rows, 0, mode="implicit", alpha=20.0,
                   reg=0.1, k=5)
    assert got["n_users"] == U
    assert got["recall"] > 0.6, got


def test_unknown_mode_and_metric_raise():
    teng = ServingEngine(model_from_numpy({
        "p": np.zeros((2, 4)), "q": np.ones((3, 4)), "user_bias": np.zeros(2),
        "item_bias": np.zeros(3), "global_bias": [0.0]}, "cpu"),
        device="cpu")
    csr = t_csr_from_arrays(np.array([0, 1], np.int32),
                            np.array([1, 2], np.int32),
                            np.ones(2, np.float32), 2, 3)
    with pytest.raises(ValueError, match="fold-in mode"):
        foldin_ranking_eval(teng, csr, csr, mode="als")
    with pytest.raises(ValueError, match="ranking metric"):
        foldin_ranking_eval(teng, csr, csr, metrics=("auc",))
