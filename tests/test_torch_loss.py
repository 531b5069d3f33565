"""The port's eval (``ops/loss.py``, the plain version of K0b on the CPU)
against the TPU package's: ``evaluate_packed`` and ``evaluate`` within
rtol 1e-6 on the toy fixture and ML-100K, the analytic 74.0 golden, chunked
against unchunked sums, the width-aware chunk cap, and the train-eval
subsample's draw.

The TPU package sums in float32, the port in float64; over at most 90,000
ratings of errors near 1 the float32 sums stay within 1e-6 relative.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cu2rec_torch.data.csr import build_csr as t_build
from cu2rec_torch.data.csr import to_device as t_to_device
from cu2rec_torch.data.ratings import read_ratings_csv as t_read
from cu2rec_torch.models.state import model_from_numpy
from cu2rec_torch.ops import loss as tl
from cu2rec_torch.ops.packed import pack
from cu2rec_torch.train.trainer import _subsample_dev
from cu2rec_tpu.data import build_csr, read_ratings_csv
from cu2rec_tpu.data.csr import to_device
from cu2rec_tpu.models.state import MFModel
from cu2rec_tpu.ops import loss as jl
from cu2rec_tpu.ops.packed import pack as j_pack
from cu2rec_tpu.train.trainer import _subsample_dev as j_subsample_dev

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = {"toy": "tests/data/test_ratings.csv",
         "ml100k": "data/ml100k_ratings_train.csv"}


@pytest.fixture(scope="module", params=list(FILES))
def both(request):
    path = str(ROOT / FILES[request.param])
    return build_csr(read_ratings_csv(path)), t_build(t_read(path))


def _tables(U, I, F, seed):
    rng = np.random.default_rng(seed)
    return {"p": rng.normal(0, 0.3, (U, F)).astype(np.float32),
            "q": rng.normal(0, 0.3, (I, F)).astype(np.float32),
            "user_bias": rng.normal(0, 0.3, U).astype(np.float32),
            "item_bias": rng.normal(0, 0.3, I).astype(np.float32),
            "global_bias": np.array([3.5], np.float32)}


def _j_model(d):
    return MFModel(P=jnp.asarray(d["p"]), Q=jnp.asarray(d["q"]),
                   user_bias=jnp.asarray(d["user_bias"]),
                   item_bias=jnp.asarray(d["item_bias"]),
                   global_bias=jnp.float32(d["global_bias"][0]))


@pytest.mark.parametrize("F", [4, 16])
def test_evaluate_packed_matches(both, F):
    jcsr, tcsr = both
    d = _tables(jcsr.n_users, jcsr.n_items, F, seed=F)
    want = jl.evaluate_packed(j_pack(_j_model(d)), to_device(jcsr))
    got = tl.evaluate_packed(pack(model_from_numpy(d, "cpu")),
                             t_to_device(tcsr, "cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    want = jl.evaluate(_j_model(d), to_device(jcsr))
    got = tl.evaluate(model_from_numpy(d, "cpu"), t_to_device(tcsr, "cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _ones(U, I, F=2, mu=1.0):
    return {"p": np.ones((U, F)), "q": np.ones((I, F)),
            "user_bias": np.ones(U), "item_bias": np.ones(I),
            "global_bias": [mu]}


def test_loss_analytic_74():
    """All-ones tables (F=2) and μ = 1 on the toy fixture: every prediction
    is 5.0 and the squared errors sum to exactly 74.0."""
    tcsr = t_build(t_read(str(ROOT / FILES["toy"])))
    m = model_from_numpy(_ones(tcsr.n_users, tcsr.n_items), "cpu")
    rows = torch.from_numpy(tcsr.row_ids).long()
    cols = torch.from_numpy(tcsr.indices).long()
    vals = torch.from_numpy(tcsr.data)
    pm = pack(m)
    sums = tl.packed_error_sums_reference(pm.T_u, pm.T_i, pm.global_bias,
                                          rows, cols, vals, pm.n_factors)
    assert float(sums[0]) == 74.0
    rmse, _ = tl.evaluate_packed(pm, t_to_device(tcsr, "cpu"))
    assert rmse == pytest.approx(np.sqrt(74.0 / tcsr.nnz), rel=1e-12)
    rmse, _ = tl.evaluate(m, t_to_device(tcsr, "cpu"))
    assert rmse == pytest.approx(np.sqrt(74.0 / tcsr.nnz), rel=1e-12)


def test_chunked_sums_match_unchunked(both):
    """The plain packed sums in chunks of 5 equal them in one chunk, and
    both match the TPU package's unpacked ``error_sums``."""
    jcsr, tcsr = both
    d = _tables(tcsr.n_users, tcsr.n_items, 8, seed=1)
    pm = pack(model_from_numpy(d, "cpu"))
    rows = torch.from_numpy(tcsr.row_ids)
    cols = torch.from_numpy(tcsr.indices)
    vals = torch.from_numpy(tcsr.data)
    whole = tl.packed_error_sums_reference(pm.T_u, pm.T_i, pm.global_bias,
                                           rows, cols, vals, 8)
    chunked = tl.packed_error_sums_reference(pm.T_u, pm.T_i, pm.global_bias,
                                             rows, cols, vals, 8,
                                             chunk_size=5)
    torch.testing.assert_close(chunked, whole, rtol=1e-12, atol=0)
    jm = _j_model(d)
    want = jl.error_sums(jm.P, jm.Q, jm.user_bias, jm.item_bias,
                         jm.global_bias, jnp.asarray(jcsr.row_ids),
                         jnp.asarray(jcsr.indices), jnp.asarray(jcsr.data),
                         jnp.ones(jcsr.nnz, bool))
    np.testing.assert_allclose(whole.numpy(), np.asarray(want, np.float64),
                               rtol=1e-6)


@pytest.mark.parametrize("W", [64, 128, 304])
def test_cap_eval_chunk_matches(W):
    for chunk in (1 << 10, 1 << 18, 1 << 20, 1 << 22):
        assert tl._cap_eval_chunk(chunk, W) == jl._cap_eval_chunk(chunk, W)


def test_metrics_all_ones_errors():
    for n in (1, 33, 1 << 10, 1 << 16):
        assert tl.metrics_from_errors(torch.ones(n)) == (1.0, 1.0)


@pytest.mark.parametrize("n_sample,seed", [(7, 42), (5000, 43)])
def test_subsample_selects_the_same_ratings(n_sample, seed):
    path = str(ROOT / FILES["ml100k"])
    jcsr, tcsr = build_csr(read_ratings_csv(path)), t_build(t_read(path))
    a = j_subsample_dev(jcsr, n_sample, seed)
    b = _subsample_dev(tcsr, n_sample, seed, "cpu")
    assert b.nnz == a.nnz == n_sample and b.indptr is None
    for name in ("indices", "data", "row_ids"):
        np.testing.assert_array_equal(getattr(b, name).numpy(),
                                      np.asarray(getattr(a, name))[:n_sample])
    # The denominator is the subsample's true count, not a padded length.
    d = _tables(tcsr.n_users, tcsr.n_items, 8, seed=2)
    np.testing.assert_allclose(
        tl.evaluate_packed(pack(model_from_numpy(d, "cpu")), b),
        jl.evaluate_packed(j_pack(_j_model(d)), a), rtol=1e-6)
