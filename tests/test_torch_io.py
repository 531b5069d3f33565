"""Host-side I/O of the PyTorch port against the TPU package: config
files, ratings CSVs, CSR, padded rated lists, ``.npz`` checkpoints in both
directions, component CSVs and the weight carry-over."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cu2rec_torch.data.csr import build_csr as t_build_csr
from cu2rec_torch.data.csr import csr_from_arrays as t_csr_from_arrays
from cu2rec_torch.data.csr import normalize_csr_dims as t_normalize
from cu2rec_torch.data.ratings import read_ratings_csv as t_read
from cu2rec_torch.models.state import (COMPONENTS, init_model as t_init,
                                       model_from_numpy, model_to_numpy)
from cu2rec_torch.serve.recommend import padded_user_lists as t_padded
from cu2rec_torch.utils import checkpoint as t_ckpt
from cu2rec_torch.utils.config import Config as TConfig
from cu2rec_tpu.data.csr import build_csr as j_build_csr
from cu2rec_tpu.data.csr import csr_from_arrays as j_csr_from_arrays
from cu2rec_tpu.data.csr import normalize_csr_dims as j_normalize
from cu2rec_tpu.data.ratings import read_ratings_csv as j_read
from cu2rec_tpu.models.state import COMPONENTS as J_COMPONENTS
from cu2rec_tpu.models.state import init_model as j_init
from cu2rec_tpu.models.state import model_to_numpy as j_to_numpy
from cu2rec_tpu.serve.recommend import padded_user_lists as j_padded
from cu2rec_tpu.utils import checkpoint as j_ckpt
from cu2rec_tpu.utils.config import Config as JConfig

DATA = pathlib.Path(__file__).parent / "data"
CFGS = sorted(p.name for p in DATA.glob("*.cfg"))
CSVS = ["test_ratings.csv", "test_ratings2.csv", "test_ratings3.csv",
        "test_missing_user_ratings.csv", "test_user_ratings.csv"]


@pytest.mark.parametrize("name", CFGS)
def test_config_legacy_parse_matches(name, tmp_path):
    j, t = JConfig(), TConfig()
    j.read_config(str(DATA / name))
    t.read_config(str(DATA / name))
    assert vars(j) == vars(t)
    # written by the port, read by the TPU package (and back)
    out = str(tmp_path / "w.cfg")
    t.write_config(out)
    j2 = JConfig()
    j2.read_config(out)
    assert vars(j2) == vars(t)
    t.write_config(out, legacy=False)
    j3 = JConfig()
    j3.read_config(out)
    assert vars(j3) == vars(t)


@pytest.mark.parametrize("name", CSVS)
def test_ratings_csr_and_padded_lists_match(name):
    j = j_read(str(DATA / name))
    t = t_read(str(DATA / name))
    for f in ("users", "items", "ratings"):
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (j.n_users, j.n_items) == (t.n_users, t.n_items)
    assert j.global_bias == t.global_bias
    jc, tc = j_build_csr(j), t_build_csr(t)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(jc, f), getattr(tc, f))
    np.testing.assert_array_equal(jc.row_ids, tc.row_ids)
    jg = j_normalize(jc, jc.n_users + 3, jc.n_items + 2)
    tg = t_normalize(tc, tc.n_users + 3, tc.n_items + 2)
    np.testing.assert_array_equal(jg.indptr, tg.indptr)
    users = list(range(jc.n_users))[::-1]
    for pad_to in (None, 2):
        ji, jm = j_padded(jc, users, pad_to=pad_to)
        ti, tm = t_padded(tc, users, pad_to=pad_to)
        np.testing.assert_array_equal(ji, ti)
        np.testing.assert_array_equal(jm, tm)


def test_csr_from_arrays_matches():
    rng = np.random.default_rng(0)
    users = rng.integers(0, 30, 500).astype(np.int32)
    items = rng.integers(0, 70, 500).astype(np.int32)
    vals = rng.random(500).astype(np.float32)
    j = j_csr_from_arrays(users, items, vals, 30, 70, use_native=False)
    t = t_csr_from_arrays(users, items, vals, 30, 70)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(j, f), getattr(t, f))
    with pytest.raises(ValueError):
        t_normalize(t, 29, 70)


def _jax_model(seed=3, U=11, I=17, F=6):
    return j_init(U, I, F, 3.25, seed=seed)


def test_model_from_numpy_roundtrips_exactly():
    jm = _jax_model()
    d = j_to_numpy(jm)
    tm = model_from_numpy(d, device="cpu")
    assert tuple(COMPONENTS) == tuple(J_COMPONENTS)
    assert (tm.n_users, tm.n_items, tm.n_factors) == (11, 17, 6)
    assert tm.global_bias.shape == ()
    back = model_to_numpy(tm)
    assert set(back) == set(d)
    for k in d:
        assert back[k].dtype == d[k].dtype and back[k].shape == d[k].shape
        np.testing.assert_array_equal(back[k], d[k])
    # buffers, not parameters: the tables move with the module
    assert dict(tm.named_buffers()).keys() == {
        "P", "Q", "user_bias", "item_bias", "global_bias"}
    assert list(tm.parameters()) == []


def test_npz_checkpoint_loads_across_packages(tmp_path):
    jm = _jax_model()
    cfg = JConfig(n_factors=6, total_iterations=77, learning_rate=0.03,
                  collision_policy="twin")
    j_path = j_ckpt.save_checkpoint(str(tmp_path / "jax"), jm, cfg,
                                    extra={"lr": 0.5})
    tm, tcfg, textra = t_ckpt.load_checkpoint(j_path, device="cpu")
    assert vars(tcfg) == vars(cfg) and textra == {"lr": 0.5}
    want = j_to_numpy(jm)
    for k, v in model_to_numpy(tm).items():
        np.testing.assert_array_equal(v, want[k])

    t_path = t_ckpt.save_checkpoint(str(tmp_path / "torch.npz"), tm,
                                    TConfig(**vars(cfg)), extra={"it": 3})
    assert t_path.endswith("torch.npz")
    jm2, jcfg, jextra = j_ckpt.load_checkpoint(t_path)
    assert vars(jcfg) == vars(cfg) and jextra == {"it": 3}
    got = j_to_numpy(jm2)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # the same keys, in both directions
    with np.load(j_path) as a, np.load(t_path) as b:
        assert sorted(a.files) == sorted(b.files)


def test_component_csvs_match(tmp_path):
    jm = _jax_model(U=4, I=5, F=3)
    tm = model_from_numpy(j_to_numpy(jm), device="cpu")
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jp = j_ckpt.export_components(jm, str(tmp_path / "j"), "m", 3)
    tp = t_ckpt.export_components(tm, str(tmp_path / "t"), "m", 3)
    assert [pathlib.Path(p).name for p in jp] == \
        [pathlib.Path(p).name for p in tp]
    for a, b in zip(jp, tp):
        assert pathlib.Path(a).read_text() == pathlib.Path(b).read_text()
    Q, ib, mu = t_ckpt.load_item_components(
        *(str(tmp_path / "j" / f"m_f3_{c}.csv")
          for c in ("q", "item_bias", "global_bias")))
    jQ, jib, jmu = j_ckpt.load_item_components(
        *(str(tmp_path / "t" / f"m_f3_{c}.csv")
          for c in ("q", "item_bias", "global_bias")))
    np.testing.assert_array_equal(Q, jQ)
    np.testing.assert_array_equal(ib, jib)
    assert mu == jmu


def test_init_model_is_seeded_normal():
    a = t_init(50, 60, 8, 3.0, seed=7, device="cpu")
    b = t_init(50, 60, 8, 3.0, seed=7, device="cpu")
    c = t_init(50, 60, 8, 3.0, seed=8, device="cpu")
    for k, v in model_to_numpy(a).items():
        np.testing.assert_array_equal(v, model_to_numpy(b)[k])
    assert not np.array_equal(model_to_numpy(a)["p"], model_to_numpy(c)["p"])
    std = float(torch.cat([a.P.reshape(-1), a.Q.reshape(-1)]).std())
    assert abs(std - 1.0 / 8) < 0.02
    assert float(a.global_bias) == 3.0
    # pre-trained item tables pass through untouched
    Q = np.arange(60 * 8, dtype=np.float32).reshape(60, 8)
    d = t_init(5, 60, 8, 3.0, Q=jnp.asarray(Q), item_bias=np.ones(60),
               device="cpu")
    np.testing.assert_array_equal(d.Q.numpy(), Q)
    np.testing.assert_array_equal(d.item_bias.numpy(), np.ones(60))
