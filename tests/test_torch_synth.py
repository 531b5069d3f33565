"""The port's planted generators and split against the TPU package's: the
same NumPy draws in the same order, so every array is bit-identical
(tolerance zero), and the CSV writer writes the same file."""

import numpy as np
import pytest

from cu2rec_torch.data import synth as t_synth
from cu2rec_tpu.data import synth as j_synth

FIELDS = ("users", "items", "ratings", "P", "Q", "user_bias", "item_bias")


def _same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.mu == b.mu
    np.testing.assert_equal(a.noise_floor, b.noise_floor)


@pytest.mark.parametrize("kw", [
    dict(n_users=300, n_items=80, n_ratings=5000, seed=3),
    dict(n_users=50, n_items=40, n_ratings=3000, n_factors=8, seed=1,
         chunk=700, clip=(1.0, 5.0)),
])
def test_generate_planted_is_bit_identical(kw):
    _same(t_synth.generate_planted(**kw), j_synth.generate_planted(**kw))


@pytest.mark.parametrize("kw", [
    dict(n_users=300, n_items=90, n_ratings=6000, seed=2),
    dict(n_users=130, n_items=70, n_ratings=4000, n_factors=12, seed=5,
         chunk_users=32, oracle_samples=5000),
])
def test_generate_planted_implicit_is_bit_identical(kw):
    t, t_auc = t_synth.generate_planted_implicit(**kw)
    j, j_auc = j_synth.generate_planted_implicit(**kw)
    _same(t, j)
    assert t_auc == j_auc and 0.5 < t_auc <= 1.0
    keys = t.users.astype(np.int64) * kw["n_items"] + t.items
    assert len(np.unique(keys)) == len(keys)        # deduplicated


def test_split_arrays_is_identical():
    d = t_synth.generate_planted(200, 60, 4000, seed=9)
    t = t_synth.split_arrays(d.users, d.items, d.ratings, 0.9, seed=7)
    j = j_synth.split_arrays(d.users, d.items, d.ratings, 0.9, seed=7)
    for ts, js in zip(t, j):
        for x, y in zip(ts, js):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert len(t[0][0]) == 3600 and len(t[1][0]) == 400


def test_write_planted_csv_writes_the_same_file(tmp_path, monkeypatch):
    """The TPU package's writer without its native library (the fallback,
    the format the port writes)."""
    import cu2rec_tpu.data.native as native

    def unavailable(*a, **k):
        raise RuntimeError("native ingest unavailable")

    monkeypatch.setattr(native, "native_write_ratings", unavailable)
    d = t_synth.generate_planted(20, 15, 200, seed=4)
    t_synth.write_planted_csv(d, str(tmp_path / "t.csv"))
    j_synth.write_planted_csv(d, str(tmp_path / "j.csv"))
    text = (tmp_path / "t.csv").read_text()
    assert text == (tmp_path / "j.csv").read_text()
    assert text.startswith("userId,itemId,rating\n")
    assert len(text.splitlines()) == 201
