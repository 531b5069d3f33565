"""The port's native host library (``csrc/ingest.cpp`` through
``data/native.py``) against the TPU package's on the same inputs: the same
arrays bit for bit, the same file bytes, the same mutated mappings; and its
failure behaviour — a compiler that fails raises, ``CU2REC_NO_NATIVE=1``
gives the NumPy path with the same arrays, a ragged matrix gives the Python
reader's error."""

import pathlib

import numpy as np
import pytest

from cu2rec_torch.csrc import build as t_build
from cu2rec_torch.data import native as t_native
from cu2rec_torch.data import ratings as t_ratings
from cu2rec_tpu.data import native as j_native

REPO = pathlib.Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data"
RATINGS = sorted(p.name for p in DATA.glob("*ratings*.csv"))


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    monkeypatch.delenv("CU2REC_NO_NATIVE", raising=False)
    if j_native.get_lib() is None:
        pytest.skip("the TPU package's native library did not build")


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("path", [str(DATA / n) for n in RATINGS]
                         + [str(REPO / "data" / "ml100k_ratings.csv")])
def test_read_ratings_is_bit_identical(path):
    before = t_native.CALLS
    t = t_native.native_read_ratings(path, ord(","), 1)
    assert t_native.CALLS == before + 1
    _same(t, j_native.native_read_ratings(path, ord(","), 1))
    assert t[0].shape[0] > 0


def test_read_ratings_skips_lines_and_other_delimiters(tmp_path):
    p = tmp_path / "r.txt"
    p.write_text("7 3 4.5\n 8\t9 1e0\nbad line\n9  2  -2.25\n")
    for skip in (0, 1):
        _same(t_native.native_read_ratings(str(p), ord(" "), skip),
              j_native.native_read_ratings(str(p), ord(" "), skip))


def test_write_matrix_is_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    for rows, cols in ((1, 1), (37, 5), (3000, 17)):
        data = (rng.normal(0, 3, (rows, cols))
                * 10.0 ** rng.integers(-7, 6, (rows, cols))).astype(
                    np.float32)
        a, b = tmp_path / "t.csv", tmp_path / "j.csv"
        t_native.native_write_matrix(str(a), data, rows, cols)
        j_native.native_write_matrix(str(b), data, rows, cols)
        assert a.read_bytes() == b.read_bytes()
        flat, r, c = t_native.native_read_matrix(str(a))
        jflat, jr, jc = j_native.native_read_matrix(str(a))
        assert (r, c) == (jr, jc) == (rows, cols)
        np.testing.assert_array_equal(flat.view(np.int32),
                                      jflat.view(np.int32))


def test_write_ratings_is_byte_identical(tmp_path):
    rng = np.random.default_rng(1)
    n = 70_000
    users = rng.integers(0, 5000, n).astype(np.int32)
    items = rng.integers(0, 900, n).astype(np.int32)
    ratings = rng.normal(3.5, 1.2, n).astype(np.float32)
    for header in ("userId,itemId,rating", ""):
        a, b = tmp_path / "t.csv", tmp_path / "j.csv"
        t_native.native_write_ratings(str(a), users, items, ratings, header)
        j_native.native_write_ratings(str(b), users, items, ratings, header)
        assert a.read_bytes() == b.read_bytes()


def test_write_ratings_mapped_is_byte_identical(tmp_path):
    rng = np.random.default_rng(2)
    n = 50_000
    users = rng.integers(1, 10**12, n)
    items = rng.integers(1, 4000, n)
    table = ["0.5", "1.0", "3.7", "4.25", "5.0"]
    vidx = rng.integers(0, len(table), n)
    a, b = tmp_path / "t.csv", tmp_path / "j.csv"
    t_native.native_write_ratings_mapped(str(a), users, items, vidx, table)
    j_native.native_write_ratings_mapped(str(b), users, items, vidx, table)
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("add_missing", [True, False])
def test_factorize_gives_the_same_codes_and_mappings(add_missing):
    rng = np.random.default_rng(3)
    ids = rng.choice(np.array([-7, 0, 5, 2**62, -(2**61), 123456789012],
                              np.int64), 3000)
    ids = np.concatenate([ids, rng.integers(-10**15, 10**15, 2000)])
    t_map, j_map = {5: 1, 99: 2}, {5: 1, 99: 2}
    t = t_native.native_factorize(ids, t_map, add_missing)
    j = j_native.native_factorize(ids, j_map, add_missing)
    _same([t], [j])
    assert t_map == j_map and list(t_map) == list(j_map)


def test_sort_by_user_is_identical():
    rng = np.random.default_rng(4)
    n = 100_000    # above the library's one-thread cut-off of 65,536
    users = rng.integers(1, 3000, n)
    items = rng.integers(1, 700, n)
    ratings = rng.normal(3, 1, n).astype(np.float32)
    t = t_native.native_sort_by_user(users, items, ratings, 3000)
    _same(t, j_native.native_sort_by_user(users, items, ratings, 3000))
    np.testing.assert_array_equal(t[0], np.sort(users, kind="stable"))
    with pytest.raises(ValueError, match="out of range"):
        t_native.native_sort_by_user(users, items, ratings, 100)


def test_csr_build_is_identical():
    rng = np.random.default_rng(5)
    n = 80_000
    users = rng.integers(0, 2000, n).astype(np.int32)
    items = rng.integers(0, 500, n).astype(np.int32)
    ratings = rng.normal(3, 1, n).astype(np.float32)
    t = t_native.native_csr_build(users, items, ratings, 2001)
    _same(t, j_native.native_csr_build(users, items, ratings, 2001))
    with pytest.raises(ValueError, match="out of range"):
        t_native.native_csr_build(users, items, ratings, 1000)


def test_ragged_matrix_gives_the_python_readers_error(tmp_path):
    p = tmp_path / "ragged.csv"
    p.write_text("1.0,2.0\n3.0\n")
    with pytest.raises(t_native.MalformedInput):
        t_native.native_read_matrix(str(p))
    with pytest.raises(ValueError) as t_err:
        t_ratings.read_array(str(p))
    with pytest.raises(ValueError) as j_err:
        t_ratings._read_array_python(str(p))
    assert str(t_err.value) == str(j_err.value)
    # A file the native reader rejects but Python reads: Python's result.
    q = tmp_path / "underscore.csv"
    q.write_text("1_0,2.5\n")
    flat, rows, cols = t_ratings.read_array(str(q))
    assert (rows, cols) == (1, 2) and flat.tolist() == [10.0, 2.5]


def test_a_compiler_that_fails_raises(tmp_path, monkeypatch):
    """A build that fails raises with the compiler's output, from the build
    and from a reader's first use: no fall-back to NumPy."""
    monkeypatch.setattr(t_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(t_build, "gxx", lambda: "false")
    with pytest.raises(RuntimeError, match="false failed for ingest.cpp"):
        t_build.build_host("ingest")
    monkeypatch.setattr(t_native, "_LIB", None)
    with pytest.raises(RuntimeError, match="false failed for ingest.cpp"):
        t_ratings.read_ratings_csv(str(DATA / "test_ratings.csv"))
    assert not list((tmp_path / "build").rglob("*.so*"))


def test_no_compiler_takes_the_numpy_path_and_says_so(tmp_path, monkeypatch,
                                                      capsys):
    monkeypatch.setattr(t_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(t_build, "gxx", lambda: None)
    monkeypatch.setattr(t_native, "_LIB", None)
    monkeypatch.setattr(t_native, "_WARNED", False)
    path = str(DATA / "test_ratings.csv")
    a = t_ratings.read_ratings_csv(path)
    b = t_ratings.read_ratings_csv(path)
    assert capsys.readouterr().err.count("no host C++ compiler") == 1
    for f in ("users", "items", "ratings"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("path", [str(DATA / n) for n in RATINGS]
                         + [str(REPO / "data" / "ml100k_ratings_test.csv")])
def test_no_native_switch_gives_the_same_arrays(path, monkeypatch):
    native = t_ratings.read_ratings_csv(path)
    before = t_native.CALLS
    monkeypatch.setenv("CU2REC_NO_NATIVE", "1")
    assert not t_native.available()
    plain = t_ratings.read_ratings_csv(path)
    assert t_native.CALLS == before
    for f in ("users", "items", "ratings"):
        x, y = getattr(native, f), getattr(plain, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert (native.n_users, native.n_items, native.global_bias) == \
        (plain.n_users, plain.n_items, plain.global_bias)
