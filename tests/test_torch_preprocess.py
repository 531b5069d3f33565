"""The port's host tools against the TPU package's on the same inputs: the
id mapper, the splits, the sort, the Netflix mapper and the ``.npy``
conversion; the preprocessing CLIs (``map_items``, ``map_netflix``,
``split`` on both paths, ``sort_ratings``, ``create_config``,
``convert_to_np``, ``synth``, ``get_data``); the CPU baseline
(``reference_step``, ``sequential_train``, ``mf_cpu``); and the standalone
scorer ``evaluate --device cpu``.

Files must be byte-identical, arrays bit-identical and mappings equal;
``evaluate`` agrees within 1e-6 (the two packages sum the squared errors in
another order).  Each native-path case also runs with the port's NumPy
path (``CU2REC_NO_NATIVE=1``) against the TPU package's native one.
"""

import hashlib
import json
import pathlib
import zipfile

import numpy as np
import pytest

from cu2rec_torch.cli import convert_to_np as t_convert_cli
from cu2rec_torch.cli import create_config as t_create_config
from cu2rec_torch.cli import evaluate as t_evaluate
from cu2rec_torch.cli import get_data as t_get_data
from cu2rec_torch.cli import map_items as t_map_items
from cu2rec_torch.cli import map_netflix as t_map_netflix
from cu2rec_torch.cli import mf_cpu as t_mf_cpu
from cu2rec_torch.cli import sort_ratings as t_sort_ratings
from cu2rec_torch.cli import split as t_split
from cu2rec_torch.cli import synth as t_synth_cli
from cu2rec_torch.data import convert as t_convert
from cu2rec_torch.data import mapping as t_mapping
from cu2rec_torch.data import netflix as t_netflix
from cu2rec_torch.data import sort as t_sort
from cu2rec_torch.data import split as t_splitmod
from cu2rec_torch.data.csr import build_csr as t_build_csr
from cu2rec_torch.data.ratings import read_ratings_csv as t_read
from cu2rec_torch.train import reference as t_reference
from cu2rec_torch.utils.checkpoint import export_components, save_checkpoint
from cu2rec_torch.models.state import model_from_numpy
from cu2rec_torch.utils.config import Config as TConfig
from cu2rec_tpu.cli import convert_to_np as j_convert_cli
from cu2rec_tpu.cli import create_config as j_create_config
from cu2rec_tpu.cli import evaluate as j_evaluate
from cu2rec_tpu.cli import get_data as j_get_data
from cu2rec_tpu.cli import map_items as j_map_items
from cu2rec_tpu.cli import map_netflix as j_map_netflix
from cu2rec_tpu.cli import mf_cpu as j_mf_cpu
from cu2rec_tpu.cli import sort_ratings as j_sort_ratings
from cu2rec_tpu.cli import split as j_split
from cu2rec_tpu.cli import synth as j_synth_cli
from cu2rec_tpu.data import convert as j_convert
from cu2rec_tpu.data import mapping as j_mapping
from cu2rec_tpu.data import netflix as j_netflix
from cu2rec_tpu.data import sort as j_sort
from cu2rec_tpu.data import split as j_splitmod
from cu2rec_tpu.data.csr import build_csr as j_build_csr
from cu2rec_tpu.data.ratings import read_ratings_csv as j_read
from cu2rec_tpu.train import reference as j_reference
from cu2rec_tpu.utils.config import Config as JConfig

REPO = pathlib.Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data"
ML100K = REPO / "data"
COMPONENTS = ("p", "q", "user_bias", "item_bias", "global_bias")


@pytest.fixture(params=["native", "numpy"])
def port_path(request, monkeypatch):
    """Which path the port takes; the TPU package always takes its native
    one (its calls below run before the switch is set)."""
    monkeypatch.delenv("CU2REC_NO_NATIVE", raising=False)

    def switch():
        if request.param == "numpy":
            monkeypatch.setenv("CU2REC_NO_NATIVE", "1")
    return switch


def _raw_rows(seed, n=600):
    rng = np.random.default_rng(seed)
    return [(int(u), int(i), float(r)) for u, i, r in
            zip(rng.integers(1, 80, n) * 7, rng.integers(1, 50, n) * 3,
                rng.integers(1, 11, n) / 2.0)]


def _write_rows(path, rows, header=True):
    path.write_text(("userId,itemId,rating\n" if header else "")
                    + "".join(f"{u},{i},{r}\n" for u, i, r in rows))
    return path


def _run(main, args, capsys):
    capsys.readouterr()
    assert main(args) == 0
    return capsys.readouterr().out


# -- data/mapping.py ---------------------------------------------------------

def test_map_file_matches_with_and_without_missing(tmp_path, port_path):
    raw = _write_rows(tmp_path / "raw.csv", _raw_rows(3))
    rows2 = [(7, 999999, 1.0), (888888, 999999, 2.0), (14, 3, 3.0)]
    raw2 = _write_rows(tmp_path / "raw2.csv", rows2)
    j_um, j_im = {}, {}
    j1 = j_mapping.map_file(str(raw), j_um, j_im)
    j2 = j_mapping.map_file(str(raw2), j_um, j_im, add_missing=False)
    port_path()
    t_um, t_im = {}, {}
    t1 = t_mapping.map_file(str(raw), t_um, t_im)
    t2 = t_mapping.map_file(str(raw2), t_um, t_im, add_missing=False)
    for t, j in ((t1, j1), (t2, j2)):
        for x, y in zip(t, j):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert (t_um, t_im) == (j_um, j_im)
    assert list(t_um) == list(j_um) and 999999 not in t_im


@pytest.mark.parametrize("content", [
    "userId,itemId,rating\n900,7,4.0\n900,9,3.0\n5,7,5.0\n5,2,1.0\n"
    "77,9,2.0\n900,2,4.5\n",
    "userId,itemId,rating\n9,4,3.7\n9,5,2.6\n3,4,5\n",
    "userId,itemId,rating\n",
    "",
    "userId,itemId,rating\n-5,7,1.5\n4611686018427387904,-1,2.0\n"
    "-5,-2305843009213693952,3.25\n",
], ids=["fixture", "non_f32_exact", "header_only", "empty", "extreme_ids"])
def test_process_file_is_byte_identical(tmp_path, port_path, content):
    raw = tmp_path / "raw.csv"
    raw.write_text(content)
    j_mapping.process_file(str(raw), str(tmp_path / "j.csv"))
    port_path()
    t_mapping.process_file(str(raw), str(tmp_path / "t.csv"))
    assert (tmp_path / "t.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()


def test_int64_min_id_takes_the_numpy_path(tmp_path):
    ids = np.array([5, np.iinfo(np.int64).min, 5, 9], np.int64)
    t_map = {}
    codes, known = t_mapping.assign_sequential(ids, t_map)
    assert codes.tolist() == [1, 2, 1, 3] and known.all()
    assert t_map == {5: 1, np.iinfo(np.int64).min: 2, 9: 3}


def test_map_arrays_and_sort_by_user_match(port_path):
    rng = np.random.default_rng(6)
    users = rng.integers(-10**12, 10**12, 70_000) // 10**8
    items = rng.integers(0, 3000, 70_000) * 11
    ratings = rng.normal(3, 1, 70_000).astype(np.float32)
    j = j_mapping.map_arrays(users, items)
    js = j_mapping.sort_by_user(j[0], j[1], ratings)
    port_path()
    t = t_mapping.map_arrays(users, items)
    ts = t_mapping.sort_by_user(t[0], t[1], ratings)
    for x, y in zip(t[:2] + ts, j[:2] + js):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert t[2:] == j[2:]


# -- data/netflix.py, data/split.py, data/sort.py, data/convert.py -----------

def test_netflix_mapping_flow_is_byte_identical(tmp_path, capsys, port_path):
    train = tmp_path / "nf_train.txt"
    train.write_text("10 5 3\n10 6 4\n20 5 5\n")
    test = tmp_path / "nf_test.txt"
    test.write_text("10 5 2\n30 5 1\n10 99 4\n")
    outs = {}
    for name, process in (("j", j_netflix.process_netflix),
                          ("t", t_netflix.process_netflix)):
        if name == "t":
            port_path()
        capsys.readouterr()
        to, vo = tmp_path / f"{name}_tr.csv", tmp_path / f"{name}_te.csv"
        process(str(train), str(to), str(test), str(vo))
        outs[name] = (to.read_bytes(), vo.read_bytes(),
                      capsys.readouterr().out)
    assert outs["t"] == outs["j"]
    assert outs["t"][1] == b"userId,itemId,rating\n1,1,2.0\n"
    assert "Skipped 1 rows because of missing users" in outs["t"][2]


@pytest.mark.parametrize("seed", [0, 7])
def test_splits_and_sort_match(tmp_path, seed):
    rows = _raw_rows(11, 300)
    path = _write_rows(tmp_path / "r.csv", rows)
    assert t_splitmod.read_rating_rows(str(path)) == \
        j_splitmod.read_rating_rows(str(path))
    for fn in ("split_true", "split_per_user"):
        t = getattr(t_splitmod, fn)(rows, 0.8, seed=seed)
        assert t == getattr(j_splitmod, fn)(rows, 0.8, seed=seed)
        assert sorted(t[0] + t[1]) == sorted(rows)
    assert t_sort.sort_rows(rows) == j_sort.sort_rows(rows)
    t_sort.sort_ratings_file(str(path), str(tmp_path / "t.csv"))
    j_sort.sort_ratings_file(str(path), str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()


def test_save_as_npy_matches(tmp_path, port_path):
    rng = np.random.default_rng(8)
    m = rng.normal(0, 1, (40, 7)).astype(np.float32)
    np.savetxt(tmp_path / "m.csv", m, fmt="%f", delimiter=",")
    j = np.load(j_convert.save_as_npy(str(tmp_path / "m.csv"),
                                      str(tmp_path / "j.npy")))
    port_path()
    t_path = t_convert.save_as_npy(str(tmp_path / "m.csv"))
    assert t_path == str(tmp_path / "m.npy")
    t = np.load(t_path)
    assert t.dtype == j.dtype == np.float32
    np.testing.assert_array_equal(t, j)


# -- the preprocessing CLIs --------------------------------------------------

def _twin_dirs(tmp_path, files):
    """The same input files in two directories, "j" and "t"."""
    dirs = {}
    for name in ("j", "t"):
        d = tmp_path / name
        d.mkdir()
        for fname, content in files.items():
            (d / fname).write_bytes(content)
        dirs[name] = d
    return dirs


def _same_tree(dirs):
    a = {p.name: p.read_bytes() for p in sorted(dirs["t"].iterdir())}
    b = {p.name: p.read_bytes() for p in sorted(dirs["j"].iterdir())}
    assert a.keys() == b.keys()
    for name in a:
        assert a[name] == b[name], name
    return a


@pytest.mark.parametrize("split_args", [["0.4", "-s", "1"],
                                        ["0.25", "--per-user"],
                                        ["0.3", "-s", "5", "--fast"]],
                         ids=["true", "per_user", "fast"])
def test_map_items_split_and_sort_clis_are_byte_identical(
        tmp_path, capsys, port_path, split_args):
    raw = "".join(f"{u},{i},{r}\n" for u, i, r in _raw_rows(4, 400))
    dirs = _twin_dirs(tmp_path, {"raw.csv": b"userId,itemId,rating\n"
                                 + raw.encode()})
    for name, (mi, sp, so) in (
            ("j", (j_map_items, j_split, j_sort_ratings)),
            ("t", (t_map_items, t_split, t_sort_ratings))):
        if name == "t":
            port_path()
        d = dirs[name]
        _run(mi.main, [str(d / "raw.csv")], capsys)
        _run(sp.main, [str(d / "raw_mapped.csv")] + split_args, capsys)
        _run(so.main, [str(d / "raw_mapped.csv")], capsys)
        _run(so.main, [str(d / "raw_mapped_train.csv"), "-o",
                       str(d / "train_sorted.csv")], capsys)
    files = _same_tree(dirs)
    assert {"raw_mapped.csv", "raw_mapped_train.csv", "raw_mapped_test.csv",
            "raw_mapped_sorted.csv", "train_sorted.csv"} <= files.keys()


def test_split_takes_the_fast_path_above_32_mib(monkeypatch):
    seen = []
    monkeypatch.setattr(t_split, "fast_split",
                        lambda *a: seen.append(a))
    monkeypatch.setattr(t_split.os.path, "getsize",
                        lambda p: t_split.FAST_BYTES + 1)
    assert t_split.FAST_BYTES == 32 << 20
    assert t_split.main(["r.csv", "0.1"]) == 0
    assert seen == [("r.csv", "r_train.csv", "r_test.csv", 0.9, 42)]


def test_map_netflix_cli_is_byte_identical(tmp_path, capsys, port_path):
    dirs = _twin_dirs(tmp_path, {"tr.txt": b"10 5 3\n10 6 4\n20 5 5\n",
                                 "te.txt": b"10 5 2\n30 5 1\n10 99 4\n"})
    for name, mod in (("j", j_map_netflix), ("t", t_map_netflix)):
        if name == "t":
            port_path()
        d = dirs[name]
        _run(mod.main, [str(d / "tr.txt"), str(d / "te.txt")], capsys)
        _run(mod.main, [str(d / "tr.txt")], capsys)
    assert "tr_mapped.txt" in _same_tree(dirs)


@pytest.mark.parametrize("extra", [[], ["--extended"], ["--json"]])
def test_create_config_cli_writes_the_same_file(tmp_path, capsys, extra):
    args = ["--total_iterations", "42", "--n_factors", "16",
            "--learning_rate", "0.01", "--patience", "3"] + extra
    _run(j_create_config.main, [str(tmp_path / "j.cfg")] + args, capsys)
    _run(t_create_config.main, [str(tmp_path / "t.cfg")] + args, capsys)
    assert (tmp_path / "t.cfg").read_bytes() == \
        (tmp_path / "j.cfg").read_bytes()
    t, j = TConfig(), JConfig()
    t.read_config(str(tmp_path / "t.cfg"))
    j.read_config(str(tmp_path / "j.cfg"))
    assert t.total_iterations == 42 and vars(t) == vars(j)


def test_convert_to_np_cli_matches(tmp_path, capsys, port_path):
    dirs = _twin_dirs(tmp_path, {"a.csv": b"1.0,2.0\n3.0,4.5\n",
                                 "b.csv": b"0.125\n-7.5\n\n"})
    for name, mod in (("j", j_convert_cli), ("t", t_convert_cli)):
        if name == "t":
            port_path()
        d = dirs[name]
        out = _run(mod.main, [str(d / "a.csv"), str(d / "b.csv")], capsys)
        assert out.split() == [str(d / "a.npy"), str(d / "b.npy")]
    for f in ("a.npy", "b.npy"):
        np.testing.assert_array_equal(np.load(dirs["t"] / f),
                                      np.load(dirs["j"] / f))


@pytest.mark.parametrize("args", [
    ["--users", "300", "--items", "80", "--ratings", "6000", "--seed", "3"],
    ["--preset", "ml100k", "--ratings", "5000", "--clip", "--factors", "8"],
    ["--users", "200", "--items", "90", "--ratings", "4000", "--implicit",
     "--seed", "2"],
], ids=["explicit", "preset_clip", "implicit"])
def test_synth_cli_is_byte_identical(tmp_path, capsys, port_path, args):
    dirs = _twin_dirs(tmp_path, {})
    for name, mod in (("j", j_synth_cli), ("t", t_synth_cli)):
        if name == "t":
            port_path()
        out = _run(mod.main, [str(dirs[name] / "raw.csv")] + args, capsys)
        assert out.startswith("Generated ")
    files = _same_tree(dirs)
    assert json.loads(files["raw.csv.meta.json"])["seed"] in (0, 2, 3)


def _movielens_zip(path, member):
    rows = ["userId,movieId,rating,timestamp", "7,10,4.0,111",
            "7,30,3.0,112", "3,10,5.0,113", "3,20,1.0,114", "9,20,2.0,115",
            "12,30,3.5,116", "9,10,0.5,117"]
    with zipfile.ZipFile(path, "w") as z:
        z.writestr(member, "\n".join(rows) + "\n")
    return hashlib.md5(path.read_bytes()).hexdigest()


def test_get_data_cli_matches_offline(tmp_path, capsys, port_path):
    # The plan of a dry run, with nothing written.
    for mod in (j_get_data, t_get_data):
        out = tmp_path / "plan"
        plan = json.loads(_run(mod.main, ["ml20m", "--outdir", str(out),
                                           "--dry-run"], capsys))
        assert plan["member"] == "ml-20m/ratings.csv" and not out.exists()
    archive = tmp_path / "ml-20m.zip"
    md5 = _movielens_zip(archive, "ml-20m/ratings.csv")
    dirs = {}
    for name, mod in (("j", j_get_data), ("t", t_get_data)):
        if name == "t":
            port_path()
        out = tmp_path / f"out_{name}"
        # The pinned checksum is enforced on a local archive too.
        capsys.readouterr()
        assert mod.main(["ml20m", "--outdir", str(out), "--archive",
                         str(archive)]) == 1
        assert "checksum mismatch" in capsys.readouterr().err
        _run(mod.main, ["ml20m", "--outdir", str(out), "--archive",
                        str(archive), "--md5", md5, "--test-fraction",
                        "0.3"], capsys)
        dirs[name] = out
    files = _same_tree(dirs)
    assert sorted(files) == ["ratings_mapped.csv", "ratings_mapped_test.csv",
                             "ratings_mapped_train.csv"]
    assert files["ratings_mapped.csv"].count(b"\n") == 8


def test_get_data_refuses_an_unpinned_checksum(tmp_path, capsys):
    archive = tmp_path / "ml-100k.zip"
    with zipfile.ZipFile(archive, "w") as z:
        z.writestr("ml-100k/u.data", "7\t10\t4\t111\n3\t10\t5\t113\n"
                   "3\t20\t1\t114\n")
    outs = {}
    for name, mod in (("j", j_get_data), ("t", t_get_data)):
        out = tmp_path / f"classic_{name}"
        capsys.readouterr()
        assert mod.main(["ml100k-classic", "--outdir", str(out),
                         "--archive", str(archive)]) == 1
        err = capsys.readouterr().err
        assert "no pinned checksum" in err and "--no-checksum" in err
        assert not (out / "ratings_mapped.csv").exists()
        md5 = hashlib.md5(archive.read_bytes()).hexdigest()
        _run(mod.main, ["ml100k-classic", "--outdir", str(out), "--archive",
                        str(archive), "--md5", md5], capsys)
        outs[name] = (out / "ratings_mapped.csv").read_bytes()
    assert outs["t"] == outs["j"]


# -- the CPU baseline: train/reference.py and mf_cpu -------------------------

def test_reference_step_matches():
    rng = np.random.default_rng(12)
    U, I, F = 40, 15, 6
    P = rng.normal(0, 0.1, (U, F)).astype(np.float32)
    Q = rng.normal(0, 0.1, (I, F)).astype(np.float32)
    ub = rng.normal(0, 0.1, U).astype(np.float32)
    ib = rng.normal(0, 0.1, I).astype(np.float32)
    items = rng.integers(0, I, U)
    ratings = rng.integers(1, 11, U).astype(np.float32) / 2
    has = rng.random(U) < 0.8
    prio = rng.permutation(U).astype(np.int64)
    for kw in (dict(), dict(collision="mean"), dict(train_items=False)):
        t = t_reference.reference_step(P, Q, ub, ib, 3.5, items, ratings,
                                       has, prio, 0.05, 0.02, 0.02, 0.02,
                                       0.02, **kw)
        j = j_reference.reference_step(P, Q, ub, ib, 3.5, items, ratings,
                                       has, prio, 0.05, 0.02, 0.02, 0.02,
                                       0.02, **kw)
        for x, y in zip(t, j):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_sequential_train_matches(data_dir, capsys):
    rd_t = t_read(str(data_dir / "test_ratings.csv"))
    rd_j = j_read(str(data_dir / "test_ratings.csv"))
    cfg_t, cfg_j = TConfig(), JConfig()
    for cfg in (cfg_t, cfg_j):
        cfg.read_config(str(data_dir / "train.cfg"))
        cfg.total_iterations, cfg.check_error = 7, 3
    t, t_losses = t_reference.sequential_train(
        t_build_csr(rd_t), t_build_csr(rd_t), cfg_t, rd_t.global_bias)
    t_out = capsys.readouterr().out
    j, j_losses = j_reference.sequential_train(
        j_build_csr(rd_j), j_build_csr(rd_j), cfg_j, rd_j.global_bias)
    assert capsys.readouterr().out == t_out and "TEST: Iteration 7 CPU" \
        in t_out
    assert t_losses == j_losses and list(t_losses) == [1, 3, 6, 7]
    for c in COMPONENTS:
        assert t[c].dtype == j[c].dtype
        np.testing.assert_array_equal(t[c], j[c])


@pytest.mark.parametrize("train", ["test_ratings.csv", "test_ratings3.csv"])
def test_mf_cpu_cli_is_byte_identical(tmp_path, capsys, port_path, train):
    files = {"r.csv": (DATA / train).read_bytes(),
             "cfg.txt": b"0 5 3 0.05 42 0.02 0.02 0.02 0.02\n"}
    dirs = _twin_dirs(tmp_path, files)
    outs = {}
    for name, mod in (("j", j_mf_cpu), ("t", t_mf_cpu)):
        if name == "t":
            port_path()
        d = dirs[name]
        out = _run(mod.main, ["-c", str(d / "cfg.txt"), str(d / "r.csv"),
                              str(d / "r.csv")], capsys)
        outs[name] = [ln for ln in out.splitlines()
                      if not ln.startswith("Time taken")]
        assert "Time taken for 5 of iterations" in out
    assert outs["t"] == outs["j"]
    assert "r_f3_q.csv" in _same_tree(dirs)


# -- evaluate ----------------------------------------------------------------

def _random_model(tmp_path, n_users, n_items, F, seed):
    """A seeded model as a checkpoint and as the five component CSVs."""
    rng = np.random.default_rng(seed)
    comps = {"p": rng.normal(0, 0.3, (n_users, F)),
             "q": rng.normal(0, 0.3, (n_items, F)),
             "user_bias": rng.normal(0, 0.2, n_users),
             "item_bias": rng.normal(0, 0.2, n_items),
             "global_bias": [3.5]}
    model = model_from_numpy(comps, "cpu")
    ck = save_checkpoint(str(tmp_path / "ck.npz"), model, TConfig(
        n_factors=F))
    export_components(model, str(tmp_path), "m", F)
    parts = ["-p", "p", "-q", "q", "-u", "user_bias", "-i", "item_bias",
             "-g", "global_bias"]
    return ck, [a if a.startswith("-") else str(tmp_path / f"m_f{F}_{a}.csv")
                for a in parts]


def _summary(out):
    return json.loads(out.splitlines()[-1])


def _compare_eval(t, j):
    assert t.keys() == j.keys()
    for key in t:
        if isinstance(t[key], float):
            assert abs(t[key] - j[key]) <= 1e-6, key
        else:
            assert t[key] == j[key], key


@pytest.mark.parametrize("case", ["toy", "toy3", "ml100k"])
def test_evaluate_cli_matches(tmp_path, capsys, case):
    if case == "ml100k":
        train = str(ML100K / "ml100k_ratings_train.csv")
        test = str(ML100K / "ml100k_ratings_test.csv")
        extra, F = ["--max-users", "300"], 8
    else:
        train = test = str(DATA / ("test_ratings.csv" if case == "toy"
                                   else "test_ratings3.csv"))
        extra, F = ["-k", "3"], 4
    rds = [t_read(train), t_read(test)]
    shape = (max(r.n_users for r in rds), max(r.n_items for r in rds), F)
    ck, parts = _random_model(tmp_path, *shape, seed=len(case))
    for form in (["--checkpoint", ck], parts):
        base = form + [test]
        runs = {}
        for name, mod, dev in (("j", j_evaluate, []),
                               ("t", t_evaluate, ["--device", "cpu"])):
            plain = _run(mod.main, base + dev, capsys)
            ranked = _run(mod.main, base + dev + ["--ranking", "--train",
                                                  train] + extra, capsys)
            runs[name] = (plain, ranked)
        for k in range(2):
            _compare_eval(_summary(runs["t"][k]), _summary(runs["j"][k]))
        assert runs["t"][0].splitlines()[0].startswith(
            "TEST: Iteration 0 CPU MAE: ")
        t_rank = [ln for ln in runs["t"][1].splitlines()
                  if ln.startswith("RANKING:")]
        j_rank = [ln for ln in runs["j"][1].splitlines()
                  if ln.startswith("RANKING:")]
        assert t_rank == j_rank and len(t_rank) == 1


def test_evaluate_cli_refuses_what_it_cannot_score(tmp_path, capsys):
    ck, parts = _random_model(tmp_path, 3, 2, 4, seed=0)
    with pytest.raises(SystemExit, match="missing: item_bias"):
        t_evaluate.main(parts[:6] + parts[8:] + [str(DATA /
                                                      "test_ratings.csv"),
                                                 "--device", "cpu"])
    with pytest.raises(SystemExit, match="beyond the model tables"):
        t_evaluate.main(["--checkpoint", ck, str(DATA / "test_ratings.csv"),
                         "--device", "cpu"])
