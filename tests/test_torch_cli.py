"""The port's ``mf`` and ``predict`` CLIs on the CPU against the TPU
package's, with the TPU package's initial tables injected into the port
(its ``init_model`` is patched to return the TPU package's draw): the same
stdout lines, RMSE values within 1e-4, the five component CSVs under the
same names and within 1e-5, checkpoints that resume in either package, and
the same predictions and ranking.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest

from cu2rec_torch.cli import mf as tmf
from cu2rec_torch.cli import predict as tpred
from cu2rec_torch.models.state import model_from_numpy
from cu2rec_tpu.cli import mf as jmf
from cu2rec_tpu.cli import predict as jpred
from cu2rec_tpu.models.state import init_model as j_init_model
from cu2rec_tpu.models.state import model_to_numpy as j_model_to_numpy

# The verify recipe's config: 200 iterations, F=8, lr 0.05, seed 42.
CONFIG = "0 200 8 0.05 42 0.02 0.02 0.02 0.02\n"
COMPONENTS = ("p", "q", "user_bias", "item_bias", "global_bias")


@pytest.fixture
def jax_init(monkeypatch):
    """The port's trainer and fold-in draw the TPU package's init."""
    import cu2rec_torch.serve.foldin as foldin
    import cu2rec_torch.train.trainer as trainer

    def init(n_users, n_items, n_factors, global_bias, seed=42, dtype=None,
             Q=None, item_bias=None, device=None):
        return model_from_numpy(j_model_to_numpy(j_init_model(
            n_users, n_items, n_factors, global_bias, seed=seed, Q=Q,
            item_bias=item_bias)), device)

    monkeypatch.setattr(trainer, "init_model", init)
    monkeypatch.setattr(foldin, "init_model", init)


def _run(main, args, capsys):
    capsys.readouterr()
    assert main(args) == 0
    return capsys.readouterr().out


def _shape(out):
    """Each line with its numbers, paths and device word blanked."""
    out = re.sub(r"(Wrote )\S+", r"\1<path>", out)
    out = re.sub(r"\b(TPU|CPU|GPU)\b", "<device>", out)
    return re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "<n>", out).splitlines()


def _metric_lines(out):
    return [(ln.split()[0], int(ln.split()[2]),
             float(ln.split("MAE:")[1].split()[0]),
             float(ln.split("RMSE:")[1])) for ln in out.splitlines()
            if ln.startswith(("TRAIN:", "TEST:"))]


def _compare_metrics(t_out, j_out, atol=1e-4):
    t, j = _metric_lines(t_out), _metric_lines(j_out)
    assert [x[:2] for x in t] == [x[:2] for x in j] and t
    np.testing.assert_allclose([x[2:] for x in t], [x[2:] for x in j],
                               rtol=0, atol=atol)


def _components(d, base="test_ratings", F=8):
    return {c: np.loadtxt(d / f"{base}_f{F}_{c}.csv", delimiter=",",
                          ndmin=2) for c in COMPONENTS}


@pytest.fixture
def trained(tmp_path, data_dir, jax_init, capsys):
    """Both CLIs trained on the toy fixture: (outputs, component dirs)."""
    cfg = tmp_path / "cfg.txt"
    cfg.write_text(CONFIG)
    train = str(data_dir / "test_ratings.csv")
    outs, dirs = {}, {}
    for name, main, extra in (("jax", jmf.main, []),
                              ("port", tmf.main, ["--device", "cpu"])):
        dirs[name] = tmp_path / name
        outs[name] = _run(main, ["-c", str(cfg), train, train, "--outdir",
                                 str(dirs[name])] + extra, capsys)
    return cfg, outs, dirs


def test_mf_matches_the_tpu_package(trained):
    _, outs, dirs = trained
    assert _shape(outs["port"]) == _shape(outs["jax"])
    assert "TRAIN: Iteration 200 CPU MAE:" in outs["port"]
    _compare_metrics(outs["port"], outs["jax"])
    names = sorted(p.name for p in dirs["port"].iterdir())
    assert names == sorted(p.name for p in dirs["jax"].iterdir())
    assert names == sorted(f"test_ratings_f8_{c}.csv" for c in COMPONENTS)
    a, b = _components(dirs["port"]), _components(dirs["jax"])
    for c in COMPONENTS:
        assert a[c].shape == b[c].shape
        np.testing.assert_allclose(a[c], b[c], rtol=0, atol=1e-5)


SUM_CONFIG = ('{"total_iterations": 200, "n_factors": 8, "learning_rate": '
              '0.05, "seed": 42, "P_reg": 0.02, "Q_reg": 0.02, '
              '"user_bias_reg": 0.02, "item_bias_reg": 0.02, '
              '"collision_policy": "sum"}')


@pytest.mark.parametrize("case,tol", [("bfloat16", 1e-2), ("mean", 1e-4),
                                      ("sum", 1e-4)])
def test_mf_bf16_and_collisions_match_the_tpu_package(
        tmp_path, data_dir, jax_init, capsys, case, tol):
    """``mf --dtype bfloat16``, ``--collision mean`` and ``sum`` from a JSON
    config: the same lines, the RMSEs and the five components within 1e-2
    (bf16: an entry is 2⁻⁸ relative) or 1e-4 of the TPU package's."""
    cfg = tmp_path / "cfg"
    cfg.write_text(SUM_CONFIG if case == "sum" else CONFIG)
    options = {"bfloat16": ["--dtype", "bfloat16"],
               "mean": ["--collision", "mean"], "sum": []}[case]
    train = str(data_dir / "test_ratings.csv")
    outs = {}
    for name, main, extra in (("jax", jmf.main, []),
                              ("port", tmf.main, ["--device", "cpu"])):
        outs[name] = _run(main, ["-c", str(cfg), train, train, "--outdir",
                                 str(tmp_path / name), *options] + extra,
                          capsys)
    assert _shape(outs["port"]) == _shape(outs["jax"])
    _compare_metrics(outs["port"], outs["jax"], tol)
    a, b = _components(tmp_path / "port"), _components(tmp_path / "jax")
    for c in COMPONENTS:
        np.testing.assert_allclose(a[c], b[c], rtol=0, atol=tol)


def test_predict_with_a_bf16_config(trained, data_dir, capsys):
    """A bf16 config folds the user in over bf16 tables in both packages:
    the predictions within 1e-2."""
    _, _, dirs = trained
    comp = dirs["jax"]
    cfg = comp.parent / "bf16.json"
    cfg.write_text('{"total_iterations": 200, "n_factors": 8, '
                   '"learning_rate": 0.05, "seed": 42, "dtype": "bfloat16"}')
    args = ["-c", str(cfg), "-i", str(comp / "test_ratings_f8_item_bias.csv"),
            "-g", str(comp / "test_ratings_f8_global_bias.csv"),
            "-q", str(comp / "test_ratings_f8_q.csv"),
            str(data_dir / "test_user_ratings.csv")]
    j_scores, j_ranks = _predictions(_run(jpred.main, args, capsys))
    t_scores, t_ranks = _predictions(_run(tpred.main, args + ["--device",
                                                              "cpu"], capsys))
    np.testing.assert_allclose(t_scores, j_scores, rtol=0, atol=1e-2)
    assert sorted(i for i, _ in t_ranks) == sorted(i for i, _ in j_ranks)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_resume_in_either_package(tmp_path, data_dir, jax_init,
                                             capsys, writer):
    """A checkpoint written after 100 iterations by one package resumes to
    200 in both, with the same results."""
    train = str(data_dir / "test_ratings.csv")
    cfg100, cfg200 = tmp_path / "c100.txt", tmp_path / "c200.txt"
    cfg100.write_text(CONFIG.replace(" 200 ", " 100 "))
    cfg200.write_text(CONFIG)
    ck = str(tmp_path / "ck.npz")
    mains = {"jax": (jmf.main, []), "port": (tmf.main, ["--device", "cpu"])}
    main, extra = mains[writer]
    _run(main, ["-c", str(cfg100), train, train, "--outdir",
                str(tmp_path / "w"), "--checkpoint", ck] + extra, capsys)
    outs = {}
    for name, (main, extra) in mains.items():
        outs[name] = _run(main, ["--resume", ck, "-c", str(cfg200), train,
                                 train, "--outdir", str(tmp_path / name)]
                          + extra, capsys)
        assert f"Resuming from {ck} at iteration 100" in outs[name]
        assert "TRAIN: Iteration 1 " not in outs[name]
        assert re.search(r"TEST: Iteration 200 \w+ MAE", outs[name])
    _compare_metrics(outs["port"], outs["jax"])
    a, b = _components(tmp_path / "port"), _components(tmp_path / "jax")
    for c in COMPONENTS:
        np.testing.assert_allclose(a[c], b[c], rtol=0, atol=1e-5)


def _predictions(out):
    lines = out.splitlines()
    i = lines.index("Predictions: ")
    scores = np.array([float(x) for x in
                       lines[i + 1].strip("[], ").split(",")])
    ranks = [(int(ln.split("Item:")[1].split()[0]),
              float(ln.split("rating:")[1])) for ln in lines
             if ln.startswith("Rank:")]
    return scores, ranks


@pytest.mark.parametrize("implicit", [False, True])
def test_predict_matches_the_tpu_package(trained, data_dir, capsys,
                                         implicit):
    cfg, _, dirs = trained
    comp = dirs["jax"]
    args = ["-c", str(cfg), "-i", str(comp / "test_ratings_f8_item_bias.csv"),
            "-g", str(comp / "test_ratings_f8_global_bias.csv"),
            "-q", str(comp / "test_ratings_f8_q.csv"),
            str(data_dir / "test_user_ratings.csv")]
    if implicit:
        args += ["--implicit", "--alpha", "5", "--reg", "0.1"]
    j_scores, j_ranks = _predictions(_run(jpred.main, args, capsys))
    t_out = _run(tpred.main, args + ["--device", "cpu"], capsys)
    t_scores, t_ranks = _predictions(t_out)
    np.testing.assert_allclose(t_scores, j_scores, rtol=0, atol=1e-4)
    # Rated items (0-based 0, 1, 3) are absent; the rest are ranked.
    assert sorted(i for i, _ in t_ranks) == [2, 4]
    assert len(t_ranks) == len(j_ranks)
    for n, ((ti, ts), (ji, _)) in enumerate(zip(t_ranks, j_ranks)):
        near = [abs(ts - t_ranks[m][1]) <= 1e-5
                for m in (n - 1, n + 1) if 0 <= m < len(t_ranks)]
        if not any(near):
            assert ti == ji
        assert ts == pytest.approx(float(t_scores[ti]), abs=1e-5)


# ---- the other training families: --algo als | ials | bpr -----------------

FAMILY_CONFIG = "0 4 8 0.05 42 0.05 0.05 0.02 0.02\n"
# The toy fixture's ratings held out for the implicit families' test split.
HELD_OUT = {"1,5,5.0", "3,3,4.0", "5,4,4.0", "6,5,5.0"}


@pytest.fixture
def family_init(monkeypatch):
    """The port's ALS, iALS and BPR trainers draw the TPU package's init."""
    import cu2rec_torch.train.als as als
    import cu2rec_torch.train.bpr as bpr
    import cu2rec_torch.train.ials as ials

    def init(n_users, n_items, n_factors, global_bias, seed=42, dtype=None,
             Q=None, item_bias=None, device=None):
        # A bf16 draw crosses exactly as float32; the trainers cast back.
        jdtype = (jnp.bfloat16 if str(dtype).endswith("bfloat16")
                  else jnp.float32)
        return model_from_numpy(j_model_to_numpy(j_init_model(
            n_users, n_items, n_factors, global_bias, seed=seed,
            dtype=jdtype)), device)

    for mod in (als, bpr, ials):
        monkeypatch.setattr(mod, "init_model", init)


def _implicit_lines(out):
    """[(prefix, iteration, (auc, recall, ndcg))] of the implicit lines."""
    rows = []
    for ln in out.splitlines():
        m = re.match(r"^(IALS sweep|BPR iteration) (\d+): AUC = (\S+)  "
                     r"recall@\d+ = (\S+)  ndcg@\d+ = (\S+)$", ln)
        if m:
            rows.append((m[1], int(m[2]), tuple(map(float, m.groups()[2:]))))
    return rows


@pytest.mark.parametrize("algo", ["als", "ials", "bpr"])
def test_mf_families_match_the_tpu_package(tmp_path, data_dir, family_init,
                                           capsys, algo):
    """ALS trains and tests on the toy fixture (RMSE within 1e-4); iALS and
    BPR on a split of it, so that every held-out item ranks by a real
    score (AUC, recall@k and NDCG@k as printed, within 2e-4).  Components
    within 1e-4.  iALS runs at alpha 2 and λ = 1: at F=8 over 5 items the
    Gramian is singular and only λ holds the systems, so a large alpha or a
    small λ would magnify float32 rounding beyond any tolerance in both
    packages alike."""
    _family_run(tmp_path, data_dir, capsys, algo)


def _family_run(tmp_path, data_dir, capsys, algo, options=(),
                metric_tol=None, comp_tol=1e-4):
    """``mf --algo algo [options]`` through both packages on the toy
    fixture (iALS and BPR on a split of it), the outputs compared: RMSE
    within ``metric_tol`` (1e-4 by default), the implicit metrics within
    ``metric_tol`` (2e-4 by default), the components within ``comp_tol``."""
    cfg = tmp_path / "cfg.txt"
    cfg.write_text(FAMILY_CONFIG if algo != "ials" else
                   FAMILY_CONFIG.replace("0.05 0.05", "1.0 1.0"))
    lines = (data_dir / "test_ratings.csv").read_text().splitlines()
    if algo == "als":
        train = test = str(data_dir / "test_ratings.csv")
    else:
        train, test = str(tmp_path / "train.csv"), str(tmp_path / "test.csv")
        (tmp_path / "train.csv").write_text("\n".join(
            [lines[0]] + [ln for ln in lines[1:] if ln not in HELD_OUT]))
        (tmp_path / "test.csv").write_text("\n".join(
            [lines[0]] + [ln for ln in lines[1:] if ln in HELD_OUT]))
    outs = {}
    for name, main, extra in (("jax", jmf.main, []),
                              ("port", tmf.main, ["--device", "cpu"])):
        outs[name] = _run(main, ["-c", str(cfg), train, test, "--algo", algo,
                                 "--outdir", str(tmp_path / name),
                                 "--solver", "pallas" if name == "port"
                                 else "auto", "--alpha", "2", *options]
                          + extra, capsys)
    assert _shape(outs["port"]) == _shape(outs["jax"])
    if algo == "als":
        assert "TEST: Iteration 4 CPU MAE:" in outs["port"]
        _compare_metrics(outs["port"], outs["jax"], metric_tol or 1e-4)
    else:
        t, j = _implicit_lines(outs["port"]), _implicit_lines(outs["jax"])
        assert [x[:2] for x in t] == [x[:2] for x in j] and t
        np.testing.assert_allclose([x[2] for x in t], [x[2] for x in j],
                                   rtol=0, atol=metric_tol or 2e-4)
    base = "test_ratings" if algo == "als" else "train"
    a = _components(tmp_path / "port", base)
    b = _components(tmp_path / "jax", base)
    for c in COMPONENTS:
        assert a[c].shape == b[c].shape
        np.testing.assert_allclose(a[c], b[c], rtol=0, atol=comp_tol)


@pytest.mark.parametrize("algo", ["als", "ials", "bpr"])
def test_mf_families_in_bf16_match_the_tpu_package(tmp_path, data_dir,
                                                   family_init, capsys,
                                                   algo):
    """``--dtype bfloat16``: ALS and BPR keep bf16 tables, iALS draws its
    initial tables in bf16 and sweeps in float32, as in the TPU package.
    A bf16 entry is 2⁻⁸ relative, so ALS RMSEs and the components agree
    within 1e-2; iALS keeps float32's tolerances."""
    if algo == "ials":
        _family_run(tmp_path, data_dir, capsys, algo,
                    ["--dtype", "bfloat16"])
    else:
        _family_run(tmp_path, data_dir, capsys, algo,
                    ["--dtype", "bfloat16"], metric_tol=1e-2, comp_tol=1e-2)


@pytest.mark.parametrize("cli,args,what", [
    ("mf", ["--devices", "2", "--device", "cuda"],
     "no CUDA device|trains on 2 CUDA devices"),
    ("serve", ["--devices", "2", "--device", "cpu"], "item 12b")])
def test_mf_still_refuses_what_is_not_ported(tmp_path, data_dir, cli, args,
                                             what):
    """``mf --devices 2`` on the card needs two cards and raises, naming
    both counts, where the host has fewer (here: no card at all); ``serve
    --devices 2`` is not ported and names the ROADMAP item that ports
    it."""
    cfg = tmp_path / "cfg.txt"
    cfg.write_text(FAMILY_CONFIG)
    train = str(data_dir / "test_ratings.csv")
    if cli == "serve":
        from cu2rec_torch.cli.serve import main as serve_main
        with pytest.raises(SystemExit, match=what):
            serve_main(["--checkpoint", str(tmp_path / "x.npz")] + args)
        return
    with pytest.raises(RuntimeError, match=what):
        tmf.main(["-c", str(cfg), train, train] + args)


def test_mf_devices_two_trains_als_on_the_cpu(tmp_path, data_dir,
                                              monkeypatch):
    """``--algo als --devices 2 --device cpu``: two gloo ranks solve the
    rows of each sweep between them, and the components are the one-device
    run's (row solves do not depend on the rank that makes them).  The
    ranks have 60 s."""
    from cu2rec_torch.parallel import distributed

    monkeypatch.setattr(distributed, "LAUNCH_TIMEOUT", 60.0)
    cfg = tmp_path / "cfg.txt"
    cfg.write_text(FAMILY_CONFIG)
    train = str(data_dir / "test_ratings.csv")
    comps = {}
    for n in (1, 2):
        out = tmp_path / f"out{n}"
        assert tmf.main(["-c", str(cfg), train, train, "--device", "cpu",
                         "--algo", "als", "--devices", str(n), "--outdir",
                         str(out)]) == 0
        comps[n] = _components(out, "test_ratings")
    for c in COMPONENTS:
        np.testing.assert_allclose(comps[2][c], comps[1][c], rtol=1e-5,
                                   atol=1e-6, err_msg=c)
