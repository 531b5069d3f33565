"""Two gloo processes on the CPU through the whole training story (the
port of the TPU package's ``test_distributed.py``): SGD through the sharded
engine on a (2, 1) grid, the same against a one-process run; an ip = 2
grid across the process boundary; a row-sharded ALS sweep; and a
checkpoint saved mid-run and resumed in a fresh pair of processes, whose
final model must be byte for byte the uninterrupted run's (sha256 of P and
Q).

Each pair of processes is one ``launch`` with a 60 s limit.  The module
imports no JAX at its top: the ranks import it to find their job.
"""

import functools
import hashlib

import numpy as np
import pytest
import torch

from cu2rec_torch.data.csr import CSRRatings
from cu2rec_torch.parallel.distributed import launch
from cu2rec_torch.parallel.sharded import ShardedEngine, make_mesh
from cu2rec_torch.train.trainer import train
from cu2rec_torch.utils.config import Config
from cu2rec_torch.utils.metrics import MetricsLogger

RANK_TIMEOUT = 60.0
LOSS_RTOL = 1e-6


def _sgd_cfg(policy="first_wins"):
    return Config(total_iterations=10, n_factors=4, learning_rate=0.05,
                  check_error=5, seed=7, collision_policy=policy)


def _als_cfg():
    return Config(total_iterations=2, n_factors=4, seed=7, P_reg=0.1,
                  Q_reg=0.1, user_bias_reg=0.1, item_bias_reg=0.1)


def _digest(model) -> str:
    h = hashlib.sha256()
    for t in (model.P, model.Q):
        h.update(np.ascontiguousarray(t.numpy()).tobytes())
    return h.hexdigest()


def _story_job(phase: str, ckpt: str, csr_args, gb: float, model_d):
    """One rank of the pair: ``train`` (SGD from the TPU package's initial
    model with a checkpoint at iteration 5, the ip = 2 grid under
    first_wins and twin, two ALS sweeps) or ``resume`` (SGD from the
    checkpoint)."""
    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.train.als import train_als
    from cu2rec_torch.utils.checkpoint import load_checkpoint

    csr = CSRRatings(*csr_args)
    quiet = MetricsLogger(verbose=False)
    if phase == "resume":
        model0, cfg, _extra = load_checkpoint(ckpt, device="cpu")
        assert cfg.cur_iterations == 5 and cfg.total_iterations == 10
        engine = ShardedEngine(csr, csr, cfg, mesh=make_mesh(2, 1, "cpu"))
        model, losses = train(csr, csr, cfg, gb, model=model0, logger=quiet,
                              engine=engine)
        return {"losses": losses, "digest": _digest(model)}
    cfg = _sgd_cfg()
    engine = ShardedEngine(csr, csr, cfg, mesh=make_mesh(2, 1, "cpu"))
    model, losses = train(csr, csr, cfg, gb,
                          model=model_from_numpy(model_d, "cpu"),
                          logger=quiet, engine=engine, checkpoint_path=ckpt,
                          checkpoint_every=2)
    out = {"losses": losses, "digest": _digest(model)}
    for policy in ("first_wins", "twin"):
        cfg = _sgd_cfg(policy)
        engine = ShardedEngine(csr, csr, cfg, mesh=make_mesh(1, 2, "cpu"))
        model, losses = train(csr, csr, cfg, gb,
                              model=model_from_numpy(model_d, "cpu"),
                              logger=quiet, engine=engine)
        out["ip2", policy] = (losses, _digest(model))
    _m, out["als"] = train_als(csr, csr, _als_cfg(), gb,
                               model=model_from_numpy(model_d, "cpu"),
                               logger=quiet, mesh=make_mesh(2, 1, "cpu"))
    return out


@functools.lru_cache(maxsize=None)
def _toy():
    """(toy CSR, its global bias, the TPU package's initial model as
    host arrays)."""
    import pathlib

    from cu2rec_torch.data.csr import build_csr
    from cu2rec_torch.data.ratings import read_ratings_csv
    from cu2rec_tpu.models.state import init_model
    from cu2rec_tpu.models.state import model_to_numpy as j_to_numpy

    rd = read_ratings_csv(str(pathlib.Path(__file__).parent / "data"
                              / "test_ratings.csv"))
    csr = build_csr(rd)
    model_d = j_to_numpy(init_model(csr.n_users, csr.n_items, 4,
                                    rd.global_bias, seed=7))
    return csr, rd.global_bias, model_d


def _args(csr):
    return (csr.indptr, csr.indices, csr.data, csr.n_users, csr.n_items)


@functools.lru_cache(maxsize=None)
def _story(tmp_dir: str):
    """Both phases' results: (uninterrupted pair, resumed pair)."""
    csr, gb, model_d = _toy()
    ckpt = f"{tmp_dir}/dist_ckpt.npz"
    first = launch(_story_job, 2, "gloo", "cpu",
                   args=("train", ckpt, _args(csr), gb, model_d),
                   timeout=RANK_TIMEOUT)
    resumed = launch(_story_job, 2, "gloo", "cpu",
                     args=("resume", ckpt, _args(csr), gb, model_d),
                     timeout=RANK_TIMEOUT)
    return first, resumed


@pytest.fixture(scope="module")
def story(tmp_path_factory):
    return _story(str(tmp_path_factory.mktemp("dist")))


def _jax_losses(engine_grid=None, policy="first_wins", als=False):
    """The TPU package in one process on its virtual CPU devices, from the
    same initial model."""
    import pathlib

    from cu2rec_tpu.data import build_csr, read_ratings_csv
    from cu2rec_tpu.models.state import init_model
    from cu2rec_tpu.parallel.sharded import ShardedEngine as JEngine
    from cu2rec_tpu.parallel.sharded import make_mesh as j_mesh
    from cu2rec_tpu.train.trainer import train as j_train

    rd = read_ratings_csv(str(pathlib.Path(__file__).parent / "data"
                              / "test_ratings.csv"))
    csr = build_csr(rd)
    jm = init_model(csr.n_users, csr.n_items, 4, rd.global_bias, seed=7)
    quiet = MetricsLogger(verbose=False)
    if als:
        from cu2rec_tpu.train.als import train_als as j_als
        return j_als(csr, csr, _als_cfg(), rd.global_bias, model=jm,
                     logger=quiet, mesh=j_mesh(2, 1),
                     device_buckets=False)[1]
    cfg = _sgd_cfg(policy)
    engine = JEngine(csr, csr, cfg, mesh=j_mesh(*engine_grid))
    return j_train(csr, csr, cfg, rd.global_bias, model=jm, logger=quiet,
                   engine=engine)[1]


def _assert_losses(got: dict, want: dict, rtol: float) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=str(k))


def test_two_ranks_agree_on_losses_and_model(story):
    first, resumed = story
    for run in (first, resumed):
        assert run[0]["losses"] == run[1]["losses"]
        assert run[0]["digest"] == run[1]["digest"]
    assert first[0]["ip2", "twin"] == first[1]["ip2", "twin"]
    assert first[0]["als"] == first[1]["als"]


def test_two_process_sgd_matches_one_process(story):
    """The losses of the (2, 1) grid across two processes: those of one
    process on one device, and of the TPU package's (2, 1) mesh in one
    process (float tolerance: the adds happen in another order)."""
    from cu2rec_torch.models.state import model_from_numpy

    csr, gb, model_d = _toy()
    one = train(csr, csr, _sgd_cfg(), gb,
                model=model_from_numpy(model_d, "cpu"),
                logger=MetricsLogger(verbose=False), device="cpu")[1]
    got = story[0][0]["losses"]
    _assert_losses(got, one, LOSS_RTOL)
    _assert_losses(got, _jax_losses((2, 1)), LOSS_RTOL)


@pytest.mark.parametrize("policy", ["first_wins", "twin"])
def test_item_shards_across_the_process_boundary(story, policy):
    """ip = 2 puts the item table's halves in the two processes: the row
    assembly, the election and twin's rater rows cross between them, and
    the losses are the TPU package's (1, 2) mesh's."""
    losses, _digest = story[0][0]["ip2", policy]
    _assert_losses(losses, _jax_losses((1, 2), policy), LOSS_RTOL)


def test_two_process_als_sweeps(story):
    """Two row-sharded ALS sweeps: converging, and the TPU package's
    ``train_als(mesh=make_mesh(2, 1))`` within rtol 1e-5."""
    als = story[0][0]["als"]
    assert als[2] <= als[1]
    _assert_losses(als, _jax_losses(als=True), 1e-5)


def test_checkpoint_resumed_in_fresh_processes_is_byte_identical(story):
    """The checkpoint written at iteration 5 by every rank (after every
    rank assembled the model), resumed by a fresh pair of processes: only the
    remaining eval point runs, with the uninterrupted run's loss, and P and
    Q have the uninterrupted run's sha256."""
    first, resumed = story
    assert sorted(resumed[0]["losses"]) == [10]
    assert resumed[0]["losses"][10] == first[0]["losses"][10]
    assert resumed[0]["digest"] == first[0]["digest"]


def _checkpoint_job(root: str, model_d):
    """One rank of the checkpoint test: the same model saved to a
    directory of the rank's own, which only this rank makes (a host of its
    own), then by both ranks to one shared path; each file loaded back
    here.  Returns what each load found."""
    import os

    from cu2rec_torch.models.state import model_from_numpy, model_to_numpy
    from cu2rec_torch.parallel.distributed import process_info
    from cu2rec_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    rank, _world = process_info()
    model = model_from_numpy(model_d, "cpu")
    cfg = _sgd_cfg()
    os.makedirs(f"{root}/rank{rank}")
    found = {}
    for what, path in (("own", f"{root}/rank{rank}/model"),
                       ("shared", f"{root}/shared/model.npz")):
        final = save_checkpoint(path, model, cfg)
        got, got_cfg, _extra = load_checkpoint(final, device="cpu")
        comps = model_to_numpy(got)
        found[what] = (final, got_cfg == cfg,
                       all(np.array_equal(comps[k], model_d[k])
                           for k in model_d))
    return found


def test_every_rank_writes_a_complete_checkpoint(tmp_path):
    """Every rank writes the checkpoint, as every process of the TPU
    package does: a rank that passes a directory only it can see (a host
    with no shared filesystem) finds its complete file there, and both
    ranks passing one path leave one file, equal to the model, and no
    temporary file."""
    import os

    from cu2rec_torch.models.state import model_from_numpy, model_to_numpy

    # The port's own arrays of the TPU package's initial model.
    model_d = model_to_numpy(model_from_numpy(_toy()[2], "cpu"))
    os.makedirs(tmp_path / "shared")
    ranks = launch(_checkpoint_job, 2, "gloo", "cpu",
                   args=(str(tmp_path), model_d), timeout=RANK_TIMEOUT)
    for rank, found in enumerate(ranks):
        final, same_cfg, same_model = found["own"]
        assert final == f"{tmp_path}/rank{rank}/model.npz"
        assert same_cfg and same_model, rank
        assert found["shared"][1:] == (True, True), rank
    assert os.listdir(tmp_path / "shared") == ["model.npz"]


def _fail_on_rank_one():
    from cu2rec_torch.parallel.distributed import process_info

    rank, _world = process_info()
    if rank == 1:
        raise ValueError("rank one gives up")
    return rank


def test_a_failed_rank_makes_launch_raise():
    """No rank's failure is swallowed: ``launch`` stops the others and
    raises with the failed rank's traceback."""
    with pytest.raises(RuntimeError, match="rank 1 failed") as err:
        launch(_fail_on_rank_one, 2, "gloo", "cpu", timeout=RANK_TIMEOUT)
    assert "rank one gives up" in str(err.value)
    with pytest.raises(ValueError, match="NCCL takes CUDA devices"):
        launch(_fail_on_rank_one, 2, "nccl", "cpu")


def test_launch_runs_on_the_card_by_default():
    """``launch(fn, world)`` with no device resolves as the port's entry
    points do: on the card, and where there is none it raises the no-card
    error before any rank starts; ``device="cpu"`` takes gloo."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        launch(_fail_on_rank_one, 2)
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        launch(_fail_on_rank_one, 2, device="cpu", timeout=RANK_TIMEOUT)
