"""Kernel K6's wrapper (``ops/cuda_bpr.py``) and its dispatch in
``ops/bpr.py``, on the CPU: what the card path computes on the host, what
it refuses before it loads the kernel, and the step loop's hook.  The
kernel itself is held against the plain step by the card tests
(``tests/test_torch_gpu.py -k bpr``).  No JAX here."""

import numpy as np
import pytest
import torch

from cu2rec_torch.data.csr import csr_from_arrays, to_device
from cu2rec_torch.models.state import model_from_numpy
from cu2rec_torch.ops import bpr as ops_bpr
from cu2rec_torch.ops import cuda_bpr
from cu2rec_torch.ops.packed import PackedModel, pack
from cu2rec_torch.ops.sgd import Hyper, fold_in, prng_key
from cu2rec_torch.train.bpr import train_bpr
from cu2rec_torch.utils import timing
from cu2rec_torch.utils.config import Config
from cu2rec_torch.utils.metrics import MetricsLogger

HP = Hyper(*(float(np.float32(v)) for v in (0.1, 0.01, 0.02, 0.0, 0.03)))


def _csr(U=30, I=12, n=200, seed=0):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, U, n) * I + rng.integers(0, I, n))
    return csr_from_arrays(keys // I, keys % I, np.ones(len(keys),
                                                        np.float32), U, I)


def _pm(U=30, I=12, F=6, seed=1):
    rng = np.random.default_rng(seed)
    return pack(model_from_numpy(
        {"p": rng.normal(0, 0.1, (U, F)), "q": rng.normal(0, 0.1, (I, F)),
         "user_bias": np.zeros(U), "item_bias": rng.normal(0, 0.1, I),
         "global_bias": [0.0]}, "cpu"))


@pytest.mark.parametrize("seed", [0, 42, 2 ** 31 - 1, 2 ** 32 + 5,
                                  9_876_543_210, -1])
def test_stream_keys_are_the_fold_ins(seed):
    key = prng_key(seed)
    words = cuda_bpr.stream_keys(key)
    want = key + sum((fold_in(key, t) for t in range(1, 5)), ())
    assert words == want
    assert all(0 <= w < 2 ** 32 for w in words)
    # Once a key: the second call returns the cached words.
    assert cuda_bpr.stream_keys(key) is words
    assert cuda_bpr.stream_keys(torch.tensor(key)) == want


@pytest.fixture
def no_load(monkeypatch):
    """Fails a test that builds or loads the kernel library."""
    from cu2rec_torch.csrc import build

    def boom(*a, **k):
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(build, "load", boom)
    monkeypatch.setattr(build, "build", boom)
    monkeypatch.setattr(cuda_bpr, "_lib", None)


@pytest.mark.parametrize("case,exc,match", [
    ("cpu", ValueError, "CUDA tensors"),
    ("mixed", TypeError, "T_i is torch.bfloat16"),
    ("float64", TypeError, "float32 or bfloat16"),
    ("width", ValueError, "rows of"),
    ("factors", ValueError, "does not fit"),
])
def test_wrapper_refuses_before_loading(no_load, case, exc, match):
    dev = to_device(_csr(), "cpu", item_major=True)
    pm = _pm()
    T_u, T_i, F = pm.T_u, pm.T_i, pm.n_factors
    if case == "mixed":
        T_i = T_i.to(torch.bfloat16)
    elif case == "float64":
        T_u, T_i = T_u.double(), T_i.double()
    elif case == "width":
        T_u, T_i = T_u[:, :48].contiguous(), T_i[:, :48].contiguous()
    elif case == "factors":
        F = T_u.shape[1]
    with pytest.raises(exc, match=match):
        cuda_bpr.bpr_step_cuda(T_u, T_i, dev, HP, prng_key(3), 0,
                               n_factors=F)
    assert cuda_bpr._lib is None


def test_step_on_tables_off_the_cpu_never_runs_the_plain_passes(no_load):
    """``bpr_step`` sends any table that is not on the CPU to K6, whose
    wrapper raises for one that is not on a card: no plain fallback."""
    dev = to_device(_csr(), "cpu", item_major=True)
    pm = _pm()
    meta = PackedModel(T_u=torch.empty(pm.T_u.shape, device="meta"),
                       T_i=torch.empty(pm.T_i.shape, device="meta"),
                       global_bias=pm.global_bias, n_factors=pm.n_factors)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops_bpr.bpr_step(meta, dev, HP, prng_key(3), 0)


def test_cpu_step_is_the_plain_step():
    dev = to_device(_csr(), "cpu", item_major=True)
    pm = _pm()
    got = ops_bpr.bpr_step(pm, dev, HP, prng_key(4), 2)
    want = ops_bpr.bpr_step_reference(pm, dev, HP, prng_key(4), 2)
    assert torch.equal(got.T_u, want.T_u) and torch.equal(got.T_i, want.T_i)


def test_run_steps_calls_the_module_step_once_an_iteration(monkeypatch):
    """The benchmark copies the tables by wrapping ``ops.bpr.bpr_step``:
    ``bpr_run_steps`` must reach it through the module, once a step."""
    seen = []
    plain = ops_bpr.bpr_step

    def step(pm, dev, hp, key, iteration):
        seen.append(iteration)
        return plain(pm, dev, hp, key, iteration)

    monkeypatch.setattr(ops_bpr, "bpr_step", step)
    dev = to_device(_csr(), "cpu", item_major=True)
    ops_bpr.bpr_run_steps(_pm(), dev, HP, prng_key(5), 7, 4)
    assert seen == [7, 8, 9, 10]


def test_cpu_training_counts_no_card_steps():
    csr = _csr(seed=2)
    cfg = Config(total_iterations=6, check_error=3, n_factors=6,
                 learning_rate=0.1, seed=5, algo="bpr")
    timing.trace_start()
    try:
        train_bpr(csr, csr, cfg, logger=MetricsLogger(verbose=False),
                  device="cpu")
    finally:
        counters = timing.trace_stop()["counters"]
    assert counters["bpr.steps"] == 6
    assert "bpr.card_steps" not in counters


@pytest.mark.parametrize("F,ok", [(1, True), (50, True), (63, True),
                                  (300, True), (511, True), (512, False),
                                  (1000, False)])
def test_check_factors_takes_the_kernel_widths(F, ok):
    if ok:
        cuda_bpr.check_factors(F)
    else:
        with pytest.raises(ValueError, match="n_factors up to 511"):
            cuda_bpr.check_factors(F)


def test_card_training_refuses_wide_factors_before_building(monkeypatch,
                                                             no_load):
    """``train_bpr`` on a card checks K6's widths before it draws a model
    or copies the ratings (``mf --algo bpr`` trains through it)."""
    from cu2rec_torch.train import bpr as train_mod

    def boom(*a, **k):
        raise AssertionError("built before the width check")

    monkeypatch.setattr(train_mod, "resolve_device",
                        lambda d=None: torch.device("cuda"))
    monkeypatch.setattr(train_mod, "init_model", boom)
    monkeypatch.setattr(train_mod, "to_device", boom)
    cfg = Config(total_iterations=2, check_error=1, n_factors=600,
                 learning_rate=0.1, seed=5, algo="bpr")
    with pytest.raises(ValueError, match="K6"):
        train_bpr(_csr(), _csr(), cfg, logger=MetricsLogger(verbose=False))


def _evals_without_plans(monkeypatch, mod):
    """Make ``mod``'s trainer's evals build their own inputs, as they do
    when they are given no plan."""
    for name in ("auc_eval", "ranking_eval"):
        plain = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=plain, plan=None, **k:
                            _f(*a, **k))


def _traced_run(train, **kw):
    timing.trace_start()
    try:
        logger = MetricsLogger(verbose=False)
        _, losses = train(logger=logger, **kw)
    finally:
        counters = timing.trace_stop()["counters"]
    evals = [tuple(r[k] for k in ("auc", "recall_at_k", "ndcg_at_k"))
             for r in logger.history if r["event"] == "eval"]
    return counters, losses, evals


@pytest.mark.parametrize("algo", ["bpr", "ials"])
def test_training_builds_the_eval_plans_once(monkeypatch, algo):
    """``train_bpr`` and ``train_ials`` build the AUC's pairs and the
    ranked users' lists once a run (``eval.plans`` 2 over 4 eval points),
    and their evals read the same as evals that build their own."""
    from cu2rec_torch.train import bpr as bpr_mod
    from cu2rec_torch.train import ials as ials_mod

    mod = {"bpr": bpr_mod, "ials": ials_mod}[algo]
    train, test = _csr(seed=3), _csr(seed=4)
    n_points = 4

    def run():
        cfg = Config(total_iterations={"bpr": 7, "ials": 4}[algo],
                     check_error=3, n_factors=6, learning_rate=0.1, seed=5,
                     P_reg=0.5, Q_reg=0.5, algo=algo)
        trainer = {"bpr": bpr_mod.train_bpr, "ials": ials_mod.train_ials}
        return _traced_run(trainer[algo], train_csr=train, test_csr=test,
                           cfg=cfg, device="cpu")

    counters, losses, evals = run()
    assert counters["eval.plans"] == 2
    assert len(losses) == len(evals) == n_points
    if algo == "bpr":
        assert counters["bpr.evals"] == n_points
    _evals_without_plans(monkeypatch, mod)
    counters_p, losses_p, evals_p = run()
    assert counters_p["eval.plans"] == 2     # evals without plans build none
    assert losses_p == losses and evals_p == evals
