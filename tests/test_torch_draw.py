"""K5's draw of the starting tables (``ops/cuda_draw.py``), on the CPU: the
plan's offsets, the transforms tabulated from torch's CPU ``randn``, the
kernel's walk of the MT19937 stream and its word-to-entry mapping (its
plain version) against ``torch.randn`` and numpy's MT19937, bit for bit;
and ``init_model``'s dispatch, with the CPU standing in for the card."""

from pathlib import Path

import numpy as np
import pytest
import torch

from cu2rec_torch.models.state import init_model
from cu2rec_torch.ops import cuda_draw
from cu2rec_torch.utils import timing

SEEDS = [0, 42, 2 ** 32 + 5]


@pytest.fixture(scope="module")
def tables():
    """The transforms, extracted from this process's torch (the cache
    untouched)."""
    got = cuda_draw.extract_tables()
    assert got is not None
    return got


def as_card(monkeypatch, tables):
    """Make ``init_model`` on the CPU take the card's path, with the plain
    version of K5 standing in for the kernel (in the self-check too) and
    the module's tables; returns a switch that turns the card's path off
    (``False``) and on again."""
    real = cuda_draw.draws_on_card

    def plain_k5(seed, plan, outs, r, cs, divisor):
        assert all(t.device.type == "cpu" for t in outs)
        cuda_draw.draw_reference(seed, plan, outs, r, cs, divisor)

    def switch(on: bool = True):
        monkeypatch.setattr(cuda_draw, "draws_on_card",
                            (lambda device: True) if on else real)

    monkeypatch.setattr(cuda_draw, "normal_draw_cuda", plain_k5)
    monkeypatch.setattr(cuda_draw, "_host_tables", tables)
    monkeypatch.setattr(cuda_draw, "_device_tables", {})
    switch(True)
    return switch


@pytest.fixture
def cpu_as_card(monkeypatch, tables):
    """``as_card``'s switch, recording on."""
    switch = as_card(monkeypatch, tables)
    timing.trace_start()
    yield switch
    timing.trace_stop()


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy().view(np.uint32)


@pytest.mark.parametrize("q_given,ib_given", [(False, False), (True, False),
                                              (False, True), (True, True)])
def test_plan_offsets_and_tails(q_given, ib_given):
    """Each table starts where the one before it ends: n words, 16 more
    where n % 16 != 0; Q and the item bias drop out where they are given."""
    U, I, F = 1001, 37, 8          # P 8,008 (no tail), Q 296 (tail)
    sizes = [("P", U * F)]
    if not q_given:
        sizes.append(("Q", I * F))
    sizes.append(("user_bias", U))  # 1,001: tail
    if not ib_given:
        sizes.append(("item_bias", I))  # 37: tail
    plan = cuda_draw.draw_plan(sizes)
    want, off = [], 0
    for name, n in sizes:
        want.append((name, n, off))
        off += n + (16 if n % 16 else 0)
    assert [tuple(e) for e in plan] == want
    assert cuda_draw.plan_words(plan) == off
    assert plan[0] == ("P", 8008, 0)
    assert cuda_draw.plan_on_card(plan)
    assert not cuda_draw.plan_on_card(cuda_draw.draw_plan(
        [("P", 64), ("user_bias", 15)]))


def test_tables_are_torch_randn_transforms(tables):
    """r rises with k (1 − u falls), r[0] = 0; cos and sin lie in [−1, 1]
    with cos² + sin² ≈ 1 and cos[0] = 1, sin[0] = 0."""
    r, cs = tables
    assert r.shape == (2 ** 24,) and cs.shape == (2 ** 24, 2)
    assert r[0] == 0 and torch.all(r[1:] > 0)
    assert torch.all(r[1:] >= r[:-1] - 1e-6 * r[1:])
    assert cs[0, 0] == 1 and cs[0, 1] == 0
    assert cs.abs().max() <= 1
    torch.testing.assert_close((cs ** 2).sum(1), torch.ones(2 ** 24),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sizes", [(16,), (17,), (31,), (32,), (1010,),
                                   (16, 17, 31, 32, 1010),
                                   (9000, 8200, 203)])
def test_reference_draw_is_torch_randn(tables, seed, sizes):
    """The plain version of K5 — its windows, chunks and word-to-entry
    mapping — gives ``torch.randn``'s tables of a generator drawn in turn,
    divided by F, bit for bit."""
    plan = cuda_draw.draw_plan((str(i), n) for i, n in enumerate(sizes))
    outs = [torch.empty(n) for n in sizes]
    cuda_draw.draw_reference(seed, plan, outs, *tables, 50)
    gen = torch.Generator().manual_seed(seed)
    for n, out in zip(sizes, outs):
        want = torch.randn(n, generator=gen) / 50.0
        assert np.array_equal(_bits(out), _bits(want)), n


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_model_through_the_card_path(cpu_as_card, seed, dtype):
    """A whole small model with a tail in every table, through the card's
    dispatch, equals the CPU draw bit for bit, float32 and bf16."""
    U, I, F = 301, 43, 12          # 3,612 (tail), 516 (tail), 301, 43
    got = init_model(U, I, F, 3.5, seed=seed, dtype=dtype, device="cpu")
    counters = timing.trace_stop()["counters"]
    assert counters == {"model.init.card_draws": 1}
    cpu_as_card(False)
    want = init_model(U, I, F, 3.5, seed=seed, dtype=dtype, device="cpu")
    for name in ("P", "Q", "user_bias", "item_bias", "global_bias"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), name


def test_init_model_with_given_items_through_the_card_path(cpu_as_card):
    """The fold-in's shape with Q and the item bias given: only P and the
    user bias are drawn, as on the CPU."""
    rng = np.random.default_rng(3)
    Q = rng.normal(size=(29, 8)).astype(np.float32)
    ib = rng.normal(size=29).astype(np.float32)
    got = init_model(40, 29, 8, 3.0, seed=9, Q=Q, item_bias=ib,
                     device="cpu")
    assert timing.trace_stop()["counters"] == {"model.init.card_draws": 1}
    cpu_as_card(False)
    want = init_model(40, 29, 8, 3.0, seed=9, Q=Q, item_bias=ib,
                      device="cpu")
    for name in ("P", "Q", "user_bias", "item_bias"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("offset", [0, 623, 624, 625, 19_937, 40_000])
def test_windows_are_the_mt19937_stream(offset):
    """Words rebuilt from K5's windows (the 227-wide walk) are numpy's
    MT19937 under legacy seeding, tempered, at word ``offset`` on."""
    seed = 2 ** 33 + 17
    bg = np.random.MT19937()
    bg._legacy_seeding(seed & 0xFFFFFFFF)
    want = bg.random_raw(offset + 700).astype(np.uint32)[offset:]
    chunk = offset // cuda_draw.CHUNK
    wins = cuda_draw.mt_windows(seed, chunk + 1)
    x = cuda_draw.mt_walk(wins[chunk], cuda_draw.SPAN)
    start = offset - chunk * cuda_draw.CHUNK
    got = cuda_draw.temper(x[cuda_draw.MT_N + start:][:700])
    assert np.array_equal(got, want)
    # The walk from the seed itself, past 19,937 words.
    x = cuda_draw.mt_walk(cuda_draw.mt_state(seed), offset + 700)
    assert np.array_equal(cuda_draw.temper(x[cuda_draw.MT_N + offset:]),
                          want)


def test_small_tables_stay_on_the_cpu(cpu_as_card):
    """A table under 16 entries (torch draws it with other CPU code)
    keeps the whole model on the CPU draw, counted."""
    got = init_model(5, 40, 8, 3.0, seed=1, device="cpu")
    assert timing.trace_stop()["counters"] == {"model.init.cpu_draws": 1}
    cpu_as_card(False)
    want = init_model(5, 40, 8, 3.0, seed=1, device="cpu")
    assert torch.equal(got.user_bias, want.user_bias)
    assert torch.equal(got.P, want.P)


def test_forged_tables_fail_the_check_and_stay_on_the_cpu(
        cpu_as_card, monkeypatch, tables):
    """Tables one ulp off fail the self-check, and a card model is then
    not drawn at all: ``init_model`` raises, naming the first entry that
    differs, at every call (nothing falls back to the CPU's draw), and
    counts no draw."""
    r, cs = tables
    monkeypatch.setattr(cuda_draw, "_host_tables",
                        (torch.nextafter(r, torch.tensor(np.inf)), cs))
    for _ in range(2):
        with pytest.raises(RuntimeError, match=r"self-check failed .* "
                           r"first at entry \d+: "):
            init_model(301, 43, 12, 3.5, seed=4, device="cpu")
    rec = timing.trace_stop()
    assert rec["counters"] == {}
    assert [s[0] for s in rec["spans"]].count("model.init.draw.tables") == 2
    assert cuda_draw._device_tables == {}


def test_unbuildable_tables_raise(cpu_as_card, monkeypatch, tmp_path):
    """A CPU generator whose state is laid out otherwise leaves no way to
    build the transforms: a card model's draw raises and says so, and
    writes no cache."""
    monkeypatch.setattr(cuda_draw, "_host_tables", None)
    monkeypatch.setattr(cuda_draw, "cache_path", lambda: tmp_path / "t.npy")
    monkeypatch.setattr(cuda_draw, "_state_layout_ok", lambda state: False)
    with pytest.raises(RuntimeError, match="not laid out"):
        init_model(301, 43, 12, 3.5, seed=4, device="cpu")
    assert timing.trace_stop()["counters"] == {}
    assert not (tmp_path / "t.npy").exists()


def test_cache_key_names_the_torch_build():
    """The cache's name holds torch's version, its CPU capability and the
    size of the ``libtorch_cpu`` file it loads."""
    name = cuda_draw.cache_path().name
    lib = sorted((Path(torch.__file__).parent / "lib")
                 .glob("libtorch_cpu.*"))[0]
    assert name.startswith(f"{torch.__version__}-"
                           f"{torch.backends.cpu.get_cpu_capability()}-"
                           .replace("+", "_"))
    assert f"-{lib.stat().st_size}-{lib.stat().st_mtime_ns}.npy" in name


def test_cache_round_trip(monkeypatch, tmp_path, tables):
    """``transform_tables`` writes the cache once and reads it back."""
    path = tmp_path / "t.npy"
    monkeypatch.setattr(cuda_draw, "cache_path", lambda: path)
    monkeypatch.setattr(cuda_draw, "extract_tables", lambda: tables)
    first = cuda_draw.transform_tables()
    assert path.exists()
    monkeypatch.setattr(cuda_draw, "extract_tables", lambda: 1 / 0)
    again = cuda_draw.transform_tables()
    for a, b, c in zip(tables, first, again):
        assert torch.equal(a, b) and torch.equal(a, c)
