"""Each count of operations and bytes against a hand count at a tiny
shape."""

from bench_util import ROOT  # noqa: F401  (puts the checkout on the path)

from benchmark.lib import harness


def test_k0a_step_bytes_by_hand():
    k0a = harness.load_module("counts", "k0a")
    # 3 users (2 with ratings), 2 items, rows of 64 float32: each table
    # read and written once, indptr (4 ints), one (item, rating) a user.
    assert k0a.step_bytes(3, 2, 64, 2) == (2 * 3 * 64 * 4 + 4 * 4 + 8 * 2
                                           + 2 * 2 * 64 * 4)
    assert k0a.step_bytes(3, 2, 64, 2, elem=2) == (2 * 3 * 64 * 2 + 16 + 16
                                                   + 2 * 2 * 64 * 2)
    assert k0a.step_ops(50, 2) == 2 * (2 * 50 + 4 * 50)


def test_k0a_matches_smoke_step_bytes():
    """The copy against ``chip_smoke.py::_step_bytes`` (first_wins) on a
    small CSR."""
    import importlib.util

    import numpy as np

    from cu2rec_torch.data.csr import CSRRatings

    spec = importlib.util.spec_from_file_location(
        "_smoke", harness.ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    csr = CSRRatings(indptr=np.array([0, 2, 2, 5], np.int32),
                     indices=np.array([0, 1, 1, 2, 3], np.int32),
                     data=np.ones(5, np.float32), n_users=3, n_items=4)
    k0a = harness.load_module("counts", "k0a")
    for F in (50, 300):
        W = 64 if F == 50 else 384
        assert k0a.step_bytes(3, 4, W, 2) == smoke._step_bytes(
            csr, F, "first_wins", False, True)


def test_k0b_by_hand():
    k0b = harness.load_module("counts", "k0b")
    assert k0b.eval_bytes(10, 3, 4, 64) == 12 * 10 + 7 * 64 * 4
    assert k0b.eval_ops(10, 50) == 10 * 107


def test_k4_by_hand():
    k4 = harness.load_module("counts", "k4")
    n, systems, live, distinct = 3, 2, 5, 4
    # triangle + rhs of n = 3: 6 + 3 entries, a multiply-add each slot
    assert k4.half_sweep_ops(n, live) == 2 * 5 * 9
    assert k4.half_sweep_bytes(n, systems, live, distinct) == (
        4 * 4 * 3 + 8 * 5 + 4 * 2 * 9 + 4 * (3 + 2))


def test_k1_by_hand():
    k1 = harness.load_module("counts", "k1")
    assert k1.half_sweep_ops(3, 2) == 2 * (9 + 18)
    assert k1.half_sweep_bytes(3, 2) == 4 * 2 * (6 + 6)


def test_peaks_are_the_published_h100_sxm():
    from benchmark.lib import roofline

    p = roofline.peaks()
    assert p["bytes_per_s"] == 3.35e12 and p["flop_per_s"] == 495e12
    assert roofline.bound_s(3.35e12, 0) == (1.0, "bytes")
    assert roofline.bound_s(0, 495e12) == (1.0, "operations")
