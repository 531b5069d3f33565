"""Helpers shared by the serving engines' tests (test_torch_engine.py,
test_torch_serving.py): the TPU package's toy and planted models, the
port's engine over such a model, and the top-k comparison.  JAX is
imported inside the helpers, so that ranks which import a test module to
find their job do not import it."""

import pathlib

import numpy as np

DATA = pathlib.Path(__file__).parent / "data"


def toy():
    """The TPU package's F=4 model of the toy fixture, and its CSR."""
    from cu2rec_tpu.data import build_csr, read_ratings_csv
    from cu2rec_tpu.models.state import init_model

    rd = read_ratings_csv(str(DATA / "test_ratings.csv"))
    csr = build_csr(rd)
    return init_model(csr.n_users, csr.n_items, 4, rd.global_bias,
                      seed=5), csr


def planted_arrays(U=40, I=300, F=16, seed=11):
    """Block-structured F=16 tables from numpy (``model_to_numpy``'s
    keys), and the (users, items, ratings) of 6-12 ratings per user."""
    rng = np.random.default_rng(seed)
    P = rng.normal(0, 0.3, (U, F)).astype(np.float32)
    Q = rng.normal(0, 0.3, (I, F)).astype(np.float32)
    P[:, 0] += np.where(np.arange(U) % 2 == 0, 1.0, -1.0)
    Q[:, 0] += np.where(np.arange(I) < I // 2, 1.0, -1.0)
    tables = {"p": P, "q": Q,
              "user_bias": rng.normal(0, 0.1, U).astype(np.float32),
              "item_bias": rng.normal(0, 0.1, I).astype(np.float32),
              "global_bias": np.array([3.5], np.float32)}
    deg = rng.integers(6, 13, U)
    users = np.repeat(np.arange(U), deg)
    items = np.concatenate([rng.choice(I, d, replace=False) for d in deg])
    vals = rng.integers(1, 6, len(items)).astype(np.float32)
    return tables, (users, items, vals)


def planted(**kw):
    """The planted tables as the TPU package's model, and its CSR."""
    import jax.numpy as jnp

    from cu2rec_tpu.data.csr import csr_from_arrays
    from cu2rec_tpu.models.state import MFModel

    t, (users, items, vals) = planted_arrays(**kw)
    U, I = t["p"].shape[0], t["q"].shape[0]
    model = MFModel(P=jnp.asarray(t["p"]), Q=jnp.asarray(t["q"]),
                    user_bias=jnp.asarray(t["user_bias"]),
                    item_bias=jnp.asarray(t["item_bias"]),
                    global_bias=jnp.float32(3.5))
    return model, csr_from_arrays(users, items, vals, U, I)


MODELS = {"toy": toy, "planted": planted}


def port_engine(jmodel, n_ip: int = 1, **kw):
    """The port's engine over the TPU package's model on the CPU: the
    one-device ``ServingEngine``, or ``n_ip`` CPU item shards."""
    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.serve.engine import ServingEngine, ShardedServingEngine
    from cu2rec_tpu.models.state import model_to_numpy

    model = model_from_numpy(model_to_numpy(jmodel), "cpu")
    if n_ip == 1:
        return ServingEngine(model, device="cpu", **kw)
    return ShardedServingEngine(model, devices=["cpu"] * n_ip, **kw)


def assert_topk_match(v1, i1, v2, i2, rtol=1e-5):
    """Same real (> -1e30) entries: scores within rtol, ids equal wherever
    a score is not tied with a neighbour."""
    v1, i1, v2, i2 = map(np.asarray, (v1, i1, v2, i2))
    assert v1.shape == v2.shape
    for b in range(v1.shape[0]):
        k1, k2 = v1[b] > -1e30, v2[b] > -1e30
        np.testing.assert_array_equal(k1, k2)
        a, c = v1[b][k1], v2[b][k2]
        np.testing.assert_allclose(a, c, rtol=rtol)
        for j in range(len(a)):
            near = np.abs(a - a[j]) <= 1e-6 * np.abs(a[j]) + 1e-7
            if near.sum() == 1:
                assert i1[b][k1][j] == i2[b][k2][j], (b, j)
