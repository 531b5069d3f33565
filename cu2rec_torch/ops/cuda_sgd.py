"""One SGD iteration over the packed tables on the card — kernel K0a.

The TPU package's ``ops/packed.py::packed_step`` has no Pallas kernel: XLA
fuses it.  Here it is ``csrc/sgd_step.cu``, bound with ctypes: a user
kernel and an item kernel, each row held in float4 registers by a group of
lanes (four rows a warp at W = 128), each kernel launched so that its
sampling chain runs while the kernel before it ends (programmatic
dependent launch).  Tables are float32 or bf16 (float32 arithmetic).
Under ``mean`` and ``sum`` the item side is a counting sort of the step's
pairs by item (run offsets from a scan across the card) and an in-order
add of each item's deltas, so the result is deterministic;
``collision_runs_cuda`` runs that sort alone, for the checks.  The
kernel's header says what bounds it and how the read-before-write hazard
is handled.  Its plain version is
``ops/packed.py::packed_step_reference``; ``packed_step`` takes that on CPU
tensors and this wrapper on CUDA tensors.  The kernel takes the widths in
``ops/packed.py::KERNEL_WIDTHS``.

``sgd_step_cuda`` launches the kernel or raises: it takes CUDA tensors only
and never falls back.  ``LAUNCHES`` counts its calls, one per step (one
launch of the user kernel, plus the item side's launches when items
train), by variant.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from cu2rec_torch.ops.packed import TABLE_ELEMS, check_kernel_tables
from cu2rec_torch.ops.sgd import INT32_MAX, Hyper, _key_words, start_user_of

KERNEL = "sgd_step"
MODES = {"first_wins": 0, "twin": 1, "mean": 3, "sum": 4}
# Step launches in this process (incremented where the kernel launches),
# by (table dtype, policy), the policy "users" for a step with the items
# frozen; ``LAUNCHES.total()`` counts them all.
LAUNCHES: Counter = Counter()

_lib = None


def _load():
    global _lib
    if _lib is None:
        from cu2rec_torch.csrc.build import load
        lib = load(KERNEL)
        P, I, F, U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_uint)
        lib.sgd_step_launch.argtypes = (
            [P] * 16 + [I] * 4 + [F] * 6 + [U] * 3 + [I, I, I, P])
        lib.sgd_step_launch.restype = ctypes.c_int
        lib.sgd_step_workspace.argtypes = [I, I]
        lib.sgd_step_workspace.restype = ctypes.c_longlong
        lib.sgd_collision_runs.argtypes = [P] * 6 + [I] * 2 + [U] * 3 + [P]
        lib.sgd_collision_runs.restype = ctypes.c_int
        _lib = lib
    return _lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(name, t, dtype, device, shape=None):
    if t is None:
        raise ValueError(f"{name} is required on this path")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, tables on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")


def sgd_step_cuda(T_u: torch.Tensor, T_i: torch.Tensor, mu: float, dev,
                  hp: Hyper, key, iteration: int, *, n_factors: int,
                  train_items: bool = True, collision: str = "first_wins",
                  rotation: int = 250, best: torch.Tensor | None = None,
                  counts: torch.Tensor | None = None):
    """New ``(T_u, T_i)`` after one step; the inputs are left as they were
    (with ``train_items=False`` the returned ``T_i`` is the input).

    ``T_u`` (U, W) and ``T_i`` (I, W), both float32 or both bf16, on one
    CUDA device; ``dev`` a ``DeviceRatings`` there (item-major for twin).
    ``best`` is the election buffer (I,) int32, all ``INT32_MAX``, which
    the kernel leaves so; ``counts`` (``mean``/``sum``) the pairs-an-item
    buffer (I,) int32, all zero, which the kernel leaves so; without them
    fresh ones are made.

    The user kernel reads ``dev.indptr``, ``dev.indices`` and ``dev.data``
    before it waits on the kernel ahead of it on the stream (programmatic
    dependent launch).  They must therefore not be written by a kernel
    still queued or running when the step is called: upload them
    (``data/csr.py::to_device``), or finish the kernel that builds them
    with ``torch.cuda.synchronize()`` first."""
    device = T_u.device
    if device.type != "cuda":
        raise ValueError(f"sgd_step_cuda takes CUDA tensors, got {device}")
    U, W = T_u.shape
    I = T_i.shape[0]
    F = int(n_factors)
    elem = TABLE_ELEMS.get(T_u.dtype)
    if elem is None:
        raise TypeError(f"T_u must be float32 or bfloat16, got {T_u.dtype}")
    _check("T_u", T_u, T_u.dtype, device)
    _check("T_i", T_i, T_u.dtype, device, (I, W))
    if not 0 <= F < W:
        raise ValueError(f"n_factors {F} does not fit rows of width {W}")
    check_kernel_tables("K0a", T_u, T_i)
    if dev.n_users != U or dev.n_items != I:
        raise ValueError(f"ratings are {dev.n_users}x{dev.n_items}, tables "
                         f"{U}x{I}")
    _check("indptr", dev.indptr, torch.int32, device, (U + 1,))
    _check("indices", dev.indices, torch.int32, device)
    _check("data", dev.data, torch.float32, device)
    mode = -1
    if train_items:
        if collision not in MODES:
            raise ValueError(f"K0a takes collision in {sorted(MODES)}, got "
                             f"{collision!r}")
        mode = MODES[collision]
        if mode == 1:
            _check("it_indptr", dev.it_indptr, torch.int32, device, (I + 1,))
            if dev.it_order is not None:
                mode = 2
                _check("it_order", dev.it_order, torch.int32, device)
                _check("row_ids", dev.row_ids, torch.int32, device)
            else:
                _check("it_users", dev.it_users, torch.int32, device)
                _check("it_vals", dev.it_vals, torch.float32, device)
    lib = _load()
    T_u_out = torch.empty_like(T_u)
    T_i_out = torch.empty_like(T_i) if mode >= 0 else T_i
    w_rating = ws = None
    if mode >= 3:
        ws = torch.empty(lib.sgd_step_workspace(U, I), dtype=torch.int32,
                         device=device)
        if counts is None:
            counts = torch.zeros(I, dtype=torch.int32, device=device)
        _check("counts", counts, torch.int32, device, (I,))
    else:
        counts = None
    if mode == 0:
        if best is None:
            best = torch.full((I,), INT32_MAX, dtype=torch.int32,
                              device=device)
        _check("best", best, torch.int32, device, (I,))
        w_rating = torch.empty(U, dtype=torch.float32, device=device)
    k0, k1 = _key_words(key)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.sgd_step_launch(
            T_u.data_ptr(), T_u_out.data_ptr(), T_i.data_ptr(),
            T_i_out.data_ptr(), dev.indptr.data_ptr(),
            dev.indices.data_ptr(), dev.data.data_ptr(),
            _ptr(dev.row_ids), _ptr(dev.it_indptr), _ptr(dev.it_users),
            _ptr(dev.it_vals), _ptr(dev.it_order), _ptr(best),
            _ptr(w_rating), _ptr(ws), _ptr(counts), U, I, W, F, mu,
            hp.learning_rate, hp.P_reg, hp.Q_reg, hp.user_bias_reg,
            hp.item_bias_reg, k0, k1,
            int(iteration) & 0xFFFFFFFF,
            start_user_of(iteration, U, rotation), mode, elem, stream)
    if rc != 0:
        raise RuntimeError(f"sgd_step launch failed: cudaError {rc}")
    LAUNCHES[T_u.dtype, collision if mode >= 0 else "users"] += 1
    return T_u_out, T_i_out


def collision_runs_cuda(dev, key, iteration: int,
                        counts: torch.Tensor | None = None):
    """The runs of a ``mean``/``sum`` step's item side on the card, alone:
    ``(offsets, users)``, int32 CUDA tensors.  ``offsets`` (I + 1,): item
    i's run is ``users[offsets[i]:offsets[i + 1]]``; ``users``: each run's
    users in the order the kernel adds their deltas (ascending).  The
    step's sampling at ``iteration`` from ``dev``'s user-major arrays, its
    counting sort and each run's ordering, as the step runs them.  Its plain
    version is ``ops/packed.py::collision_runs_reference``.  It is a check
    of the step, not a step: ``LAUNCHES`` does not count it."""
    device = dev.indptr.device
    if device.type != "cuda":
        raise ValueError(f"collision_runs_cuda takes CUDA ratings, got "
                         f"{device}")
    U, I = dev.n_users, dev.n_items
    _check("indptr", dev.indptr, torch.int32, device, (U + 1,))
    _check("indices", dev.indices, torch.int32, device)
    if counts is None:
        counts = torch.zeros(I, dtype=torch.int32, device=device)
    _check("counts", counts, torch.int32, device, (I,))
    lib = _load()
    ws = torch.empty(lib.sgd_step_workspace(U, I), dtype=torch.int32,
                     device=device)
    offsets = torch.empty(I + 1, dtype=torch.int32, device=device)
    users = torch.empty(U, dtype=torch.int32, device=device)
    k0, k1 = _key_words(key)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.sgd_collision_runs(
            dev.indptr.data_ptr(), dev.indices.data_ptr(), counts.data_ptr(),
            ws.data_ptr(), offsets.data_ptr(), users.data_ptr(), U, I, k0,
            k1, int(iteration) & 0xFFFFFFFF, stream)
    if rc != 0:
        raise RuntimeError(f"sgd_collision_runs launch failed: cudaError "
                           f"{rc}")
    return offsets, users[:int(offsets[I])]


# ---- K0a's sharded mode (csrc/sgd_sharded.cu) ----------------------------

SHARD_KERNEL = "sgd_sharded"
# Sharded step launches in this process (incremented where the step's
# kernels launch), by (table dtype, policy), the policy "users" for a step
# with the items frozen.
SHARD_LAUNCHES: Counter = Counter()

_shard_lib = None


def _load_shard():
    global _shard_lib
    if _shard_lib is None:
        from cu2rec_torch.csrc.build import load
        lib = load(SHARD_KERNEL)
        P, I, F, U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_uint)
        lib.sgd_shard_workspace.argtypes = [I, I]
        lib.sgd_shard_workspace.restype = ctypes.c_longlong
        lib.sgd_shard_assemble.argtypes = (
            [P, P, I, U, I, I, P, P, I, I, U, U, U, P])
        lib.sgd_shard_assemble.restype = ctypes.c_int
        lib.sgd_shard_users.argtypes = (
            [P] * 11 + [I] * 4 + [F] * 4 + [U] * 3 + [I] * 7 + [P])
        lib.sgd_shard_users.restype = ctypes.c_int
        lib.sgd_shard_items.argtypes = (
            [P] * 13 + [I] * 4 + [F] * 4 + [U] * 3 + [I] * 7 + [P])
        lib.sgd_shard_items.restype = ctypes.c_int
        lib.sgd_shard_apply.argtypes = [P, P, P, ctypes.c_longlong, I, P]
        lib.sgd_shard_apply.restype = ctypes.c_int
        _shard_lib = lib
    return _shard_lib


def _rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def sgd_step_sharded_cuda(T_u: torch.Tensor, T_i: torch.Tensor, mu: float,
                          dev, hp: Hyper, key, iteration: int, *,
                          n_factors: int, mesh, n_users_global: int,
                          train_items: bool = True,
                          collision: str = "first_wins",
                          rotation: int = 250,
                          best: torch.Tensor | None = None,
                          counts: torch.Tensor | None = None):
    """New ``(T_u, T_i)`` blocks of this rank after one sharded step: K0a
    split at the grid's collectives (``csrc/sgd_sharded.cu``), which this
    wrapper runs between the kernels over ``mesh``'s axes
    (``parallel/sharded.py``).  The inputs are left as they were.

    ``T_u`` (U_loc, W) and ``T_i`` (I_loc, W), this rank's blocks, both
    float32 or both bf16, on its CUDA device; ``dev`` its shard's
    ``DeviceRatings`` (global item ids; under twin with its item block's
    ``it_indptr``/``it_users``/``it_vals``).  ``n_users_global`` is the
    unpadded user count (the election's modulus).  ``best`` and ``counts``
    as for ``sgd_step_cuda``, of I_loc entries.  Its plain version is
    ``parallel/sharded.py::_local_step_packed``."""
    device = T_u.device
    if device.type != "cuda":
        raise ValueError(f"sgd_step_sharded_cuda takes CUDA tensors, got "
                         f"{device}")
    U, W = T_u.shape
    I = T_i.shape[0]
    F = int(n_factors)
    elem = TABLE_ELEMS.get(T_u.dtype)
    if elem is None:
        raise TypeError(f"T_u must be float32 or bfloat16, got {T_u.dtype}")
    _check("T_u", T_u, T_u.dtype, device)
    _check("T_i", T_i, T_u.dtype, device, (I, W))
    if not 0 <= F < W:
        raise ValueError(f"n_factors {F} does not fit rows of width {W}")
    check_kernel_tables("K0a", T_u, T_i)
    if dev.n_users != U:
        raise ValueError(f"the shard's ratings hold {dev.n_users} users, "
                         f"T_u {U}")
    _check("indptr", dev.indptr, torch.int32, device, (U + 1,))
    _check("indices", dev.indices, torch.int32, device)
    _check("data", dev.data, torch.float32, device)
    mode = -1
    if train_items:
        if collision not in MODES:
            raise ValueError(f"K0a takes collision in {sorted(MODES)}, got "
                             f"{collision!r}")
        mode = MODES[collision]
        if mode == 1:
            _check("it_indptr", dev.it_indptr, torch.int32, device, (I + 1,))
            _check("it_users", dev.it_users, torch.int32, device)
            _check("it_vals", dev.it_vals, torch.float32, device)
    lib = _load_shard()
    user_offset = mesh.dp_index * U
    item_offset = mesh.ip_index * I
    k0, k1 = _key_words(key)
    it = int(iteration) & 0xFFFFFFFF
    start_user = start_user_of(iteration, n_users_global, rotation)
    ws = w_rating = None
    if mode >= 3:
        ws = torch.empty(lib.sgd_shard_workspace(U, I), dtype=torch.int32,
                         device=device)
        if counts is None:
            counts = torch.zeros(I, dtype=torch.int32, device=device)
        _check("counts", counts, torch.int32, device, (I,))
    else:
        counts = None
    if mode == 0:
        if best is None:
            best = torch.full((I,), INT32_MAX, dtype=torch.int32,
                              device=device)
        _check("best", best, torch.int32, device, (I,))
        w_rating = torch.empty(U, dtype=torch.float32, device=device)
    else:
        best = None
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream

        def assemble(indptr, ids, n, id_offset, own_offset, n_own, table,
                     axis):
            out = torch.empty((n, W), dtype=T_u.dtype, device=device)
            _rc(lib.sgd_shard_assemble(
                indptr.data_ptr(), ids.data_ptr(), n,
                int(id_offset) & 0xFFFFFFFF, own_offset, n_own,
                table.data_ptr(), out.data_ptr(), W, elem, k0, k1, it,
                stream), "sgd_shard_assemble")
            return axis.assemble_(out)

        # The rows the kernels gather across the grid, each assembled
        # before the user kernel: the sampled items' rows over ip, the
        # twin raters' pre-step rows over dp.
        rows = raters = None
        if mesh.n_ip > 1:
            rows = assemble(dev.indptr, dev.indices, U, user_offset,
                            item_offset, I, T_i, mesh.ip)
        if mode == 1 and mesh.n_dp > 1:
            raters = assemble(dev.it_indptr, dev.it_users, I,
                              n_users_global + item_offset, user_offset, U,
                              T_u, mesh.dp)
        T_u_out = torch.empty_like(T_u)
        _rc(lib.sgd_shard_users(
            T_u.data_ptr(), T_u_out.data_ptr(), T_i.data_ptr(), _ptr(rows),
            dev.indptr.data_ptr(), dev.indices.data_ptr(),
            dev.data.data_ptr(), _ptr(best), _ptr(w_rating), _ptr(ws),
            _ptr(counts), U, I, W, F, mu, hp.learning_rate, hp.P_reg,
            hp.user_bias_reg, k0, k1, it, start_user, user_offset,
            item_offset, n_users_global, mode, elem,
            int(rows is None and raters is None), stream), "sgd_shard_users")
        if mode < 0:
            SHARD_LAUNCHES[T_u.dtype, "users"] += 1
            return T_u_out, T_i
        T_i_out = torch.empty_like(T_i)
        dT = denom = None
        if mode != 1:
            dT = torch.empty((I, W), dtype=torch.float32, device=device)
        if mode == 0:
            mesh.dp.min_(best)
        if mode == 3 and mesh.n_dp > 1:
            denom = mesh.dp.sum_(counts.clone())
        _rc(lib.sgd_shard_items(
            T_u.data_ptr(), T_i.data_ptr(), _ptr(T_i_out if mode == 1
                                                 else None),
            _ptr(dT), _ptr(raters), _ptr(dev.it_indptr), _ptr(dev.it_users),
            _ptr(dev.it_vals), _ptr(best), _ptr(w_rating), _ptr(ws),
            _ptr(counts), _ptr(denom), U, I, W, F, mu, hp.learning_rate,
            hp.Q_reg, hp.item_bias_reg, k0, k1, it, start_user, user_offset,
            item_offset, n_users_global, mode, elem,
            int(mesh.n_dp == 1 or mode == 1), stream), "sgd_shard_items")
        if dT is not None:
            mesh.dp.sum_(dT)
            _rc(lib.sgd_shard_apply(T_i.data_ptr(), dT.data_ptr(),
                                    T_i_out.data_ptr(), T_i.numel(), elem,
                                    stream), "sgd_shard_apply")
    SHARD_LAUNCHES[T_u.dtype, collision] += 1
    return T_u_out, T_i_out


def sharded_run_steps(T_u, T_i, mu: float, dev, hp: Hyper, key,
                      start_iter: int, n_steps: int, *, n_factors: int,
                      mesh, n_users_global: int, train_items: bool = True,
                      collision: str = "first_wins"):
    """``n_steps`` sharded steps from ``start_iter``, the election and
    counts buffers carried across them; returns the new blocks."""
    I = T_i.shape[0]
    best = counts = None
    if train_items and collision == "first_wins":
        best = torch.full((I,), INT32_MAX, dtype=torch.int32,
                          device=T_u.device)
    if train_items and collision in ("mean", "sum"):
        counts = torch.zeros(I, dtype=torch.int32, device=T_u.device)
    for k in range(int(n_steps)):
        T_u, T_i = sgd_step_sharded_cuda(
            T_u, T_i, mu, dev, hp, key, int(start_iter) + k,
            n_factors=n_factors, mesh=mesh, n_users_global=n_users_global,
            train_items=train_items, collision=collision, best=best,
            counts=counts)
    return T_u, T_i
