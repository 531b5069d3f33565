"""One BPR iteration on the card — kernel K6.

The TPU package's ``ops/bpr.py::bpr_step`` has no Pallas kernel: XLA fuses
its jnp passes.  Here it is ``csrc/bpr_step.cu``, bound with ctypes: one
launch a step that draws the five streams of ``ops/bpr.py::bpr_draws`` in
registers, bit for bit, and writes both tables afresh from the pre-step
ones (the kernel's header says what bounds it).  Its plain version is
``ops/bpr.py::bpr_step`` on CPU tensors; on CUDA tensors that function
takes this wrapper.

The host's share of a step is the stream keys, the seed's key and
``fold_in(key, t)`` for t = 1..4, computed once a key and kept in
``_STREAM_KEYS``, the iteration as a 32-bit word and the hyperparameters as
float32 scalars: nothing of a step reads the card or builds a tensor on the
host.  The draws run inside the kernel, so the card path records no
``bpr.draws`` span.  ``bpr_step_cuda`` launches the kernel or raises: it
takes CUDA tensors only and never falls back.  ``LAUNCHES`` counts its
launches, one a step.  ``check_factors`` is the widths it takes, for a
trainer to refuse early.
"""

from __future__ import annotations

import ctypes

import torch

from cu2rec_torch.ops.cuda_sgd import _check
from cu2rec_torch.ops.packed import (
    KERNEL_WIDTHS, TABLE_ELEMS, check_kernel_tables, packed_width,
)
from cu2rec_torch.ops.sgd import Hyper, _key_words, fold_in

KERNEL = "bpr_step"
# Step launches in this process (incremented where the kernel launches).
LAUNCHES = 0
# key → its ten stream words: (k0, k1) of the key, then of fold_in(key, t)
# for t = 1..4.
_STREAM_KEYS: dict = {}

_lib = None


def _load():
    global _lib
    if _lib is None:
        from cu2rec_torch.csrc.build import load
        lib = load(KERNEL)
        P, I, F, U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_uint)
        lib.bpr_step_launch.argtypes = (
            [P] * 10 + [I] * 4 + [F] * 5 + [U] * 11 + [I, P])
        lib.bpr_step_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_factors(n_factors: int) -> None:
    """Raise unless K6 takes ``n_factors`` factors: rows of a width in
    ``KERNEL_WIDTHS`` (up to 511 factors and the bias)."""
    W = packed_width(n_factors)
    if W not in KERNEL_WIDTHS:
        raise ValueError(
            f"BPR on the card runs kernel K6, which takes rows of "
            f"{KERNEL_WIDTHS} floats (n_factors up to "
            f"{KERNEL_WIDTHS[-1] - 1}); n_factors {n_factors} needs rows of "
            f"{W}")


def stream_keys(key) -> tuple[int, ...]:
    """The ten key words of a step's five draw streams: ``key``'s, then
    ``fold_in(key, t)``'s for t = 1..4, as ``bpr_draws`` keys them;
    computed once a key."""
    cache_key = key if isinstance(key, tuple) else _key_words(key)
    words = _STREAM_KEYS.get(cache_key)
    if words is None:
        k = _key_words(key)
        words = k + tuple(w for t in range(1, 5) for w in fold_in(k, t))
        _STREAM_KEYS[cache_key] = words
    return words


def bpr_step_cuda(T_u: torch.Tensor, T_i: torch.Tensor, dev, hp: Hyper, key,
                  iteration: int, *, n_factors: int):
    """New ``(T_u, T_i)`` after one BPR step on the card; the inputs are
    left as they were.

    ``T_u`` (U, W) and ``T_i`` (I, W), both float32 or both bf16, of a
    width K0a takes, on one CUDA device; ``dev`` an item-major
    ``DeviceRatings`` there (mirror or lean).  Raises, before anything is
    built or loaded, on any other tables."""
    global LAUNCHES
    elem = TABLE_ELEMS.get(T_u.dtype)
    if elem is None:
        raise TypeError(f"T_u must be float32 or bfloat16, got {T_u.dtype}")
    if T_i.dtype != T_u.dtype:
        raise TypeError(f"T_i is {T_i.dtype}, T_u {T_u.dtype}")
    U, W = T_u.shape
    I = T_i.shape[0]
    F = int(n_factors)
    if tuple(T_i.shape) != (I, W):
        raise ValueError(f"T_i has shape {tuple(T_i.shape)}, want rows of "
                         f"{W}")
    check_kernel_tables("K6", T_u, T_i)
    if not 0 <= F < W:
        raise ValueError(f"n_factors {F} does not fit rows of width {W}")
    device = T_u.device
    if device.type != "cuda":
        raise ValueError(f"bpr_step_cuda takes CUDA tensors, got {device}")
    _check("T_u", T_u, T_u.dtype, device)
    _check("T_i", T_i, T_u.dtype, device)
    if dev.n_users != U or dev.n_items != I:
        raise ValueError(f"ratings are {dev.n_users}x{dev.n_items}, tables "
                         f"{U}x{I}")
    if dev.it_indptr is None:
        raise ValueError("BPR needs item-major arrays: build DeviceRatings "
                         "with item_major=True")
    _check("indptr", dev.indptr, torch.int32, device, (U + 1,))
    _check("indices", dev.indices, torch.int32, device)
    _check("it_indptr", dev.it_indptr, torch.int32, device, (I + 1,))
    lean = dev.it_order is not None
    if lean:
        _check("it_order", dev.it_order, torch.int32, device)
        _check("row_ids", dev.row_ids, torch.int32, device)
    else:
        _check("it_users", dev.it_users, torch.int32, device)
    words = stream_keys(key)
    it = int(iteration) & 0xFFFFFFFF
    lib = _load()
    T_u_out = torch.empty_like(T_u)
    T_i_out = torch.empty_like(T_i)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.bpr_step_launch(
            T_u.data_ptr(), T_u_out.data_ptr(), T_i.data_ptr(),
            T_i_out.data_ptr(), dev.indptr.data_ptr(),
            dev.indices.data_ptr(),
            dev.row_ids.data_ptr() if lean else None,
            dev.it_indptr.data_ptr(),
            None if lean else dev.it_users.data_ptr(),
            dev.it_order.data_ptr() if lean else None,
            U, I, W, F, hp.learning_rate, hp.P_reg, hp.Q_reg,
            hp.user_bias_reg, hp.item_bias_reg, *words, it, elem, stream)
    if rc != 0:
        raise RuntimeError(f"bpr_step launch failed: cudaError {rc}")
    LAUNCHES += 1
    return T_u_out, T_i_out
