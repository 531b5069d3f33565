"""Σerr² and Σ|err| over packed tables on the card — kernel K0b.

The TPU package's ``ops/loss.py::_eval_packed_jit`` has no Pallas kernel:
XLA fuses it.  Here it is ``csrc/eval_error.cu``, bound with ctypes: each
warp stages a chunk of ratings, a group of lanes takes a run of them with
the user row held while the user repeats (eight item rows in flight a
warp at W = 128; float32 or bf16 rows, upcast as they load), and a
deterministic two-launch float64 reduction adds the sums.  It takes the
widths in
``ops/packed.py::KERNEL_WIDTHS``.  Its plain version is
``ops/loss.py::packed_error_sums_reference``; ``evaluate_packed`` takes that
on CPU tensors and this wrapper on CUDA tensors.

``packed_error_sums_cuda`` launches the kernel or raises: it takes CUDA
tensors only and never falls back.  ``LAUNCHES`` counts its calls by table
dtype.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from cu2rec_torch.ops.packed import TABLE_ELEMS, check_kernel_tables

KERNEL = "eval_error"
# Eval launches in this process (incremented where the kernel launches),
# by table dtype; ``LAUNCHES.total()`` counts them all.
LAUNCHES: Counter = Counter()

_lib = None


def _load():
    global _lib
    if _lib is None:
        from cu2rec_torch.csrc.build import load
        lib = load(KERNEL)
        lib.eval_error_partials.argtypes = [ctypes.c_longlong]
        lib.eval_error_partials.restype = ctypes.c_int
        P = ctypes.c_void_p
        lib.eval_error_launch.argtypes = [
            P, P, P, P, P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, P, P, ctypes.c_int, P]
        lib.eval_error_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def packed_error_sums_cuda(T_u: torch.Tensor, T_i: torch.Tensor, mu: float,
                           rows: torch.Tensor, cols: torch.Tensor,
                           vals: torch.Tensor,
                           n_factors: int) -> torch.Tensor:
    """(Σerr², Σ|err|) as a float64 (2,) tensor on the card, not yet
    synchronized.  The tables are both float32 or both bf16;
    ``rows``/``cols`` int32 and ``vals`` float32, of one length, on the
    tables' CUDA device."""
    device = T_u.device
    if device.type != "cuda":
        raise ValueError(f"packed_error_sums_cuda takes CUDA tensors, got "
                         f"{device}")
    W = T_u.shape[1]
    F = int(n_factors)
    elem = TABLE_ELEMS.get(T_u.dtype)
    if elem is None:
        raise TypeError(f"T_u must be float32 or bfloat16, got {T_u.dtype}")
    for name, t, dtype in (("T_u", T_u, T_u.dtype),
                           ("T_i", T_i, T_u.dtype),
                           ("rows", rows, torch.int32),
                           ("cols", cols, torch.int32),
                           ("vals", vals, torch.float32)):
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, T_u on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = rows.shape[0]
    if T_i.dim() != 2 or T_i.shape[1] != W or not 0 <= F < W or \
            cols.shape[0] != n or vals.shape[0] != n:
        raise ValueError(f"bad shapes: T_u {tuple(T_u.shape)}, T_i "
                         f"{tuple(T_i.shape)}, F={F}, ratings {n}/"
                         f"{cols.shape[0]}/{vals.shape[0]}")
    check_kernel_tables("K0b", T_u, T_i)
    lib = _load()
    partials = torch.empty(lib.eval_error_partials(n), dtype=torch.float64,
                           device=device)
    out = torch.empty(2, dtype=torch.float64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.eval_error_launch(
            T_u.data_ptr(), T_i.data_ptr(), rows.data_ptr(), cols.data_ptr(),
            vals.data_ptr(), n, W, F, mu, partials.data_ptr(),
            out.data_ptr(), elem, stream)
    if rc != 0:
        raise RuntimeError(f"eval_error launch failed: cudaError {rc}")
    LAUNCHES[T_u.dtype] += 1
    return out
