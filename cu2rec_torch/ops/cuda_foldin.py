"""The explicit serving fold-in on the card — kernel K0c.

The TPU package runs a batch's whole fold-in as one device program
(``serve/engine.py::ShardedServingEngine._foldin_program``: a
``fori_loop`` over the iterations inside one ``jit``), after compacting
each user's valid ratings to the front on the host; it has no Pallas
kernel.  Here it is ``csrc/foldin.cu``, bound with ctypes: one launch runs
every iteration, each user row held in float4 registers by a group of
lanes, on K0a's counter stream (``csrc/sgd_step.cuh``).  The kernel takes
the request's masked arrays as they arrive and compacts each slot's valid
columns itself; its header says what bounds it and how each link of a
slot's chain of iterations is kept short.  Its plain version is
``serve/engine.py::fold_in_steps``; the engine takes that on CPU tensors
and this wrapper on CUDA tensors.

``fold_in_cuda`` launches the kernel or raises: it takes CUDA tensors
only and never falls back.  ``LAUNCHES`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from cu2rec_torch.ops.cuda_sgd import _check
from cu2rec_torch.ops.packed import TABLE_ELEMS, check_kernel_tables
from cu2rec_torch.ops.sgd import Hyper, _key_words

KERNEL = "foldin"
# Kernel launches in this process (one a fold-in).
LAUNCHES = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        from cu2rec_torch.csrc.build import load
        lib = load(KERNEL)
        P, I, F, U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_uint)
        lib.foldin_launch.argtypes = ([P] * 6 + [I] * 6 + [F] * 4
                                      + [U] * 2 + [P])
        lib.foldin_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def fold_in_cuda(T_u: torch.Tensor, table: torch.Tensor,
                 index: torch.Tensor, vals: torch.Tensor,
                 valid: torch.Tensor, mu: float, hp: Hyper, key,
                 n_steps: int, F: int) -> torch.Tensor:
    """K0c: ``fold_in_steps`` (serve/engine.py) in one launch; returns new
    rows, ``T_u`` unchanged.

    ``T_u`` (Bp, W) float32, W in ``ops/packed.py::KERNEL_WIDTHS``;
    ``table`` (R, W) float32 or bf16; ``index`` (Bp, Dp) int32 rows of the
    table, in ``[0, R)`` where ``valid`` (not checked: that would cost a
    reduction and a host sync; masked-out entries are never read);
    ``vals`` (Bp, Dp) float32; ``valid`` (Bp, Dp) bool, holes allowed.
    All contiguous, on one CUDA device, the two tables on 16-byte
    boundaries."""
    global LAUNCHES
    device = T_u.device
    if device.type != "cuda":
        raise ValueError(f"fold_in_cuda takes CUDA tensors, got {device}")
    if T_u.dim() != 2 or index.dim() != 2:
        raise ValueError(f"need T_u (Bp, W) and index (Bp, Dp), got "
                         f"{tuple(T_u.shape)} and {tuple(index.shape)}")
    Bp, W = T_u.shape
    Dp = index.shape[1]
    elem = TABLE_ELEMS.get(table.dtype)
    if elem is None:
        raise TypeError(f"table must be float32 or bfloat16, got "
                        f"{table.dtype}")
    _check("T_u", T_u, torch.float32, device)
    _check("table", table, table.dtype, device, (table.shape[0], W))
    _check("index", index, torch.int32, device, (Bp, Dp))
    _check("vals", vals, torch.float32, device, (Bp, Dp))
    _check("valid", valid, torch.bool, device, (Bp, Dp))
    check_kernel_tables("K0c", T_u, table)
    if not 0 <= F < W:
        raise ValueError(f"n_factors {F} does not fit rows of width {W}")
    out = torch.empty_like(T_u)
    lib = _load()
    k0, k1 = _key_words(key)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.foldin_launch(
            T_u.data_ptr(), out.data_ptr(), table.data_ptr(),
            index.data_ptr(), vals.data_ptr(), valid.data_ptr(), Bp, Dp, W,
            F, int(n_steps), elem, float(mu),
            hp.learning_rate, hp.P_reg, hp.user_bias_reg, k0, k1, stream)
    if rc != 0:
        raise RuntimeError(f"foldin launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
