"""Batched ridge solve θ = G⁻¹·rhs for many small SPD systems — kernel K1.

The port of the TPU package's ``ops/pallas_linalg.py::_ridge_kernel``: a
CUDA kernel for Hopper (``csrc/ridge_cholesky.cu``, one thread block per
system; its header says what bounds it and why it is built so), and
``ridge_solve_reference``, the same column loop written with batched torch
ops.

``ridge_solve_batched_cuda`` is the one entry point.  On CPU tensors it runs
the plain version; on CUDA tensors it launches the kernel or raises — it
never falls back to the plain version or to a library solver.  ``LAUNCHES``
counts kernel launches, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

KERNEL = "ridge_cholesky"
# Kernel launches in this process (incremented where the kernel launches).
LAUNCHES = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        from cu2rec_torch.csrc.build import load
        lib = load(KERNEL)
        lib.ridge_cholesky_scratch_floats.argtypes = [ctypes.c_int]
        lib.ridge_cholesky_scratch_floats.restype = ctypes.c_longlong
        lib.ridge_cholesky_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.ridge_cholesky_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def ridge_solve_reference(G: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The plain version of K1: the same right-looking Cholesky (pivot
    scaled by ``rsqrt``), forward and back substitution, vectorized over
    the batch.  ``G`` (B, N, N), ``rhs`` (B, N) float32 → θ (B, N).  Uses
    no ``torch.linalg``, so it is independent of any library solver."""
    A = G.to(torch.float32).clone()
    x = rhs.to(torch.float32).clone()
    n = A.shape[-1]
    for j in range(n):
        dinv = torch.rsqrt(A[:, j, j])
        col = A[:, j:, j] * dinv[:, None]
        A[:, j:, j] = col
        if j + 1 < n:
            tail = col[:, 1:]
            A[:, j + 1:, j + 1:] -= tail[:, :, None] * tail[:, None, :]
    for j in range(n):
        acc = torch.sum(A[:, j, :j] * x[:, :j], dim=-1)
        x[:, j] = (x[:, j] - acc) / A[:, j, j]
    for j in range(n - 1, -1, -1):
        acc = torch.sum(A[:, j + 1:, j] * x[:, j + 1:], dim=-1)
        x[:, j] = (x[:, j] - acc) / A[:, j, j]
    return x


def _check(G: torch.Tensor, rhs: torch.Tensor) -> None:
    if G.device != rhs.device:
        raise ValueError(f"G on {G.device} but rhs on {rhs.device}")
    if G.dtype != torch.float32 or rhs.dtype != torch.float32:
        raise TypeError(f"float32 required, got {G.dtype} / {rhs.dtype}")
    if (G.dim() != 3 or G.shape[1] != G.shape[2] or rhs.dim() != 2
            or tuple(rhs.shape) != tuple(G.shape[:2])):
        raise ValueError(f"need G (B, N, N) and rhs (B, N), got "
                         f"{tuple(G.shape)} and {tuple(rhs.shape)}")


def ridge_solve_batched_cuda(G: torch.Tensor,
                             rhs: torch.Tensor) -> torch.Tensor:
    """θ = G⁻¹ rhs per system: ``G`` (B, N, N) SPD, ``rhs`` (B, N), float32.

    CUDA tensors launch K1 on the current stream without synchronizing;
    CPU tensors run ``ridge_solve_reference``."""
    global LAUNCHES
    _check(G, rhs)
    if G.device.type == "cpu":
        return ridge_solve_reference(G, rhs)
    if G.device.type != "cuda":
        raise ValueError(f"unsupported device {G.device}")
    if not (G.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("G and rhs must be contiguous")
    B, n = rhs.shape
    out = torch.empty_like(rhs)
    if B == 0 or n == 0:
        return out
    lib = _load()
    with torch.cuda.device(G.device):
        per_system = lib.ridge_cholesky_scratch_floats(n)
        if per_system < 0:
            raise RuntimeError("ridge_cholesky: device query failed")
        scratch = (torch.empty(B * per_system, dtype=torch.float32,
                               device=G.device) if per_system else None)
        stream = torch.cuda.current_stream(G.device).cuda_stream
        rc = lib.ridge_cholesky_launch(
            G.data_ptr(), rhs.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            B, n, stream)
    if rc != 0:
        raise RuntimeError(f"ridge_cholesky launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
