"""Batched ridge solve θ = G⁻¹·rhs for many small SPD systems — kernel K1.

The port of the TPU package's ``ops/pallas_linalg.py::_ridge_kernel``: CUDA
kernels for Hopper (``csrc/ridge_cholesky.cu``; its header says what bounds
them and why they are built so), and ``ridge_solve_reference``, the same
column loop written with batched torch ops.

``kernel_for(n)`` picks the kernel from N alone: the register-resident
bucket kernel whose augmented triangle of 32, 64, 104 or 128 rows holds
N + 1 rows, else the blocked one-block-a-system kernel with its augmented
triangle in shared memory (N ≤ 338, a block's 227 KB on an H100), else a
one-block-a-system kernel on global scratch.

``ridge_solve_batched_cuda`` is the one entry point.  On CPU tensors it runs
the plain version; on CUDA tensors it launches the kernel or raises — it
never falls back to the plain version or to a library solver.  ``LAUNCHES``
counts kernel launches, so a run can show that it went through the kernel,
and each launch also counts as ``k1.<kernel>`` (``utils/timing.py::count``,
recorded only while a trace is on).
"""

from __future__ import annotations

import ctypes

import torch

from cu2rec_torch.utils.timing import count

KERNEL = "ridge_cholesky"
# Kernel launches in this process (incremented where the kernel launches).
LAUNCHES = 0

_lib = None

# Augmented rows (N + 1) each bucket kernel takes, smallest first.
BUCKET_ROWS = (32, 64, 104, 128)
# The largest N whose augmented triangle (rhs as its last row) and one
# vector of N floats fit a block's shared memory on an H100 (232,448 bytes).
SHARED_MAX_N = 338


def kernel_for(n: int) -> str:
    """The kernel K1 launches for systems of size ``n`` (≥ 1): the smallest
    ``"bucket<rows>"`` of ``BUCKET_ROWS`` that n + 1 fits, else ``"shared"``
    up to ``SHARED_MAX_N``, else ``"global"``."""
    for rows in BUCKET_ROWS:
        if n + 1 <= rows:
            return f"bucket{rows}"
    return "shared" if n <= SHARED_MAX_N else "global"


# Each kernel's code in ``ridge_cholesky_launch``.
_KERNEL_CODE = {**{f"bucket{rows}": rows for rows in BUCKET_ROWS},
                "shared": 0, "global": -1}


def _load():
    global _lib
    if _lib is None:
        from cu2rec_torch.csrc.build import load
        lib = load(KERNEL)
        lib.ridge_cholesky_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
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

    CUDA tensors launch the kernel ``kernel_for(N)`` names on the current
    stream without synchronizing, and count it (``LAUNCHES`` and the
    counter ``k1.<kernel>``); CPU tensors run ``ridge_solve_reference``."""
    global LAUNCHES
    _check(G, rhs)
    if G.device.type == "cpu":
        return ridge_solve_reference(G, rhs)
    if G.device.type != "cuda":
        raise ValueError(f"unsupported device {G.device}")
    if not (G.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("G and rhs must be contiguous")
    B, n = rhs.shape
    if B == 0 or n == 0:
        return torch.empty_like(rhs)
    kernel = kernel_for(n)
    out = _launch(G, rhs, kernel)
    LAUNCHES += 1
    count(f"k1.{kernel}")
    return out


def _launch(G: torch.Tensor, rhs: torch.Tensor,
            kernel: str) -> torch.Tensor:
    """Launches ``kernel`` (a name ``kernel_for`` returns; the bucket kernel
    only where N + 1 fits it) on checked, contiguous, non-empty CUDA
    inputs, uncounted; raises if the launch fails."""
    B, n = rhs.shape
    out = torch.empty_like(rhs)
    lib = _load()
    with torch.cuda.device(G.device):
        # The global-scratch kernel's workspace: triangle, pivot column and
        # solution of each system.
        scratch = (torch.empty(B * (n * (n + 1) // 2 + 2 * n),
                               dtype=torch.float32, device=G.device)
                   if kernel == "global" else None)
        stream = torch.cuda.current_stream(G.device).cuda_stream
        rc = lib.ridge_cholesky_launch(
            G.data_ptr(), rhs.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            B, n, _KERNEL_CODE[kernel], stream)
    if rc != 0:
        raise RuntimeError(f"ridge_cholesky ({kernel}) launch failed: "
                           f"cudaError {rc}")
    return out
