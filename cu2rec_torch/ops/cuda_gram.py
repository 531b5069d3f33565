"""The ALS/iALS gather-Gram — kernel K4.

Each system of a chunk (a row of a regular chunk, a segment of a heavy one)
gets its Gram and right-hand side from the rows of the items (users) it
rated, gathered by id:

    ALS   G = Σ x xᵀ,          rhs = Σ x·y,
          x = [q | 1]·m,       y = (r − μ − b)·m
    iALS  G = Σ (α r m) q qᵀ,  rhs = Σ (1 + α r)·m·q

The TPU package runs each chunk as one jitted program
(``ops/als.py::_solve_bucket_weighted``, ``_solve_heavy``,
``ops/ials.py::_solve_ials_bucket``, ``_solve_ials_heavy``).  On the card
it is one hand-written kernel, ``csrc/gather_gram.cu`` (its header says
what bounds it and how it is built): the (B, D, N) design tensor never
reaches device memory, and a regular chunk's ridge is added in its
epilogue.

``gram_rhs_reference`` is the plain version: the gather and ``torch.bmm``
of the design rows for ALS (``design``), the ``einsum``s for iALS.
``gather_gram`` is the one entry point.  On CPU tensors it runs the plain
version and the plain epilogue; on CUDA tensors it launches the kernel or
raises — it never falls back to the plain version or to ``torch.bmm``.
``LAUNCHES`` counts kernel launches, so a run can show that it went through
the kernel.
"""

from __future__ import annotations

import ctypes

import torch

KERNEL = "gather_gram"
# Kernel launches in this process (incremented where the kernel launches).
LAUNCHES = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        from cu2rec_torch.csrc.build import load
        lib = load(KERNEL)
        p, f, i, ll = (ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                       ctypes.c_longlong)
        lib.gather_gram_workspace.argtypes = [i, i, i, i]
        lib.gather_gram_workspace.restype = ll
        lib.gather_gram_launch.argtypes = [
            p, ll, p, p, p, p, f, p, p, p, f, p, p, p, ll, i, i, i, p]
        lib.gather_gram_launch.restype = i
        _lib = lib
    return _lib


def gram_rows(T: torch.Tensor) -> torch.Tensor:
    """``T`` as the rows K4 gathers from: float32, each row contiguous on a
    stride of a multiple of 4 floats (16 bytes; zero columns appended where
    needed).  ``T`` itself where it is such already; a bf16 table is
    widened once here, not once a chunk."""
    T = T.to(torch.float32)
    if (T.stride(1) == 1 and T.stride(0) % 4 == 0
            and T.data_ptr() % 16 == 0):
        return T
    out = torch.zeros((T.shape[0], -(-T.shape[1] // 4) * 4),
                      dtype=torch.float32, device=T.device)
    out[:, :T.shape[1]] = T
    return out


def _gather(rows, idx, B: int, D: int, n: int):
    """(B, D, n) rows, float32 or wider: ``rows[idx]``, or ``rows`` read as
    (B, D, ·) where ``idx`` is None."""
    q = rows.reshape(B, D, -1) if idx is None else rows[idx]
    return q[..., :n].to(torch.promote_types(q.dtype, torch.float32))


def design(rows, idx, vals, mask, mu, n: int):
    """The ALS design of each slice from the design rows [q | 1 | b | 0…]
    (``als.design_table``: ``n`` columns of [q | 1], the bias in column
    ``n``, the last row zero): X = [q | 1] and y = r − μ − b, zero where
    masked: a masked slot reads the zero row, as the TPU package's
    ``X = [q | 1]·mask``.  X is a (B, D, n) view of rows on their own
    stride."""
    z = torch.where(mask, idx, rows.shape[0] - 1)
    R = rows[z]
    y = (vals - mu - R[..., n]) * mask
    return R[..., :n], y


def gram_rhs_reference(rows, idx, vals, mask, n: int, *, mu=None,
                       alpha=None):
    """The plain version of K4 before its epilogue: (G (B, n, n), rhs
    (B, n)) float32.  ALS (``mu`` given; ``rows`` the design rows):
    XᵀX and Xᵀy of ``design``.  iALS (``alpha`` given; ``idx`` None reads
    ``rows`` as (B, D, ·)): Σ (α r m) q qᵀ and Σ (1 + α r) m q."""
    if mu is not None:
        X, y = design(rows, idx, vals, mask, mu, n)
        G = torch.bmm(X.mT, X)
        rhs = torch.bmm(X.mT, y[..., None])[..., 0]
        return G, rhs
    q = _gather(rows, idx, *vals.shape, n)
    m = mask.to(torch.float32)
    w = alpha * vals * m                              # c − 1, masked
    G = torch.einsum("bdf,bdg->bfg", q * w[..., None], q)
    rhs = torch.einsum("bdf,bd->bf", q, (1.0 + alpha * vals) * m)
    return G, rhs


def add_ridge(G, reg_vec, deg) -> torch.Tensor:
    """G + diag(λ · max(deg, 1)) for ``deg`` of one value a system (the ALS
    ridge, scaled by each row's degree)."""
    lam = reg_vec[None, :] * torch.clamp(deg.reshape(-1, 1), min=1.0)
    G.diagonal(dim1=-2, dim2=-1).add_(lam)
    return G


def add_global(G, G_global, reg: float) -> torch.Tensor:
    """G_global + G, then ``reg`` on the diagonal (the iALS system from its
    rated rows' correction)."""
    G = G_global[None] + G
    G.diagonal(dim1=-2, dim2=-1).add_(reg)
    return G


def _check(rows, idx, vals, mask, n, mu, alpha) -> None:
    if (mu is None) == (alpha is None):
        raise ValueError("give mu (ALS) or alpha (iALS), not both")
    if mu is not None and (idx is None or rows.shape[-1] <= n):
        raise ValueError("ALS needs the row ids and design rows with the "
                         "bias in column n")
    if vals.dim() != 2 or tuple(mask.shape) != tuple(vals.shape):
        raise ValueError(f"need vals and mask (B, D), got {tuple(vals.shape)}"
                         f" and {tuple(mask.shape)}")
    if idx is not None and tuple(idx.shape) != tuple(vals.shape):
        raise ValueError(f"idx {tuple(idx.shape)} is not {tuple(vals.shape)}")
    if idx is None and rows.shape[0] != vals.numel():
        raise ValueError(f"{rows.shape[0]} rows read in order, but "
                         f"{vals.numel()} slots")
    if rows.dim() != 2 or not 0 < n <= rows.shape[1]:
        raise ValueError(f"need rows (R, W) with W >= n = {n}, got "
                         f"{tuple(rows.shape)}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    for t in (idx, vals, mask):
        if t is not None and t.device != rows.device:
            raise ValueError(f"a tensor on {t.device}, rows on {rows.device}")


def gather_gram(rows, idx, vals, mask, n: int, *, mu=None, alpha=None,
                reg_vec=None, deg=None, G_global=None, reg: float = 0.0):
    """(G (B, n, n), rhs (B, n)) float32 of a chunk's systems.

    ``rows`` (R, W) is the table the slots read, ``idx`` (B, D) int64 their
    row ids (None for iALS: ``rows`` holds the B·D rows in order, the
    item-sharded engine's assembled rows), ``vals`` (B, D) float32 and
    ``mask`` (B, D) bool.  ALS with ``mu`` (``rows`` the design rows
    [q | 1 | b | 0…], the bias in column n, last row zero:
    ``als.design_table``); iALS with ``alpha``.  Epilogue of a regular
    chunk: ALS ``reg_vec`` (n,) and ``deg`` (B,) add λ·max(deg, 1) to the
    diagonal (``add_ridge``); iALS ``G_global`` (n, n) gives YᵀY + G,
    then ``reg`` on the diagonal (``add_global``).  Without them (heavy
    segments) the raw sums.

    CUDA tensors launch K4 on the current stream without synchronizing
    (G whole, its lower triangle mirrored); CPU tensors run
    ``gram_rhs_reference`` and the same epilogue."""
    global LAUNCHES
    _check(rows, idx, vals, mask, n, mu, alpha)
    if rows.device.type == "cpu":
        G, rhs = gram_rhs_reference(rows, idx, vals, mask, n, mu=mu,
                                    alpha=alpha)
        if reg_vec is not None:
            G = add_ridge(G, reg_vec, deg)
        if G_global is not None:
            G = add_global(G, G_global, reg)
        return G, rhs
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    if vals.shape[0] == 0:
        dev = rows.device
        return (torch.empty((0, n, n), dtype=torch.float32, device=dev),
                torch.empty((0, n), dtype=torch.float32, device=dev))
    out = _launch(rows, idx, vals, mask, n, mu=mu, alpha=alpha,
                  reg_vec=reg_vec, deg=deg, G_global=G_global, reg=reg)
    LAUNCHES += 1
    return out


def _launch(rows, idx, vals, mask, n: int, *, mu=None, alpha=None,
            reg_vec=None, deg=None, G_global=None, reg: float = 0.0):
    """Launches K4 on checked, non-empty CUDA inputs, uncounted; raises if
    the launch fails."""
    dev = rows.device
    B, D = vals.shape
    f32 = torch.float32

    def flat(t, dtype):
        return None if t is None else t.to(dev, dtype).contiguous()

    rows = gram_rows(rows)
    idx, vals, mask = flat(idx, torch.int64), flat(vals, f32), flat(
        mask, torch.bool)
    reg_vec, G_global = flat(reg_vec, f32), flat(G_global, f32)
    deg = None if deg is None else flat(deg.reshape(-1), f32)
    if mu is not None:
        mu = (flat(mu.reshape(1), f32) if torch.is_tensor(mu)
              else torch.full((1,), float(mu), dtype=f32, device=dev))
    if reg_vec is not None and (reg_vec.shape != (n,) or deg is None
                                or deg.shape != (B,)):
        raise ValueError("the ALS ridge needs reg_vec (n,) and deg (B,)")
    if G_global is not None and G_global.shape != (n, n):
        raise ValueError(f"G_global must be ({n}, {n})")
    G = torch.empty((B, n, n), dtype=f32, device=dev)
    rhs = torch.empty((B, n), dtype=f32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _load()
    with torch.cuda.device(dev):
        # The parts' sums, which the second kernel adds and finishes.
        n_work = lib.gather_gram_workspace(B, D, n, int(mu is None))
        if n_work < 0:
            raise RuntimeError(f"gather_gram cannot plan B={B} D={D} n={n}:"
                               f" cudaError {-n_work}")
        work = torch.empty(n_work, dtype=f32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gather_gram_launch(
            rows.data_ptr(), rows.stride(0), ptr(idx), vals.data_ptr(),
            mask.data_ptr(), ptr(mu),
            float(alpha) if alpha is not None else 0.0, ptr(reg_vec),
            ptr(deg), ptr(G_global), float(reg), G.data_ptr(),
            rhs.data_ptr(), work.data_ptr(), n_work, B, D, n, stream)
    if rc != 0:
        raise RuntimeError(f"gather_gram launch failed: cudaError {rc}")
    return G, rhs
