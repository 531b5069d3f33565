"""Alternating Least Squares for biased MF.

Each half sweep solves, for every user with the item side frozen (and then
symmetrically for items), the ridge system

    ( X_uᵀ X_u + diag(λ) ) θ_u = X_uᵀ y_u,      X_u = [ q_i | 1 ]_{i∈S_u}

for θ_u = [p_u, b_u].  Rows are grouped into degree buckets (power-law
degrees: ×2-spaced capacities bound the padding), each bucket's rating
slices are padded to one width, and each chunk of a bucket is one batched
Gram product and one batched ridge solve.  On the card the Grams are
kernel K4 (``ops/cuda_gram.py``: the rows gathered and summed in shared
memory, the ridge added in its epilogue); on the CPU its plain version,
a gather and ``torch.bmm`` in float32.
Rows above the largest capacity take the heavy path: their slice is split
into capacity-sized segments whose partial Grams are summed exactly.

The module mirrors the TPU package's ``ops/als.py`` and keeps its names.
Every solve is kernel K1 on a CUDA tensor, its plain version on a CPU
tensor (``ops/cuda_linalg.py``).  The TPU package chose among several
batched Cholesky implementations because its Pallas kernel padded small
batches to a lane tile and had a VMEM ceiling; K1 has neither, so there is
no choice to make.
The chunks are built once a training run from the flat CSR arrays on
their own device (``prepare_chunks``); only the bucket bookkeeping, which
reads ``indptr`` alone, runs on the host.

What that package does only for its TPU compiler is left out: the fused
one-program dispatch and its fall-back tiers, the disabled-signature store
and the padding of tail chunks to a common shape.  Here a half sweep is a
host loop over chunks; each chunk's solved rows are written into one clone
of the table, so the peak is two tables plus one chunk's temporaries.

Row-sharded sweeps (``row_sharding``, a ``parallel.sharded.Mesh``): the
TPU package shards every chunk's rows over the whole grid (dp × ip
flattened) with the counterpart table replicated, since each row's solve
is independent.  Here each rank keeps its share of each regular chunk's
rows and every n-th heavy chunk (``prepare_chunks``), solves them with K1,
and writes them into a zero-filled table, which is assembled over the grid
with a mask of the rows solved (``parallel/distributed.py``,
``Axis.assemble_``); the rows no rank solved keep their value.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as nnf

from cu2rec_torch.ops.cuda_gram import add_ridge, gather_gram
from cu2rec_torch.ops.cuda_linalg import ridge_solve_batched_cuda
from cu2rec_torch.utils.timing import count, span

# Degree-bucket capacities. A row with degree d lands in the smallest
# bucket with capacity >= d; rows beyond the largest capacity go to the
# heavy path.  Each bucket's width is trimmed to its actual max degree.
BUCKET_CAPS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)

# Elements of a chunk's (chunk, width, F + 1) design tensor.
DEFAULT_BUDGET = 64 << 20


def _rank_rows(row_sharding, s: int, e: int) -> tuple[int, int]:
    """This rank's share [lo, hi) of a regular chunk's rows [s, e): all of
    them without a row sharding."""
    if row_sharding is None:
        return s, e
    n, r, B = row_sharding.size, row_sharding.rank, e - s
    return s + r * B // n, s + (r + 1) * B // n


def _rank_takes(row_sharding, k: int) -> bool:
    """Whether this rank solves the k-th heavy chunk (whole rows only: a
    heavy row's segments must stay in one chunk)."""
    return row_sharding is None or k % row_sharding.size == row_sharding.rank


def assemble_solved(T_new, T_self, solved, row_sharding):
    """The half sweep's table: each row from the rank that solved it (a
    zero-filled ``T_new`` of its rows, ``solved`` an int32 mask of them),
    the rows no rank solved as ``T_self`` holds them."""
    if row_sharding is None:
        return T_new
    axis = row_sharding.world
    axis.assemble_(T_new)
    axis.sum_(solved)
    return torch.where(solved[:, None] > 0, T_new, T_self)


def bucket_meta(indptr: np.ndarray, caps=BUCKET_CAPS) -> list[dict]:
    """Which rows land in which bucket and which flat-CSR slice each padded
    row covers.  Reads only ``indptr``, so that :func:`prepare_chunks`
    extracts the (cols, vals) slices on the device of the flat CSR.

    Regular bucket dict: row_ids (B,), starts (B,), lens (B,), cap.  The
    heavy bucket adds seg_start/seg_end (H,) into its segment axis and the
    true deg (H,); its starts/lens are per segment.
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    deg = np.diff(indptr)
    metas = []
    for bi, cap in enumerate(caps):
        lo = caps[bi - 1] if bi else 0
        sel = np.nonzero((deg > lo) & (deg <= cap))[0]
        if len(sel) == 0:
            continue
        cap_eff = min(cap, int(-(-int(deg[sel].max()) // 8) * 8))
        metas.append(dict(row_ids=sel.astype(np.int32), starts=indptr[sel],
                          lens=deg[sel], cap=cap_eff))
    cap = caps[-1]
    sel = np.nonzero(deg > cap)[0]
    if len(sel):
        d = deg[sel]
        nseg = -(-d // cap)
        seg_end = np.cumsum(nseg)
        seg_start = seg_end - nseg
        owner = np.repeat(np.arange(len(sel)), nseg)          # (S,)
        segidx = np.arange(seg_end[-1]) - seg_start[owner]    # j within row
        sstarts = indptr[sel][owner] + segidx * cap
        slens = np.minimum(indptr[sel + 1][owner] - sstarts, cap)
        metas.append(dict(row_ids=sel.astype(np.int32), starts=sstarts,
                          lens=slens, cap=cap,
                          seg_start=seg_start.astype(np.int32),
                          seg_end=seg_end.astype(np.int32),
                          deg=d.astype(np.float32)))
    return metas


def _heavy_groups(seg_start, seg_end, chunk: int):
    """Group heavy rows into chunks of ≤ ``chunk`` segments, whole rows only
    (the prefix-difference Gram assembly of a row needs all its segments in
    one chunk).  Returns (groups [(lo, hi) row ranges], the largest group's
    row count, chunk — raised to the largest row's segment count)."""
    H = len(seg_start)
    chunk = max(chunk, int((seg_end - seg_start).max()))
    groups = []
    lo = 0
    while lo < H:
        hi = lo
        while hi < H and seg_end[hi] - seg_start[lo] <= chunk:
            hi += 1
        hi = max(hi, lo + 1)
        groups.append((lo, hi))
        lo = hi
    H_pad = max(hi - lo for lo, hi in groups)
    return groups, H_pad, chunk


def _chunk_size(B: int, width: int, F1: int, budget: int) -> int:
    """Rows a chunk, bounding its (chunk, width, F1) design tensor to about
    ``budget`` elements."""
    return max(1, min(B, budget // max(width * F1, 1)))


def _put(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device, dtype)


def _extract_rows(flat_i, flat_d, starts, lens, cap: int):
    """Padded-slice extraction: (B, cap) cols/vals/mask from the flat CSR
    tensors, on their device.  ``flat_*`` must be padded by ≥ cap so that no
    slice runs past their end."""
    j = torch.arange(cap, device=flat_i.device)
    pos = starts[:, None] + j[None, :]
    mask = j[None, :] < lens[:, None]
    cols = torch.where(mask, flat_i[pos], 0)
    vals = torch.where(mask, flat_d[pos], 0.0)
    return cols, vals, mask


class Chunks(list):
    """The chunks of one side (:func:`prepare_chunks`), with what K4 sums
    over them in a half sweep, counted on the host as they were built:
    ``slots``, each chunk's padded B × D (a heavy chunk's segments × cap),
    and ``live``, those of them that hold a rating."""

    slots = live = 0


def prepare_chunks(indices, data, indptr, n_factors: int, nnz: int, *,
                   caps=BUCKET_CAPS, budget: int | None = None,
                   row_sharding=None):
    """The chunks of one side of a CSR for its half sweeps, built once a
    training run on the device of the flat ``indices`` and ``data``
    tensors (their first ``nnz`` entries): each padded (cols, vals, mask)
    slice is extracted there, and only the (starts, lens) vectors that
    :func:`bucket_meta` reads from the host ``indptr`` cross to it.

    Regular chunk: ("reg", cols, vals, mask, rows); heavy chunk: ("heavy",
    cols, vals, mask, rows, seg_start, seg_end, deg), segment ranges
    relative to the chunk.  A chunk holds about ``budget`` elements of its
    (chunk, width, F + 1) design tensor; a tail chunk keeps its own row
    count (no padding rows, so every row id is in range).  With
    ``row_sharding`` only this rank's rows are kept (``_rank_rows``,
    ``_rank_takes``).  Returns a :class:`Chunks`.
    """
    budget = budget or DEFAULT_BUDGET
    dev = indices.device
    F1 = n_factors + 1
    cap_max = caps[-1]
    flat_i = nnf.pad(indices[:nnz].to(torch.int64), (0, cap_max))
    flat_d = nnf.pad(data[:nnz].to(torch.float32), (0, cap_max))

    chunks = Chunks()

    def extract(m, s, e):
        chunks.slots += (e - s) * int(m["cap"])
        chunks.live += int(m["lens"][s:e].sum())
        return _extract_rows(
            flat_i, flat_d, _put(m["starts"][s:e], torch.int64, dev),
            _put(m["lens"][s:e], torch.int64, dev), int(m["cap"]))

    n_heavy = 0
    for m in bucket_meta(indptr, caps):
        B = len(m["starts"])
        chunk = _chunk_size(B, int(m["cap"]), F1, budget)
        if "seg_start" not in m:
            for s in range(0, B, chunk):
                lo, hi = _rank_rows(row_sharding, s, min(s + chunk, B))
                if hi > lo:
                    chunks.append(("reg", *extract(m, lo, hi),
                                   _put(m["row_ids"][lo:hi], torch.int64,
                                        dev)))
            continue

        seg_start, seg_end = m["seg_start"], m["seg_end"]
        groups, _h, chunk = _heavy_groups(seg_start, seg_end, chunk)
        for lo, hi in groups:
            n_heavy += 1
            if not _rank_takes(row_sharding, n_heavy - 1):
                continue
            s0, s1 = int(seg_start[lo]), int(seg_end[hi - 1])
            chunks.append((
                "heavy", *extract(m, s0, s1),
                _put(m["row_ids"][lo:hi], torch.int64, dev),
                _put(seg_start[lo:hi] - s0, torch.int64, dev),
                _put(seg_end[lo:hi] - s0, torch.int64, dev),
                _put(m["deg"][lo:hi], torch.float32, dev)))
    return chunks


def split_chunks(chunks):
    """(regular chunks, heavy chunks), each without its tag; raises on an
    unknown tag, so that no chunk's rows are silently left unsolved."""
    regs = [ch[1:] for ch in chunks if ch[0] == "reg"]
    heavies = [ch[1:] for ch in chunks if ch[0] == "heavy"]
    if len(regs) + len(heavies) != len(chunks):
        raise ValueError(
            "unknown chunk tag(s): "
            f"{sorted({ch[0] for ch in chunks} - {'reg', 'heavy'})}")
    return regs, heavies


def reg_vector(factor_reg: float, bias_reg: float, n_factors: int,
               device=None) -> torch.Tensor:
    """[factor_reg] * F + [bias_reg], float32."""
    return torch.tensor([factor_reg] * n_factors + [bias_reg],
                        dtype=torch.float32, device=device)


def als_half_sweep(T_self, T_other, chunks, mu,
                   factor_reg: float, bias_reg: float, n_factors: int,
                   weight_by_degree: bool = True, row_sharding=None):
    """Every row of the packed table ``T_self`` solved given the frozen
    ``T_other``; returns a new table.

    ``chunks`` is a chunk list from :func:`prepare_chunks` (built once,
    swept many times).  With ``weight_by_degree`` the
    ridge term is scaled by each row's degree (λ·|S|, Zhou et al.).  Rows
    with no ratings are in no chunk and come out unchanged.  With
    ``row_sharding`` each rank solves the rows of its chunks (from
    ``prepare_chunks(..., row_sharding)``) and every rank returns the
    whole table (``assemble_solved``).  Counters: ``als.chunks``, and where
    ``chunks`` is a :class:`Chunks`, ``als.gram_slots`` and
    ``als.gram_live_slots`` (its ``slots`` and ``live``).
    """
    F = n_factors
    dev = T_self.device
    with span("als.half_sweep"):
        reg = reg_vector(factor_reg, bias_reg, F, dev)
        regs, heavies = split_chunks(chunks)
        count("als.chunks", len(regs) + len(heavies))
        if isinstance(chunks, Chunks):
            count("als.gram_slots", chunks.slots)
            count("als.gram_live_slots", chunks.live)
        mu32 = torch.tensor(float(mu), dtype=torch.float32, device=dev)
        T_x = design_table(T_other, F)
        T_new, solved = _solve_into(T_self, row_sharding)
        for ch in regs:
            with span("als.chunk"):
                _als_apply_reg(T_new, T_x, ch, mu32, reg, F,
                               weight_by_degree)
        for ch in heavies:
            with span("als.chunk"):
                _als_apply_heavy(T_new, T_x, ch, mu32, reg, F,
                                 weight_by_degree)
        if solved is not None:
            for ch in regs + heavies:
                solved[ch[3]] = 1
        return assemble_solved(T_new, T_self, solved, row_sharding)


def _solve_into(T_self, row_sharding):
    """(the table the solved rows are written into, the mask of them):
    a clone of ``T_self`` on one device; under a row sharding a zero-filled
    table and a zero int32 mask, assembled by ``assemble_solved``."""
    if row_sharding is None:
        return T_self.clone(), None
    return (torch.zeros_like(T_self),
            torch.zeros(T_self.shape[0], dtype=torch.int32,
                        device=T_self.device))


def _scatter_theta(T_new, theta, rows, F: int) -> None:
    """Write solved [p | b] rows into the packed table in place (padding
    columns zero)."""
    T_new[rows] = nnf.pad(theta, (0, T_new.shape[1] - (F + 1))).to(
        T_new.dtype)


def _als_apply_reg(T_new, T_other, ch, mu, reg, F,
                   weight_by_degree) -> None:
    cols, vals, mask, rows = ch
    if weight_by_degree:
        deg = mask.sum(dim=1).to(torch.float32)[:, None]
    else:
        deg = torch.ones((cols.shape[0], 1), dtype=torch.float32,
                         device=cols.device)
    theta = _solve_bucket_weighted(T_other, cols, vals, mask, mu, reg, deg)
    _scatter_theta(T_new, theta, rows, F)


def _als_apply_heavy(T_new, T_other, ch, mu, reg, F,
                     weight_by_degree) -> None:
    cols, vals, mask, rows, s0, s1, degv = ch
    if not weight_by_degree:
        degv = torch.ones_like(degv)
    theta = _solve_heavy(T_other, cols, vals, mask, mu, reg, s0, s1, degv)
    _scatter_theta(T_new, theta, rows, F)


class DesignTable(NamedTuple):
    """The counterpart table as the design rows read it: ``rows`` (N + 1,
    4⌈(F+2)/4⌉) float32 holds [q | 1 | b | 0…] per row, so that one gather
    brings a slot's design row and its bias; row N is zero, and a masked
    slot reads it."""

    rows: torch.Tensor


def design_table(T_other, F: int) -> DesignTable:
    """The ``DesignTable`` of a packed table (built once a half sweep)."""
    N = T_other.shape[0]
    rows = torch.zeros((N + 1, -(-(F + 2) // 4) * 4), dtype=torch.float32,
                       device=T_other.device)
    rows[:N, :F] = T_other[:, :F]
    rows[:N, F] = 1.0
    rows[:N, F + 1] = T_other[:, F]
    return DesignTable(rows)


def _as_design(T_other, F: int) -> DesignTable:
    return (T_other if isinstance(T_other, DesignTable)
            else design_table(T_other, F))


def bucket_system(T_other, cols, vals, mask, mu, reg_vec, deg):
    """(G, rhs) of a regular chunk: its ridge systems before the solve
    (K4 on the card, the ridge in its epilogue)."""
    F = reg_vec.shape[0] - 1
    T = _as_design(T_other, F)
    return gather_gram(T.rows, cols, vals, mask, F + 1, mu=mu,
                       reg_vec=reg_vec, deg=deg)


def _solve_bucket_weighted(T_other, cols, vals, mask, mu, reg_vec, deg):
    return _ridge_finish(*bucket_system(T_other, cols, vals, mask, mu,
                                        reg_vec, deg))


def _ridge_finish(G, rhs):
    """θ = G⁻¹ rhs for ``G`` (B, N, N) SPD and ``rhs`` (B, N): K1 on CUDA
    tensors, its plain version on CPU tensors."""
    return ridge_solve_batched_cuda(G.contiguous(), rhs.contiguous())


def segment_sums(Gseg, rseg, seg_start, seg_end):
    """Each heavy row's Gram and rhs: the sum of its segments' partial sums,
    as a difference of exclusive prefix sums (the TPU package's exact
    assembly)."""
    F1 = Gseg.shape[-1]
    zG = torch.zeros((1, F1, F1), dtype=torch.float32, device=Gseg.device)
    zr = torch.zeros((1, F1), dtype=torch.float32, device=Gseg.device)
    Gz = torch.cat([zG, torch.cumsum(Gseg, dim=0)], dim=0)
    rz = torch.cat([zr, torch.cumsum(rseg, dim=0)], dim=0)
    return Gz[seg_end] - Gz[seg_start], rz[seg_end] - rz[seg_start]


def heavy_system(T_other, cols, vals, mask, mu, reg_vec, seg_start, seg_end,
                 deg):
    """(G, rhs) of a heavy chunk: each row's segments' partial Grams summed
    exactly, then the ridge term of its true degree.  On the card K4
    writes the segments' raw sums."""
    F = reg_vec.shape[0] - 1
    T = _as_design(T_other, F)
    Gseg, rseg = gather_gram(T.rows, cols, vals, mask, F + 1, mu=mu)
    G, rhs = segment_sums(Gseg, rseg, seg_start, seg_end)
    return add_ridge(G, reg_vec, deg), rhs


def _solve_heavy(T_other, cols, vals, mask, mu, reg_vec, seg_start, seg_end,
                 deg):
    """Exact ridge solve for rows of degree > caps[-1]: no truncation of
    hot rows."""
    return _ridge_finish(*heavy_system(T_other, cols, vals, mask, mu,
                                       reg_vec, seg_start, seg_end, deg))
