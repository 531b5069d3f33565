"""Host-side CSR build (NumPy) and the device-resident ratings.

Reference parity: ``createSparseMatrix`` (util.cu:152-179) builds CSR from
user-sorted ratings, filling gaps for missing users by repeating indptr
values; ``CudaCSRMatrix`` (matrix.{h,cu}) owns the device copies.  This is
the TPU package's ``data/csr.py`` without its TPU gather tricks: no
interleaved (id, rating) packs and no padding to 128-multiples — the
kernels gather single elements at full rate, and the sampled streams do
not depend on the layout.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cu2rec_torch.data import native
from cu2rec_torch.data.ratings import RatingsData
from cu2rec_torch.utils.device import resolve_device


@dataclass
class CSRRatings:
    """Host CSR ratings matrix (counts/indices int32, data float32)."""

    indptr: np.ndarray    # (n_users + 1,)
    indices: np.ndarray   # (nnz,) item ids
    data: np.ndarray      # (nnz,) ratings
    n_users: int
    n_items: int

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def row_ids(self) -> np.ndarray:
        """Per-nonzero user id (inverse of indptr)."""
        counts = np.diff(self.indptr)
        return np.repeat(np.arange(self.n_users, dtype=np.int32), counts)


def build_csr(ratings: RatingsData, n_users: int | None = None,
              n_items: int | None = None) -> CSRRatings:
    """Build CSR from ratings sorted by user id.

    Precondition (same as reference util.cu:149-150): rows sorted by userID.
    Missing users appear as repeated indptr values (util.cu:159-164) —
    counts+cumsum reproduces that exactly.
    """
    n_users = ratings.n_users if n_users is None else n_users
    n_items = ratings.n_items if n_items is None else n_items
    u = ratings.users
    if u.shape[0] > 1 and np.any(np.diff(u) < 0):
        raise ValueError("ratings must be sorted by user id")
    counts = np.bincount(u, minlength=n_users).astype(np.int64)
    indptr = np.zeros(n_users + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    return CSRRatings(
        indptr=indptr,
        indices=ratings.items.astype(np.int32),
        data=ratings.ratings.astype(np.float32),
        n_users=n_users,
        n_items=n_items,
    )


def normalize_csr_dims(csr: CSRRatings, n_users: int,
                       n_items: int) -> CSRRatings:
    """Grow a CSR's dimensions to (n_users, n_items) without moving data.

    Growing the user axis appends empty rows (repeated indptr values);
    growing the item axis is metadata only.  Shrinking raises: it would
    drop ratings.
    """
    if n_users < csr.n_users or n_items < csr.n_items:
        raise ValueError(
            f"cannot shrink CSR dims ({csr.n_users}x{csr.n_items}) to "
            f"({n_users}x{n_items})")
    if n_users == csr.n_users and n_items == csr.n_items:
        return csr
    indptr = np.concatenate([
        csr.indptr,
        np.full(n_users - csr.n_users, csr.indptr[-1],
                dtype=csr.indptr.dtype)])
    return CSRRatings(indptr=indptr, indices=csr.indices, data=csr.data,
                      n_users=n_users, n_items=n_items)


def csr_from_arrays(users: np.ndarray, items: np.ndarray, data: np.ndarray,
                    n_users: int, n_items: int,
                    use_native: bool = True) -> CSRRatings:
    """CSR from (possibly unsorted) triplets — sorts by (user, item).

    The native parallel counting sort builds it (``np.lexsort`` takes ~9 s
    for 20M ratings, the counting sort well under 1 s) unless
    ``use_native`` is False or the native path is off (``data/native.py``);
    then NumPy does."""
    if use_native and len(users) > 0 and native.available():
        indptr, s_items, s_data = native.native_csr_build(
            np.asarray(users), np.asarray(items), np.asarray(data), n_users)
        return CSRRatings(indptr=indptr, indices=s_items, data=s_data,
                          n_users=n_users, n_items=n_items)
    order = np.lexsort((items, users))
    rd = RatingsData(users=users[order].astype(np.int32),
                     items=items[order].astype(np.int32),
                     ratings=data[order].astype(np.float32),
                     n_users=n_users, n_items=n_items,
                     global_bias=float(np.mean(data)) if len(data) else 0.0)
    return build_csr(rd, n_users, n_items)


@dataclass
class DeviceRatings:
    """Device-resident CSR ratings: int32/float32 tensors on one device.

    ``row_ids`` is the indptr expansion (the user of each rating), used by
    evaluation and by the lean twin path.  With ``item_major`` the item
    side's sampling structure is present too: ``it_indptr`` over items and
    either the item-major mirror of (user, rating) (``it_users``,
    ``it_vals``) or, lean, the item-major→flat permutation ``it_order``
    (4 bytes a rating instead of 8).  ``indptr`` is None for an eval-only
    subsample, which cannot be sampled from.

    On the card the arrays are written by host-to-device copies
    (``to_device``), and nothing writes them while steps run.  The SGD step
    (``ops/cuda_sgd.py``) samples from ``indptr``, ``indices`` and ``data``
    while the kernel ahead of it on the stream may still be ending, and
    CUDA makes that kernel's writes certain to be visible only later.  So
    arrays built on the card by a kernel must be finished before the step
    is queued: ``torch.cuda.synchronize()``, or an event the host waits on.
    """

    indptr: torch.Tensor | None   # (n_users + 1,) int32
    indices: torch.Tensor         # (nnz,) int32 item ids
    data: torch.Tensor            # (nnz,) float32 ratings
    row_ids: torch.Tensor         # (nnz,) int32 user ids
    nnz: int
    n_users: int
    n_items: int
    it_indptr: torch.Tensor | None = None   # (n_items + 1,) int32
    it_users: torch.Tensor | None = None    # (nnz,) int32, item-major
    it_vals: torch.Tensor | None = None     # (nnz,) float32, item-major
    it_order: torch.Tensor | None = None    # (nnz,) int32, lean


def transpose_order(csr: CSRRatings):
    """(it_indptr over items, item-major→flat permutation): ratings sorted
    by (item, user).  The rows of a CSR are user-sorted, so a stable sort
    by item gives the order the (item, user) lexsort gives."""
    order = np.argsort(csr.indices, kind="stable")
    counts = np.bincount(csr.indices, minlength=csr.n_items)
    it_indptr = np.zeros(csr.n_items + 1, dtype=np.int64)
    np.cumsum(counts, out=it_indptr[1:])
    return it_indptr, order


def transpose_csr(csr: CSRRatings):
    """Item-major view of the ratings: (it_indptr over items, user row_ids
    sorted by (item, user), ratings in the same order)."""
    it_indptr, order = transpose_order(csr)
    return it_indptr, csr.row_ids[order].astype(np.int32), csr.data[order]


def to_device(csr: CSRRatings, device=None, item_major: bool = False,
              lean: bool = False) -> DeviceRatings:
    """Upload a host CSR (the H→D boundary of matrix.cu:28-40).

    ``item_major=True`` also uploads the item side's sampling structure for
    the twin step: the (user, rating) mirror, or with ``lean=True`` only
    the permutation into the resident ``row_ids``/``data``.  The sampled
    streams are the same either way."""
    dev = resolve_device(device)

    def put(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(dev)

    row_ids = csr.row_ids
    extra = {}
    if item_major:
        if lean:
            ip, order = transpose_order(csr)
            extra["it_order"] = put(order, np.int32)
        else:
            ip, users, vals = transpose_csr(csr)
            extra["it_users"] = put(users, np.int32)
            extra["it_vals"] = put(vals, np.float32)
        extra["it_indptr"] = put(ip, np.int32)
    return DeviceRatings(
        indptr=put(csr.indptr, np.int32), indices=put(csr.indices, np.int32),
        data=put(csr.data, np.float32), row_ids=put(row_ids, np.int32),
        nnz=csr.nnz, n_users=csr.n_users, n_items=csr.n_items, **extra)


def eval_window_span(row_ids: np.ndarray, nnz: int,
                     chunk: int = 1 << 18) -> int:
    """Max row-range width any ``chunk``-rating slice spans, rounded up to
    a multiple of 8 (``row_ids[:nnz]`` non-decreasing).  The TPU package
    sizes its windowed eval with it; here it is a statistic of the data."""
    if nnz <= 0:
        return 0
    starts = np.arange(0, nnz, chunk)
    ends = np.minimum(starts + chunk, nnz) - 1
    span = int((row_ids[ends].astype(np.int64)
                - row_ids[starts].astype(np.int64)).max() + 1)
    return -(-span // 8) * 8
