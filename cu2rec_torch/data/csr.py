"""Host-side CSR build (NumPy).

Reference parity: ``createSparseMatrix`` (util.cu:152-179) builds CSR from
user-sorted ratings, filling gaps for missing users by repeating indptr
values.  This is the host half of the TPU package's ``data/csr.py``; the
device-resident container (``to_device``) comes with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cu2rec_torch.data.ratings import RatingsData


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
                    n_users: int, n_items: int) -> CSRRatings:
    """CSR from (possibly unsorted) triplets — sorts by (user, item)."""
    order = np.lexsort((items, users))
    rd = RatingsData(users=users[order].astype(np.int32),
                     items=items[order].astype(np.int32),
                     ratings=data[order].astype(np.float32),
                     n_users=n_users, n_items=n_items,
                     global_bias=float(np.mean(data)) if len(data) else 0.0)
    return build_csr(rd, n_users, n_items)
