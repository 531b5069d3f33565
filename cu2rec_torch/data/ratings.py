"""Ratings and component-array I/O (host side, NumPy).

Capability parity with reference matrix_factorization/util.cu:
  * ``read_ratings_csv``  ≙ ``readCSV``        (util.cu:17-45)
  * ``read_array``        ≙ ``read_array``     (util.cu:52-81)
  * ``write_csv``         ≙ ``writeCSV``       (util.cu:86-97)
  * ``write_component``   ≙ ``writeToFile``    (util.cu:99-103)

File contracts preserved exactly:
  * ratings files are ``userId,itemId,rating`` with a header line, ids are
    sequential and 1-based on disk, 0-based in memory; the number of users /
    items is the maximum id; the global bias is the mean rating;
  * component CSVs are row-major floats printed with 6 decimals and named
    ``{dir}/{base}_f{factors}_{component}.csv``.

This is the NumPy reader path of the TPU package's ``data/ratings.py``; the
native C++ ingest is not ported yet (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class RatingsData:
    """A parsed ratings file (the array-of-struct ``vector<Rating>`` of the
    reference, util.h:19-24, as structure-of-arrays)."""

    users: np.ndarray   # int32, 0-based
    items: np.ndarray   # int32, 0-based
    ratings: np.ndarray  # float32
    n_users: int        # = max 1-based userId
    n_items: int        # = max 1-based itemId
    global_bias: float  # mean rating

    @property
    def nnz(self) -> int:
        return int(self.users.shape[0])


def _read_numpy(path: str, delimiter: str = ",", skip_header: int = 1):
    # Ids parse as int64 directly: routing them through float64 would round
    # ids above 2^53.  One data line is sniffed first so a file with
    # float-formatted ids ("1.0") goes straight to the permissive parse.
    strict = True
    try:
        with open(path) as f:
            for _ in range(skip_header):
                f.readline()
            first = f.readline().strip()
        if first:
            parts = [p.strip() for p in first.split(delimiter)]
            int(parts[0]), int(parts[1])
    except (ValueError, IndexError):
        strict = False
    except OSError:
        pass  # let genfromtxt produce the canonical error below
    if strict:
        try:
            raw = np.genfromtxt(
                path, delimiter=delimiter, skip_header=skip_header,
                dtype=[("u", "U24"), ("i", "U24"), ("r", np.float32)])
            if raw.ndim == 0:
                raw = raw[None]
            if raw.size == 0:
                return (np.empty(0, np.int64), np.empty(0, np.int64),
                        np.empty(0, np.float32))
            return (raw["u"].astype(np.int64), raw["i"].astype(np.int64),
                    raw["r"].copy())
        except ValueError:
            pass  # ids not plain integers: the permissive parse below
    raw = np.genfromtxt(path, delimiter=delimiter, skip_header=skip_header,
                        dtype=np.float64)
    if raw.ndim == 1:
        raw = raw[None, :]
    if raw.shape[1] == 0:
        # Empty / header-only file: genfromtxt yields shape (1, 0).
        return (np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.float32))
    return (raw[:, 0].astype(np.int64), raw[:, 1].astype(np.int64),
            raw[:, 2].astype(np.float32))


def read_ratings_csv(path: str, delimiter: str = ",",
                     has_header: bool = True) -> RatingsData:
    """Read a ``userId,itemId,rating`` CSV (1-based ids, header line).

    Returns ids 0-based with n_users/n_items = max id and global_bias = mean,
    matching reference util.cu:17-45.
    """
    u, i, r = _read_numpy(path, delimiter, 1 if has_header else 0)
    if u.shape[0] == 0:
        raise ValueError(f"no ratings parsed from {path}")
    return RatingsData(
        users=(u - 1).astype(np.int32),
        items=(i - 1).astype(np.int32),
        ratings=r.astype(np.float32),
        n_users=int(u.max()),
        n_items=int(i.max()),
        global_bias=float(np.mean(r, dtype=np.float64)),
    )


def read_array(path: str) -> tuple[np.ndarray, int, int]:
    """Read a 2D float CSV into a row-major float32 array.

    Returns ``(flat_values, n_rows, n_cols)``; ``n_cols`` is the true
    per-row column count (the reference returned the total value count,
    util.cu:64-66).
    """
    rows = []
    n_cols = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            vals = [float(x) for x in line.split(",")]
            n_cols = len(vals)
            rows.append(vals)
    arr = np.asarray(rows, dtype=np.float32)
    return arr.reshape(-1), len(rows), n_cols


def load_matrix(path: str) -> np.ndarray:
    """Read a component CSV as a 2D float32 array."""
    flat, n_rows, n_cols = read_array(path)
    return flat.reshape(n_rows, n_cols)


def write_csv(path: str, data: np.ndarray, rows: int, cols: int) -> None:
    """Row-major float dump with 6 decimals (reference util.cu:86-97)."""
    data = np.asarray(data, dtype=np.float32).reshape(rows, cols)
    with open(path, "w") as f:
        for row in data:
            f.write(",".join(f"{v:f}" for v in row))
            f.write("\n")


def component_path(parent_dir: str, base: str, component: str,
                   factors: int, extension: str = "csv") -> str:
    """``{dir}/{base}_f{factors}_{component}.{ext}`` (util.cu:99-103)."""
    return os.path.join(parent_dir,
                        f"{base}_f{factors}_{component}.{extension}")


def write_component(parent_dir: str, base: str, component: str,
                    data: np.ndarray, rows: int, cols: int,
                    factors: int, extension: str = "csv") -> str:
    path = component_path(parent_dir, base, component, factors, extension)
    write_csv(path, data, rows, cols)
    return path
