"""ctypes bindings of the native host library (``csrc/ingest.cpp``): the
multithreaded ratings-CSV parser and writers, the component-matrix CSV
reader and writer, the id factorizer, and the counting-sort user sort and
CSR build.

The library builds with the host C++ compiler at first use, into the build
directory (``csrc/build.py::build_host``), never next to its source.  The
NumPy paths of the callers run only when asked for — ``use_native=False``
or the environment switch ``CU2REC_NO_NATIVE=1`` — or where no host
compiler exists, which is said once on stderr.  A build or a load that
fails raises, with the compiler's output: a broken build never quietly
puts the slow path back.

``CALLS`` counts the calls into the library, so that a run can show that
its I/O went through it.
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading

import numpy as np

CALLS = 0

_LOCK = threading.Lock()
_LIB = None
_WARNED = False

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)

# name: (restype, argtypes), the library's C ABI.
_SIGNATURES = {
    "cu2rec_ingest_open": (ctypes.c_void_p,
                           [ctypes.c_char_p, ctypes.c_char, ctypes.c_int]),
    "cu2rec_ingest_count": (ctypes.c_int64, [ctypes.c_void_p]),
    "cu2rec_ingest_copy": (None, [ctypes.c_void_p, _I64P, _I64P, _F32P]),
    "cu2rec_ingest_close": (None, [ctypes.c_void_p]),
    "cu2rec_csr_build": (ctypes.c_int, [_I32P, _I32P, _F32P, ctypes.c_int64,
                                        ctypes.c_int32, _I32P, _I32P,
                                        _F32P]),
    "cu2rec_write_ratings": (ctypes.c_int, [ctypes.c_char_p, _I32P, _I32P,
                                            _F32P, ctypes.c_int64,
                                            ctypes.c_char_p]),
    "cu2rec_write_ratings_mapped": (
        ctypes.c_int, [ctypes.c_char_p, _I64P, _I64P, _I64P,
                       ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_char_p]),
    "cu2rec_factorize": (ctypes.c_int64,
                         [_I64P, ctypes.c_int64, _I64P, _I64P,
                          ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                          _I64P, _I64P, ctypes.c_int64]),
    "cu2rec_sort_ratings_by_user": (
        ctypes.c_int, [_I64P, _I64P, _F32P, ctypes.c_int64, ctypes.c_int64,
                       _I64P, _I64P, _F32P]),
    "cu2rec_write_matrix": (ctypes.c_int, [ctypes.c_char_p, _F32P,
                                           ctypes.c_int64, ctypes.c_int64]),
    "cu2rec_matrix_open": (ctypes.c_void_p, [ctypes.c_char_p]),
    "cu2rec_matrix_rows": (ctypes.c_int64, [ctypes.c_void_p]),
    "cu2rec_matrix_cols": (ctypes.c_int64, [ctypes.c_void_p]),
    "cu2rec_matrix_copy": (None, [ctypes.c_void_p, _F32P]),
    "cu2rec_matrix_close": (None, [ctypes.c_void_p]),
}


class MalformedInput(ValueError):
    """The native reader rejected a file (ragged, malformed or empty); the
    caller hands it to the Python reader for that reader's behaviour."""


def get_lib():
    """The loaded library, or None when the native path is switched off
    (``CU2REC_NO_NATIVE``) or no host compiler exists.  Builds it at first
    use; a failed build or load raises."""
    global _LIB, _WARNED
    if os.environ.get("CU2REC_NO_NATIVE"):
        return None
    with _LOCK:
        if _LIB is not None:
            return _LIB
        from cu2rec_torch.csrc import build
        if build.gxx() is None:
            if not _WARNED:
                print("cu2rec_torch: no host C++ compiler (g++) found; the "
                      "CSV ingest and export run in NumPy", file=sys.stderr)
                _WARNED = True
            return None
        # RTLD_LOCAL: another library in the process (such as the TPU
        # package's copy) may export the same symbol names.
        lib = ctypes.CDLL(str(build.build_host("ingest")),
                          mode=os.RTLD_LOCAL)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _LIB = lib
        return _LIB


def available() -> bool:
    """Whether the callers take the native path (see :func:`get_lib`)."""
    return get_lib() is not None


def _lib():
    global CALLS
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native ingest is switched off "
                           "(CU2REC_NO_NATIVE) or has no host compiler")
    CALLS += 1
    return lib


def native_read_ratings(path: str, delim: int, skip_lines: int):
    """Parse a ratings file natively → (users int64, items int64, ratings
    float32) raw arrays.  An empty file gives empty arrays; a missing one
    raises ``FileNotFoundError``."""
    lib = _lib()
    if os.stat(path).st_size == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.float32))
    handle = lib.cu2rec_ingest_open(os.fsencode(path), delim, skip_lines)
    if not handle:
        raise OSError(f"native ingest failed to read {path}")
    try:
        n = lib.cu2rec_ingest_count(handle)
        users = np.empty(n, dtype=np.int64)
        items = np.empty(n, dtype=np.int64)
        ratings = np.empty(n, dtype=np.float32)
        if n:
            lib.cu2rec_ingest_copy(handle, users.ctypes.data_as(_I64P),
                                   items.ctypes.data_as(_I64P),
                                   ratings.ctypes.data_as(_F32P))
    finally:
        lib.cu2rec_ingest_close(handle)
    return users, items, ratings


def native_write_ratings(path: str, users: np.ndarray, items: np.ndarray,
                         ratings: np.ndarray,
                         header: str = "userId,itemId,rating") -> None:
    """Parallel ratings-CSV writer: 0-based arrays → 1-based file with
    ``%d,%d,%.3f`` rows (the write_to_file contract of the reference's
    map_items.py:80-89)."""
    lib = _lib()
    n = users.shape[0]
    users = np.ascontiguousarray(users, dtype=np.int32)
    items = np.ascontiguousarray(items, dtype=np.int32)
    ratings = np.ascontiguousarray(ratings, dtype=np.float32)
    if not (items.shape[0] == ratings.shape[0] == n):
        raise ValueError("users, items and ratings differ in length")
    rc = lib.cu2rec_write_ratings(
        os.fsencode(path), users.ctypes.data_as(_I32P),
        items.ctypes.data_as(_I32P), ratings.ctypes.data_as(_F32P), n,
        header.encode() if header else b"")
    if rc != 0:
        raise OSError(f"native_write_ratings failed for {path}")


def native_write_ratings_mapped(path: str, users: np.ndarray,
                                items: np.ndarray, vidx: np.ndarray,
                                table: list[str],
                                header: str = "userId,itemId,rating") -> None:
    """Parallel mapped-ratings writer: ids written as given (1-based mapped
    ids), each rating as the entry ``vidx`` picks from a table of
    preformatted strings — the byte-exact path of the id mapper."""
    lib = _lib()
    n = users.shape[0]
    users = np.ascontiguousarray(users, dtype=np.int64)
    items = np.ascontiguousarray(items, dtype=np.int64)
    vidx = np.ascontiguousarray(vidx, dtype=np.int64)
    if not (items.shape[0] == vidx.shape[0] == n):
        raise ValueError("users, items and vidx differ in length")
    tarr = np.asarray([t.encode() for t in table], dtype="S")
    rc = lib.cu2rec_write_ratings_mapped(
        os.fsencode(path), users.ctypes.data_as(_I64P),
        items.ctypes.data_as(_I64P), vidx.ctypes.data_as(_I64P),
        tarr.ctypes.data_as(ctypes.c_char_p), tarr.dtype.itemsize,
        len(table), n, header.encode() if header else b"")
    if rc != 0:
        raise OSError(f"native_write_ratings_mapped failed for {path}")


def native_factorize(ids: np.ndarray, mapping: dict, add_missing: bool):
    """Single-pass hash factorization with the reference's first-appearance
    rule (map_items.py:40-54): returns ``codes`` (int64 mapped values, 0
    where unknown and not added) and adds new ids to ``mapping`` like the
    reference's dict.  Raises ``ValueError`` for the id INT64_MIN (the
    hash table's empty key)."""
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    lib = _lib()
    n = ids.shape[0]
    nk = len(mapping)
    ex_keys = np.fromiter(mapping.keys(), np.int64, nk)
    ex_vals = np.fromiter(mapping.values(), np.int64, nk)
    codes = np.empty(n, dtype=np.int64)
    new_keys = np.empty(n if add_missing else 0, dtype=np.int64)
    n_new = lib.cu2rec_factorize(
        ids.ctypes.data_as(_I64P), n, ex_keys.ctypes.data_as(_I64P),
        ex_vals.ctypes.data_as(_I64P), nk, nk + 1, 1 if add_missing else 0,
        codes.ctypes.data_as(_I64P), new_keys.ctypes.data_as(_I64P),
        new_keys.shape[0])
    if n_new < 0:
        raise ValueError("native_factorize failed (an id is INT64_MIN)")
    if n_new:
        mapping.update(zip(new_keys[:n_new].tolist(),
                           range(nk + 1, nk + 1 + int(n_new))))
    return codes


def native_sort_by_user(users: np.ndarray, items: np.ndarray,
                        ratings: np.ndarray, n_users: int):
    """Stable counting sort of (users, items, ratings) by 1-based mapped
    user id in one parallel scatter pass.  Raises ``ValueError`` for a user
    id outside [1, n_users]."""
    lib = _lib()
    n = users.shape[0]
    users = np.ascontiguousarray(users, dtype=np.int64)
    items = np.ascontiguousarray(items, dtype=np.int64)
    ratings = np.ascontiguousarray(ratings, dtype=np.float32)
    out_u = np.empty(n, dtype=np.int64)
    out_i = np.empty(n, dtype=np.int64)
    out_r = np.empty(n, dtype=np.float32)
    rc = lib.cu2rec_sort_ratings_by_user(
        users.ctypes.data_as(_I64P), items.ctypes.data_as(_I64P),
        ratings.ctypes.data_as(_F32P), n, n_users,
        out_u.ctypes.data_as(_I64P), out_i.ctypes.data_as(_I64P),
        out_r.ctypes.data_as(_F32P))
    if rc != 0:
        raise ValueError("user id out of range in native_sort_by_user")
    return out_u, out_i, out_r


def native_write_matrix(path: str, data: np.ndarray, rows: int,
                        cols: int) -> None:
    """Parallel component-matrix CSV writer: one row a line, ``%f`` values
    (reference writeCSV, util.cu:86-97), the bytes of the Python writer."""
    lib = _lib()
    data = np.ascontiguousarray(data, dtype=np.float32).reshape(rows, cols)
    rc = lib.cu2rec_write_matrix(os.fsencode(path), data.ctypes.data_as(
        _F32P), rows, cols)
    if rc != 0:
        raise OSError(f"native_write_matrix failed for {path}")


def native_read_matrix(path: str) -> tuple[np.ndarray, int, int]:
    """Parallel component-matrix CSV reader → ``(flat, n_rows, n_cols)``,
    values decoded by strtof (correctly rounded: the bits of Python's
    ``float()`` for float32).  Raises :class:`MalformedInput` for a
    ragged, malformed or empty file."""
    lib = _lib()
    handle = lib.cu2rec_matrix_open(os.fsencode(path))
    if not handle:
        raise MalformedInput(f"native matrix read failed for {path}")
    try:
        rows = lib.cu2rec_matrix_rows(handle)
        cols = lib.cu2rec_matrix_cols(handle)
        flat = np.empty(rows * cols, dtype=np.float32)
        lib.cu2rec_matrix_copy(handle, flat.ctypes.data_as(_F32P))
    finally:
        lib.cu2rec_matrix_close(handle)
    return flat, int(rows), int(cols)


def native_csr_build(users: np.ndarray, items: np.ndarray,
                     ratings: np.ndarray, n_users: int):
    """Parallel counting-sort CSR build → (indptr, items, ratings) sorted by
    (user, item).  Raises ``ValueError`` for a user id outside
    [0, n_users)."""
    lib = _lib()
    n = users.shape[0]
    users = np.ascontiguousarray(users, dtype=np.int32)
    items = np.ascontiguousarray(items, dtype=np.int32)
    ratings = np.ascontiguousarray(ratings, dtype=np.float32)
    indptr = np.empty(n_users + 1, dtype=np.int32)
    out_items = np.empty(n, dtype=np.int32)
    out_ratings = np.empty(n, dtype=np.float32)
    rc = lib.cu2rec_csr_build(
        users.ctypes.data_as(_I32P), items.ctypes.data_as(_I32P),
        ratings.ctypes.data_as(_F32P), n, n_users,
        indptr.ctypes.data_as(_I32P), out_items.ctypes.data_as(_I32P),
        out_ratings.ctypes.data_as(_F32P))
    if rc != 0:
        raise ValueError("user id out of range in native_csr_build")
    return indptr, out_items, out_ratings
