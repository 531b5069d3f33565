"""Id mapping: arbitrary user/item ids → sequential 1-based ints.

Capability parity with reference preprocessing/map_items.py — the same
assignment rule (ids numbered from 1 in first-appearance order,
map_items.py:40-54), the same drop-unknown mode for test sets
(``add_missing=False``, map_items.py:43-53, with the reference's skip
messages), the same sort-by-user and ``userId,itemId,rating`` header output
(map_items.py:64-89) — vectorized end to end: the native mmap parser, the
native hash factorizer and counting sort, and the native writer, so a
100M-row Netflix raw file maps in seconds.

Pipeline: ``parse_raw_ratings`` → ``assign_sequential`` per id column →
stable sort by user → ``write_mapped_csv`` (a table of the distinct
ratings, each formatted once as its shortest round-trip float32 string,
which reproduces the reference's ``str(float(r))`` bytes for any rating
decimal the float32 parse preserves).  Each step has a NumPy twin that
gives the same arrays and bytes; it runs when the native path is off
(``data/native.py``).
"""

from __future__ import annotations

import numpy as np

from cu2rec_torch.data import native

_INT64_MIN = np.iinfo(np.int64).min


def parse_raw_ratings(filename: str, delimiter: str = ",",
                      has_header: bool = True):
    """Parse ``user<delim>item<delim>rating[<delim>ignored...]`` rows →
    (users int64, items int64, ratings) raw id arrays (no 0-basing, no
    max-id bookkeeping — this feeds the mapper, not the CSR builder).

    The native parser reads the first three fields and ignores the rest of
    each line, so 4-column raw MovieLens files work.
    """
    skip = 1 if has_header else 0
    if native.available():
        return native.native_read_ratings(filename, ord(delimiter), skip)
    from cu2rec_torch.data.ratings import _read_numpy
    # genfromtxt splits on any whitespace when the delimiter is None — the
    # space-delimited Netflix layout.
    d = None if delimiter.isspace() else delimiter
    return _read_numpy(filename, d, skip)


def _assign_numpy(ids: np.ndarray, mapping: dict, add_missing: bool):
    mapped = np.zeros(ids.shape[0], np.int64)
    if mapping:
        ks = np.fromiter(mapping.keys(), np.int64, len(mapping))
        vs = np.fromiter(mapping.values(), np.int64, len(mapping))
        order = np.argsort(ks)
        ks, vs = ks[order], vs[order]
        pos = np.minimum(np.searchsorted(ks, ids), len(ks) - 1)
        known = ks[pos] == ids
        mapped[known] = vs[pos[known]]
    else:
        known = np.zeros(ids.shape[0], bool)
    if add_missing:
        unk_idx = np.flatnonzero(~known)
        if unk_idx.size:
            sub = ids[unk_idx]
            uniq, first = np.unique(sub, return_index=True)
            appearance = np.argsort(first, kind="stable")
            base = len(mapping)
            # value for uniq[j] = base + 1 + rank of its first appearance
            vals_by_uniq = np.empty(uniq.shape[0], np.int64)
            vals_by_uniq[appearance] = base + 1 + np.arange(uniq.shape[0])
            mapping.update(zip(uniq[appearance].tolist(),
                               range(base + 1, base + 1 + uniq.shape[0])))
            mapped[unk_idx] = vals_by_uniq[np.searchsorted(uniq, sub)]
            known = np.ones(ids.shape[0], bool)
    return mapped, known


def assign_sequential(ids, mapping: dict, add_missing: bool = True):
    """Vectorized reference assignment rule (map_items.py:40-54).

    Known ids map through ``mapping``; unknown ids are either appended to
    it in first-appearance order starting at ``len(mapping)+1``
    (``add_missing``) or left flagged unknown.  Returns
    ``(mapped int64 — 0 where unknown, known bool mask)``; ``mapping`` is
    mutated in place like the reference's dicts.  The id INT64_MIN (the
    native hash table's empty key) takes the NumPy path.
    """
    ids = np.asarray(ids, np.int64)
    if native.available() and not (_INT64_MIN in ids or
                                   _INT64_MIN in mapping):
        codes = native.native_factorize(ids, mapping, add_missing)
        return codes, codes != 0
    return _assign_numpy(ids, mapping, add_missing)


def map_file(filename: str, user_mapping: dict, item_mapping: dict,
             delimiter: str = ",", has_header: bool = True,
             add_missing: bool = True):
    """Parse + map one ratings file → (users, items, ratings) arrays with
    1-based mapped ids, in file order.

    With ``add_missing=False`` unknown-user rows are dropped before the
    item check (so items seen only on dropped rows don't count as missing)
    and the reference's skip messages are printed (map_items.py:43-58).
    """
    u_raw, i_raw, ratings = parse_raw_ratings(filename, delimiter,
                                              has_header)
    mu, u_known = assign_sequential(u_raw, user_mapping, add_missing)
    if add_missing:
        mi, _ = assign_sequential(i_raw, item_mapping, True)
        return mu, mi, np.asarray(ratings)
    missing_users = int((~u_known).sum())
    keep = np.flatnonzero(u_known)
    mi_sub, i_known = assign_sequential(i_raw[keep], item_mapping, False)
    missing_items = int((~i_known).sum())
    if missing_users:
        print(f"Skipped {missing_users} rows because of missing users")
    if missing_items:
        print(f"Skipped {missing_items} rows because of missing items")
    idx = keep[i_known]
    return mu[idx], mi_sub[i_known], np.asarray(ratings)[idx]


def map_arrays(users: np.ndarray, items: np.ndarray,
               user_mapping: dict | None = None,
               item_mapping: dict | None = None):
    """Array-input variant: first-appearance order, 1-based (the same
    assignment rule as ``map_file``)."""
    user_mapping = {} if user_mapping is None else user_mapping
    item_mapping = {} if item_mapping is None else item_mapping
    mapped_u, _ = assign_sequential(users, user_mapping, True)
    mapped_i, _ = assign_sequential(items, item_mapping, True)
    return mapped_u, mapped_i, user_mapping, item_mapping


def sort_by_user(users, items, ratings):
    """Stable sort by mapped user id, preserving within-user file order
    (reference map_items.py:65-77 built the same ordering with a dict of
    per-user lists): the native counting-sort scatter for float32 ratings
    and ids ≥ 1, else a NumPy stable argsort."""
    users = np.asarray(users, np.int64)
    items = np.asarray(items, np.int64)
    ratings = np.asarray(ratings)
    if (users.shape[0] and ratings.dtype == np.float32
            and users.min() >= 1 and native.available()):
        return native.native_sort_by_user(users, items, ratings,
                                          int(users.max()))
    order = np.argsort(users, kind="stable")
    return users[order], items[order], ratings[order]


def _rating_table(ratings: np.ndarray):
    """(distinct values, the index of each rating among them).  For float32
    ratings the native factorizer hashes the bit patterns in one O(n) pass
    (bit-equal values are equal floats); np.unique sorts the column."""
    if ratings.dtype == np.float32 and native.available():
        vocab: dict = {}
        inv = native.native_factorize(
            ratings.view(np.int32).astype(np.int64), vocab, True) - 1
        uniq = (np.fromiter(vocab.keys(), np.int64, len(vocab))
                .astype(np.int32).view(np.float32))
        return uniq, inv
    uniq = np.unique(ratings)
    return uniq, np.searchsorted(uniq, ratings)


def write_mapped_csv(path: str, users, items, ratings) -> None:
    """Write mapped rows with the reference header/format contract
    (map_items.py:80-89): ``userId,itemId,rating``, ids as ints, each
    rating formatted like Python's ``str(float(r))``.

    The per-row float formatting collapses to a table of the distinct
    values (real rating vocabularies are tiny) that the native writer
    indexes; the Python writer gives the same bytes.

    Formatting caveats vs the reference (both limited to rating
    vocabularies no real dataset uses): ratings pass through float32, so a
    vocabulary with more than 7 significant digits loses precision; and
    the positional formatter never switches to scientific notation, where
    the reference's ``str(float(r))`` does for |r| < 1e-4 or ≥ 1e16.
    """
    users = np.asarray(users, np.int64)
    items = np.asarray(items, np.int64)
    ratings = np.asarray(ratings)
    if users.shape[0] == 0:
        with open(path, "w", newline="") as f:
            f.write("userId,itemId,rating\n")
        return
    uniq, inv = _rating_table(ratings)
    if uniq.dtype == np.float32:
        # Shortest round-trip float32 repr: str(float(np.float32(3.7)))
        # would print the 17-digit float32 artefact instead of "3.7".
        table = [np.format_float_positional(v, unique=True, min_digits=1)
                 for v in uniq]
    else:
        table = [str(float(v)) for v in uniq.tolist()]
    if native.available():
        native.native_write_ratings_mapped(path, users, items, inv, table)
        return
    from cu2rec_torch.data.ratings import write_ratings_csv
    tbl = np.asarray(table, dtype=object)
    write_ratings_csv(path, zip(users.tolist(), items.tolist(),
                                tbl[inv].tolist()))


def process_file(filename_in: str, filename_out: str) -> None:
    """The map_items.py CLI journey: map, sort by user, write."""
    user_mapping: dict = {}
    item_mapping: dict = {}
    mu, mi, r = map_file(filename_in, user_mapping, item_mapping)
    write_mapped_csv(filename_out, *sort_by_user(mu, mi, r))
