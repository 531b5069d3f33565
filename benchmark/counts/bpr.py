"""BPR-MF (``cu2rec_torch/ops/bpr.py``, plain torch): the bytes and
operations one step and one eval need.

A step, in ``counts/k0a.py``'s convention: each table read and written
once; the CSR arrays the draws read (both indptr arrays whole, one item id
a user with interactions for its positive, one rater an item with raters,
and for each item's uniform user that user's row bounds and one item id).
The draws' ids and the gathered rows are the step's own scratch, not its
inputs or outputs.  Operations: per user with interactions, the
difference of the two item rows (F), its dot with the user's row (2F) and
the row's update (3F: the error times the difference, the regularised
row, the add); per item, the same for each of its two passes (12F).  The
padding columns of the rows are not counted: the inputs do not need them.

An eval: the AUC over its pairs, each pair's three ids (12 bytes) and
the rows of the users and items the pairs touch, read once, with two
scores a pair (2 · (2F + 1) and a compare); the ranking eval's scan, the
catalog's rows and the ranked users' rows read once, each user's train
and test interactions (4 bytes each), k ids a user written, and a score
for every item a user (2F + 1).
"""


def step_bytes(n_users: int, n_items: int, width: int, users_with: int,
               items_with: int, elem: int = 4) -> int:
    tables = 2 * (n_users + n_items) * width * elem
    indptr = 4 * (n_users + 1) + 4 * (n_items + 1)
    draws = 4 * users_with + 4 * items_with + 12 * n_items
    return tables + indptr + draws


def step_ops(n_factors: int, users_with: int, n_items: int) -> int:
    return 6 * n_factors * users_with + 12 * n_factors * n_items


def auc_bytes(pairs: int, users: int, items: int, width: int,
              elem: int = 4) -> int:
    return 12 * pairs + (users + items) * width * elem


def auc_ops(pairs: int, n_factors: int) -> int:
    return pairs * (2 * (2 * n_factors + 1) + 1)


def scan_bytes(rank_users: int, n_items: int, width: int, train_nnz: int,
               test_nnz: int, k: int, elem: int = 4) -> int:
    rows = (rank_users + n_items) * width * elem
    return rows + 4 * (train_nnz + test_nnz) + 4 * k * rank_users


def scan_ops(rank_users: int, n_items: int, n_factors: int) -> int:
    return rank_users * n_items * (2 * n_factors + 1)
