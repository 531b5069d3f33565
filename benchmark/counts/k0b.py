"""K0b, the eval sums (``cu2rec_torch/csrc/eval_error.cu``): the bytes and
operations one eval over a ratings set needs.

Bytes: each rating's user id, item id and value (12 bytes), and the rows of
both tables that the set touches, each read once.  Operations: per rating
the prediction's dot product over F factors and its bias adds (2F + 3),
the error and its square and absolute value into the sums (4)."""


def eval_bytes(nnz: int, users: int, items: int, width: int,
               elem: int = 4) -> int:
    return 12 * nnz + (users + items) * width * elem


def eval_ops(nnz: int, n_factors: int) -> int:
    return nnz * (2 * n_factors + 7)
