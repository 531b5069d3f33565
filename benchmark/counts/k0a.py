"""K0a, the SGD step (``cu2rec_torch/csrc/sgd_step.cu``): the bytes and
operations one first_wins step needs.

Bytes: a copy of ``chip_smoke.py::_step_bytes`` (the float32 and bf16
first_wins case): each table read and written once, the user indptr, and
one sampled (item, rating) per user with ratings.  The election buffer is
scratch, not input or output.

Operations: per user with a rating, the prediction's dot product over the
F factors (2F) and the row's update (4F: error times the item row, minus
the regularised row, times the rate, added).  The items' updates, as many
as the step's distinct draws, are left out: their number changes from step
to step, and a count must never exceed what the inputs need.  Float32
work, counted against the operation peak; the bytes bound the step by
three orders of magnitude.
"""


def step_bytes(n_users: int, n_items: int, width: int, users_with: int,
               elem: int = 4) -> int:
    n = 2 * n_users * width * elem + 4 * (n_users + 1) + 8 * users_with
    return n + 2 * n_items * width * elem


def step_ops(n_factors: int, users_with: int) -> int:
    return 6 * n_factors * users_with
