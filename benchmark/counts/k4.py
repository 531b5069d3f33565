"""K4, the gather-Gram (``cu2rec_torch/csrc/gather_gram.cu``): the bytes
and operations one ALS half sweep's Grams need.

A half sweep builds, for each row with ratings (a system), the Gram of its
design rows [q | 1] (n = F + 1 columns) and its right-hand side.
Operations: two (a multiply-add) a live slot for each entry of the Gram's
lower triangle and of the right-hand side, n(n + 1)/2 + n, as
``experiments/gram_times.py::gram_work`` counts them; padded slots are not
counted.  Bytes: each counterpart row read once (its F factors and its
bias, n floats), each live slot's id and value (8 bytes), and each
system's lower triangle and right-hand side written once, with the
ridge's λ and degree.
"""


def half_sweep_bytes(n: int, systems: int, live: int, distinct: int) -> int:
    return (4 * distinct * n + 8 * live
            + 4 * systems * (n * (n + 1) // 2 + n) + 4 * (n + systems))


def half_sweep_ops(n: int, live: int) -> int:
    return 2 * live * (n * (n + 1) // 2 + n)
