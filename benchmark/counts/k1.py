"""K1, the ridge solve (``cu2rec_torch/csrc/ridge_cholesky.cu``): the bytes
and operations one ALS half sweep's solves need.

Per system of n unknowns: the Gram's lower triangle and the right-hand
side read once, the solution written once (floats); a Cholesky
factorisation (n³/3) and the two triangular solves (2n²)."""


def half_sweep_bytes(n: int, systems: int) -> int:
    return 4 * systems * (n * (n + 1) // 2 + 2 * n)


def half_sweep_ops(n: int, systems: int) -> int:
    return systems * (n ** 3 // 3 + 2 * n * n)
