"""K4, the ALS/iALS gather-Gram, timed against its plain version by chunk
shape, on the card.

    python -m cu2rec_torch.experiments.gram_times [--out FILE]

Random design rows of the headline model (138,000 rows, F = 100, every
slot live) and chunks from a heavy segment's width (162 × 4,096) down to
the narrowest bucket (83,000 × 8), ALS and iALS: K4 with the stream held
(``ops/cuda_gram.py::_launch``, uncounted), the plain version
(``gram_rhs_reference``: the gather and ``torch.bmm`` / ``einsum``), the
bound of the chunk's work (``gram_work``) and K4's float32 rate over the
triangle and rhs it sums.  K4 is checked within 1e-5 of each sum's
|X|ᵀ|X| + 1e-6 of the plain version in float64 first.  One JSON line a
chunk and family; a file only with ``--out``.

``gram_scale`` (the tolerance's scale) and ``gram_work`` (the bound's
bytes and operations) are shared with ``chip_smoke.py`` and the tests.
"""

from __future__ import annotations

import argparse

import torch

from cu2rec_torch.experiments.common import Records, time_ms
from cu2rec_torch.ops import cuda_gram
from cu2rec_torch.utils.device import resolve_device

# (systems, slots a system): a heavy chunk's width down to bucket 8's.
CHUNKS = ((162, 4096), (2_500, 256), (20_000, 64), (40_000, 24),
          (83_000, 8))
PEAK_BYTES_S, PEAK_F32_FLOP_S = 3.35e12, 67e12  # H100 SXM data sheet


def gram_scale(rows, idx, vals, mask, n: int, *, mu=None, alpha=None):
    """The scale of each sum of ``cuda_gram.gram_rhs_reference``: the
    same sums of absolute values (|X|ᵀ|X| and |X|ᵀ|y| for ALS,
    Σ |α r m| |q| |q|ᵀ and Σ |(1 + α r) m| |q| for iALS), against which a
    float32 sum in another order is held."""
    if mu is not None:
        X, y = cuda_gram.design(rows, idx, vals, mask, mu, n)
        X, y = X.abs(), y.abs()
        return torch.bmm(X.mT, X), torch.bmm(X.mT, y[..., None])[..., 0]
    q = cuda_gram._gather(rows, idx, *vals.shape, n).abs()
    m = mask.to(torch.float32)
    w = (alpha * vals * m).abs()
    c = ((1.0 + alpha * vals) * m).abs()
    return (torch.einsum("bdf,bdg->bfg", q * w[..., None], q),
            torch.einsum("bdf,bd->bf", q, c))


def gram_work(n: int, systems: int, slots: int, live: int, distinct: int,
              *, ials: bool, epilogue: bool, ids: bool = True):
    """(bytes, flops) that K4's function needs for a chunk: each distinct
    gathered row read once (``n`` floats, and its bias for ALS), the ids
    (int64, unless read as ``rows`` in order), values and mask of every
    slot, G and rhs written, and the epilogue's ridge (ALS: λ and the
    degrees) or YᵀY (iALS); against two flops (a multiply-add) a live slot
    for each entry of G's lower triangle and of rhs."""
    n_bytes = 4 * distinct * n + slots * (4 + 1 + (8 if ids else 0)) \
        + 4 * systems * (n * n + n)
    if not ials:
        n_bytes += 4 * distinct
    if epilogue:
        n_bytes += 4 * n * n if ials else 4 * (n + systems)
    return n_bytes, 2 * live * (n * (n + 1) // 2 + n)


def _within(got, exact, scale) -> bool:
    return all(bool(((g.double() - e).abs() <= 1e-5 * s + 1e-6).all())
               for g, e, s in zip(got, exact, scale))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, default=138_000)
    p.add_argument("--factors", type=int, default=100)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="append the records here")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")  # a probe measures the card only
    rec = Records(args.out)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    R, F = args.rows, args.factors
    # Design rows [q | 1 | b | 0…], the last row zero (als.design_table).
    rows = torch.zeros((R + 1, -(-(F + 2) // 4) * 4), device=dev)
    rows[:R, :F] = torch.randn((R, F), generator=gen, device=dev) * 0.1
    rows[:R, F] = 1.0
    rows[:R, F + 1] = torch.randn(R, generator=gen, device=dev) * 0.1
    mu = torch.tensor(3.5, device=dev)
    for B, D in CHUNKS:
        idx = torch.randint(0, R, (B, D), generator=gen, device=dev)
        vals = torch.rand((B, D), generator=gen, device=dev) * 5
        mask = torch.ones((B, D), dtype=torch.bool, device=dev)
        for family, table, n, mode in (
                ("als", rows, F + 1, dict(mu=mu)),
                ("ials", rows[:R, :F], F, dict(alpha=2.0))):
            args_ = (table, idx, vals, mask, n)
            got = cuda_gram._launch(*args_, **mode)
            exact = cuda_gram.gram_rhs_reference(
                table.double(), idx, vals.double(), mask, n,
                **{k: v.double() if torch.is_tensor(v) else v
                   for k, v in mode.items()})
            if not _within(got, exact, gram_scale(*args_,
                                                            **mode)):
                raise AssertionError(f"K4 {family} at {B} x {D} is not "
                                     "within 1e-5 of |X|ᵀ|X| of float64")
            del got, exact
            ms = time_ms(lambda: cuda_gram._launch(*args_, **mode), [()],
                         args.reps, hold=True)
            plain_ms = time_ms(
                lambda: cuda_gram.gram_rhs_reference(*args_, **mode), [()],
                max(1, args.reps // 2))
            distinct = int(torch.unique(idx).numel())
            n_bytes, flops = gram_work(
                n, B, B * D, B * D, distinct, ials=family == "ials",
                epilogue=False)
            bound_ms = max(n_bytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S) \
                * 1e3
            rec.emit(kind="gather_gram", family=family, systems=B, slots=D,
                     n=n, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     tflop_s=flops / ms / 1e9, bytes=n_bytes, flops=flops)
            torch.cuda.empty_cache()
    rec.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
