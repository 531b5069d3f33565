"""Device-memory roofline of the SGD step's access pattern, on the card.

    python -m cu2rec_torch.experiments.gather_roofline [--out FILE]

The port of the repository's ``experiments/gather_roofline.py``.  The twin
step (``ops/packed.py``) is dominated by random ROW gathers from the packed
tables, whose ceiling is memory transactions rather than streamed bytes.
It measures, with CUDA events:

  1. the library row gather ``table[idx]`` against the row width W in
     {32, 64, 128, 256, 512} floats: if rows/s is flat in W for short rows,
     the gather is transaction-bound;
  2. the streaming ceiling: one read and one write of a dense table;
  3. kernel K2 (``ops/cuda_gather.row_gather``, one bulk copy per row, 16 in
     flight per block) at W = 128, checked exact against ``table[idx]``;

then prints the twin step's floor at ML-20M shapes (U = 138,000 users,
I = 27,000 items, W = 128) from the rates it measured.  One JSON line per
measurement; a file only with ``--out``.
"""

from __future__ import annotations

import argparse

import torch

from cu2rec_torch.experiments.common import Records, time_ms
from cu2rec_torch.ops.cuda_gather import row_gather
from cu2rec_torch.utils.device import resolve_device

WIDTHS = (32, 64, 128, 256, 512)
N_SETS = 4  # index sets rotated through the timed calls


def _index_sets(rows: int, draws: int, gen: torch.Generator, dev,
                dtype=torch.int64):
    base = torch.randint(0, rows, (draws,), generator=gen)
    return [((base + k) % rows).to(dev, dtype) for k in range(N_SETS)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, default=131072, help="table rows")
    p.add_argument("--draws", type=int, default=131072,
                   help="gathered rows per call")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="append the records here")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")  # a probe measures the card only
    rec = Records(args.out)
    gen = torch.Generator().manual_seed(args.seed)
    rows, draws = args.rows, args.draws

    # 1. library random row gather against width
    idx = _index_sets(rows, draws, gen, dev)
    for W in WIDTHS:
        table = torch.randn((rows, W), generator=gen).to(dev)
        ms = time_ms(lambda i: table[i], [(i,) for i in idx], args.reps)
        rec.emit(kind="library_gather", width=W, rows=rows, draws=draws,
                 rows_per_s=draws / ms * 1e3,
                 useful_gb_s=draws * W * 4 / ms / 1e6, ms=ms)
        del table

    # 2. streaming ceiling: one read + one write of the widest table
    table = torch.randn((rows, 512), generator=gen).to(dev)
    buf = torch.empty_like(table)
    ms = time_ms(lambda: torch.mul(table, 1.0001, out=buf), [()], args.reps)
    n_bytes = 2 * table.numel() * 4
    rec.emit(kind="stream", bytes=n_bytes, gb_s=n_bytes / ms / 1e6, ms=ms)
    del table, buf

    # 3. K2, one bulk copy per row, at W = 128
    W = 128
    table = torch.randn((rows, W), generator=gen).to(dev)
    idx32 = [i.to(torch.int32) for i in idx]
    got = row_gather(table, idx32[0])
    if not torch.equal(got, table[idx[0]]):
        raise AssertionError("K2 row_gather differs from table[idx]")
    ms = time_ms(row_gather, [(table, i) for i in idx32], args.reps)
    rec.emit(kind="k2_row_gather", width=W, rows=rows, draws=draws,
             rows_per_s=draws / ms * 1e3,
             useful_gb_s=draws * W * 4 / ms / 1e6, ms=ms, exact=True)

    # The twin step's floor at ML-20M shapes from the measured rates.  The
    # user pass streams T_u in order; the U sampled-item draws hit a
    # 14 MB table (heavy reuse); only the I sampled-user draws are random
    # over a large table.  So the floor is a range: optimistic counts the
    # reuse-heavy draws as one streaming pass of the item table,
    # pessimistic charges each draw a random row transaction.
    g = next(r["rows_per_s"] for r in rec.records
             if r["kind"] == "library_gather" and r["width"] == 128)
    s = next(r["gb_s"] for r in rec.records if r["kind"] == "stream") * 1e9
    U, I, row_b = 138_000, 27_000, 128 * 4
    t_tables = 2 * (U + I) * row_b * 2 / s
    t_rand = I / g
    rec.emit(kind="twin_step_floor_ml20m", stream_ms=t_tables * 1e3,
             rand_gather_ms=t_rand * 1e3,
             floor_lo_ms=(t_tables + t_rand + I * row_b / s) * 1e3,
             floor_hi_ms=(t_tables + t_rand + U / g) * 1e3)
    rec.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
