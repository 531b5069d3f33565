"""Can a table held on-chip beat the library's random row gather?

    python -m cu2rec_torch.experiments.vmem_gather_probe [--out FILE]

The port of the repository's ``experiments/vmem_gather_probe.py``.  The
tables the SGD step gathers from are small (the packed item table is 14 MB
at ML-20M scale), so the TPU probe kept the whole table in on-chip memory
and copied rows from there.  On this card the on-chip memory a block can
hold is 227 KB of shared memory.  For each table size of the sweep (W = 128
floats a row) it measures, with CUDA events:

  * the library gather ``table[idx]`` with random and with sorted indices;
  * kernel K3 (``ops/cuda_gather.smem_gather``: the table staged in each
    SM's shared memory), checked exact against ``table[idx]``.

A table that does not fit in a block's shared memory is recorded with an
``error`` field: the wrapper refuses it before launch.  One JSON line per
measurement; a file only with ``--out``.
"""

from __future__ import annotations

import argparse

import torch

from cu2rec_torch.experiments.common import Records, time_ms
from cu2rec_torch.ops.cuda_gather import TableTooLarge, smem_gather
from cu2rec_torch.utils.device import resolve_device

# Tables that fit in shared memory at W = 128, then the TPU probe's
# Netflix- and ML-20M-sized catalogs.
SIZES = (64, 128, 256, 448, 17_792, 27_008)
W = 128


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--draws", type=int, default=1 << 20)
    p.add_argument("--reps", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="append the records here")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")  # a probe measures the card only
    rec = Records(args.out)
    gen = torch.Generator().manual_seed(args.seed)
    M = args.draws
    for I in SIZES:
        table = torch.randn((I, W), generator=gen).to(dev)
        idx = torch.randint(0, I, (M,), generator=gen).to(dev)
        ms = time_ms(lambda i: table[i], [(idx,)], args.reps)
        rec.emit(kind="library_gather_random", rows=I, draws=M,
                 rows_per_s=M / ms * 1e3, ms=ms)
        sidx = torch.sort(idx).values
        ms = time_ms(lambda i: table[i], [(sidx,)], args.reps)
        rec.emit(kind="library_gather_sorted", rows=I, draws=M,
                 rows_per_s=M / ms * 1e3, ms=ms)
        idx32 = idx.to(torch.int32)
        try:
            got = smem_gather(table, idx32)
        except TableTooLarge as e:  # refused before launch
            rec.emit(kind="k3_smem_gather", rows=I, draws=M, error=str(e))
            continue
        if not torch.equal(got, table[idx]):
            raise AssertionError(f"K3 smem_gather differs from table[idx] "
                                 f"at I={I}")
        ms = time_ms(smem_gather, [(table, idx32)], args.reps)
        rec.emit(kind="k3_smem_gather", rows=I, draws=M,
                 rows_per_s=M / ms * 1e3, ms=ms, exact=True)
    rec.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
