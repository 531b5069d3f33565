"""Split a ratings CSV into train/test sets
(reference preprocessing/split_to_test_train.py CLI)."""

from __future__ import annotations

import argparse
import os

import numpy as np

from cu2rec_torch.data import native
from cu2rec_torch.data.ratings import read_ratings_csv, write_ratings_csv
from cu2rec_torch.data.split import read_rating_rows, split_per_user, split_true
from cu2rec_torch.data.synth import split_arrays

# Files above this size take the fast split unless --fast says otherwise.
FAST_BYTES = (2 << 20) * 16


def fast_split(ratings_path: str, train_path: str, test_path: str,
               train_percent: float, seed: int) -> None:
    """``split_arrays`` on the parsed arrays, each side written by the
    native writer (``np.savetxt`` with the same ``%d,%d,%.3f`` rows where
    the native path is off)."""
    rd = read_ratings_csv(ratings_path)
    sides = split_arrays(rd.users, rd.items, rd.ratings, train_percent,
                         seed=seed)
    for path, (users, items, ratings) in zip((train_path, test_path),
                                             sides):
        if native.available():
            native.native_write_ratings(path, users, items, ratings)
            continue
        with open(path, "w") as f:
            f.write("userId,itemId,rating\n")
            np.savetxt(f, np.column_stack([users + 1, items + 1, ratings]),
                       fmt="%d,%d,%.3f")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Splits a csv file into training and test sets")
    p.add_argument("file_ratings")
    p.add_argument("test_ratio", type=float)
    p.add_argument("-s", "--seed", type=int, default=42)
    p.add_argument("--per-user", action="store_true",
                   help="stratify the split per user")
    p.add_argument("--fast", action="store_true", default=None,
                   help="vectorized numpy split + native parallel writer "
                        "(auto above 32 MiB); same seeded-global-shuffle "
                        "protocol, different permutation stream")
    args = p.parse_args(argv)

    filepath, extension = os.path.splitext(args.file_ratings)
    fast = args.fast
    if fast is None and not args.per_user:
        fast = os.path.getsize(args.file_ratings) > FAST_BYTES
    if fast and not args.per_user:
        fast_split(args.file_ratings, f"{filepath}_train{extension}",
                   f"{filepath}_test{extension}", 1 - args.test_ratio,
                   args.seed)
        return 0

    rows = read_rating_rows(args.file_ratings)
    splitter = split_per_user if args.per_user else split_true
    train, test = splitter(rows, 1 - args.test_ratio, seed=args.seed)

    write_ratings_csv(f"{filepath}_train{extension}", train)
    write_ratings_csv(f"{filepath}_test{extension}", test)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
