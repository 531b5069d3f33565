"""Sort a ratings CSV by (userId, itemId)
(reference preprocessing/sort_ratings.py CLI)."""

from __future__ import annotations

import argparse
import os

from cu2rec_torch.data.sort import sort_ratings_file


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("file_ratings")
    p.add_argument("-o", "--output", default=None)
    args = p.parse_args(argv)
    out = args.output
    if out is None:
        fp, ext = os.path.splitext(args.file_ratings)
        out = f"{fp}_sorted{ext}"
    sort_ratings_file(args.file_ratings, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
