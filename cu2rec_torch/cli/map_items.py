"""Map user/item ids to sequential 1-based ints
(reference preprocessing/map_items.py CLI)."""

from __future__ import annotations

import argparse
import os

from cu2rec_torch.data.mapping import process_file


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Maps user and item ids to sequential ids, starting from 1")
    p.add_argument("file_ratings")
    args = p.parse_args(argv)
    filepath, extension = os.path.splitext(args.file_ratings)
    process_file(args.file_ratings, f"{filepath}_mapped{extension}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
