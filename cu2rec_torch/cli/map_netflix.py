"""Map Netflix-prize files to the mapped ratings format
(reference preprocessing/map_netflix.py CLI)."""

from __future__ import annotations

import argparse
import os

from cu2rec_torch.data.netflix import process_netflix


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("train_file")
    p.add_argument("test_file", nargs="?", default=None)
    p.add_argument("--delimiter", default=" ")
    args = p.parse_args(argv)

    def out(path):
        fp, ext = os.path.splitext(path)
        return f"{fp}_mapped{ext}"

    process_netflix(args.train_file, out(args.train_file),
                    args.test_file, out(args.test_file) if args.test_file
                    else None, delimiter=args.delimiter)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
