"""CSV float matrices → .npy (reference preprocessing/convert_to_np.py CLI)."""

from __future__ import annotations

import argparse

from cu2rec_torch.data.convert import save_as_npy


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("csv_files", nargs="+")
    args = p.parse_args(argv)
    for path in args.csv_files:
        print(save_as_npy(path))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
