"""One-command real-dataset fetch + prepare: download, checksum, extract,
id-map, split — the full preprocessing journey the reference ran by hand
(README.md:31-39 + preprocessing/*.py) for its benchmark grid's dataset
axis (experiments/cu2rec.sh:8-10).

    python -m cu2rec_torch.cli.get_data ml20m  --outdir data/ml20m
    python -m cu2rec_torch.cli.get_data ml100k --outdir data/ml100k
    python -m cu2rec_torch.cli.get_data ml20m --archive ml-20m.zip  # offline

Produces ``ratings_mapped{,_train,_test}.csv`` ready for ``cli/mf``.
In a network-less environment pass ``--archive`` with a pre-downloaded
zip (the checksum is still verified).  ``--dry-run`` stops after
resolving the plan (used by tests and for air-gapped sanity checks).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import zipfile

DATASETS = {
    "ml20m": {
        "url": "https://files.grouplens.org/datasets/movielens/ml-20m.zip",
        "md5": "cd245b17a1ae2cc31bb14903e1204af3",
        "member": "ml-20m/ratings.csv",
        "delim": ",",
        "header": True,
    },
    # "latest-small" — the checked-in sample dataset's source.  NOTE:
    # GroupLens documents the "latest" datasets as periodically
    # regenerated, so the pinned md5 tracks a SNAPSHOT; a fresh download
    # after upstream regenerates will fail the checksum (use --no-checksum
    # or re-pin).  "ml100k" is kept as an alias because the repo's
    # data/ml100k_* sample came from this snapshot.
    "ml-latest-small": {
        "url": ("https://files.grouplens.org/datasets/movielens/"
                "ml-latest-small.zip"),
        "md5": "0e33842e24a9c977be4e0107933c0723",
        "member": "ml-latest-small/ratings.csv",
        "delim": ",",
        "header": True,
    },
    # The STABLE classic ML-100K archive (tab-separated u.data, no
    # header).  GroupLens does not publish a checksum we can pin offline;
    # verify with --md5 if you have one.
    "ml100k-classic": {
        "url": "https://files.grouplens.org/datasets/movielens/ml-100k.zip",
        "md5": None,
        "member": "ml-100k/u.data",
        "delim": "\t",
        "header": False,
    },
    "ml25m": {
        "url": "https://files.grouplens.org/datasets/movielens/ml-25m.zip",
        "md5": "6b51fb2759a8657d3bfcbfc42b592ada",
        "member": "ml-25m/ratings.csv",
        "delim": ",",
        "header": True,
    },
}


def _md5(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _download(url: str, dest: str) -> None:
    import urllib.request
    print(f"downloading {url} -> {dest}", flush=True)
    with urllib.request.urlopen(url) as r, open(dest, "wb") as f:
        while True:
            b = r.read(1 << 20)
            if not b:
                break
            f.write(b)


def _strip_timestamp(src: str, dest: str, header: bool,
                     delim: str = ",") -> None:
    """MovieLens rating files are ``user<delim>item<delim>rating<delim>
    timestamp``; the mapper wants 3 comma-separated columns.  Stream-strip
    the 4th (and normalize the delimiter)."""
    with open(src) as fin, open(dest, "w") as fout:
        if header:
            next(fin)
        fout.write("userId,itemId,rating\n")
        for line in fin:
            parts = line.rstrip("\n").split(delim)
            if len(parts) >= 3:
                fout.write(",".join(parts[:3]) + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Download + checksum + map + split a real dataset")
    p.add_argument("dataset",
                   choices=sorted(DATASETS) + ["ml100k"],
                   help="'ml100k' is an alias for 'ml-latest-small' "
                        "(the checked-in sample's source snapshot); "
                        "'ml100k-classic' is the stable ml-100k.zip")
    p.add_argument("--md5", default=None,
                   help="override/provide the expected archive md5 "
                        "(required to verify datasets with no pinned "
                        "checksum, e.g. ml100k-classic)")
    p.add_argument("--outdir", default=None,
                   help="output directory (default data/<dataset>)")
    p.add_argument("--archive", default=None,
                   help="pre-downloaded zip (skips the download; "
                        "checksum still verified unless --no-checksum)")
    p.add_argument("--no-checksum", action="store_true")
    p.add_argument("--test-fraction", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dry-run", action="store_true",
                   help="print the resolved plan and exit 0")
    args = p.parse_args(argv)

    name = "ml-latest-small" if args.dataset == "ml100k" else args.dataset
    spec = dict(DATASETS[name])
    if args.md5:
        spec["md5"] = args.md5
    outdir = args.outdir or os.path.join("data", args.dataset)
    archive = args.archive or os.path.join(outdir,
                                           os.path.basename(spec["url"]))
    plan = {
        "dataset": args.dataset,
        "url": spec["url"],
        "md5": spec["md5"],
        "archive": archive,
        "member": spec["member"],
        "outdir": outdir,
        "outputs": [os.path.join(outdir, f"ratings_mapped{s}.csv")
                    for s in ("", "_train", "_test")],
    }
    if args.dry_run:
        import json
        print(json.dumps(plan, indent=2))
        return 0

    os.makedirs(outdir, exist_ok=True)
    if not os.path.exists(archive):
        try:
            _download(spec["url"], archive)
        except OSError as e:
            print(f"download failed ({e}); in a network-less environment "
                  f"pass --archive with a pre-downloaded "
                  f"{os.path.basename(spec['url'])}", file=sys.stderr)
            return 1
    if not args.no_checksum:
        if spec["md5"] is None:
            # Refuse to silently process an unverified archive: datasets
            # with no pinned checksum need an explicit decision from the
            # user (provide the expected md5, or opt out loudly).
            print(f"error: no pinned checksum for {name}; pass --md5 "
                  f"<expected> to verify, or --no-checksum to skip "
                  f"verification explicitly", file=sys.stderr)
            return 1
        else:
            got = _md5(archive)
            if got != spec["md5"]:
                print(f"checksum mismatch for {archive}: got {got}, want "
                      f"{spec['md5']}", file=sys.stderr)
                return 1
            print(f"checksum ok ({got})", flush=True)

    raw = os.path.join(outdir, "ratings_raw.csv")
    with zipfile.ZipFile(archive) as z, z.open(spec["member"]) as src, \
            open(raw, "wb") as dst:
        while True:
            b = src.read(1 << 20)
            if not b:
                break
            dst.write(b)
    print(f"extracted {spec['member']} -> {raw}", flush=True)

    three_col = os.path.join(outdir, "ratings_3col.csv")
    _strip_timestamp(raw, three_col, spec["header"], spec["delim"])

    from cu2rec_torch.data.mapping import process_file
    mapped = os.path.join(outdir, "ratings_mapped.csv")
    process_file(three_col, mapped)
    print(f"mapped -> {mapped}", flush=True)

    from cu2rec_torch.cli.split import main as split_main
    rc = split_main([mapped, str(args.test_fraction), "-s",
                     str(args.seed)])
    if rc:
        return rc
    base, ext = os.path.splitext(mapped)
    print(f"split -> {base}_train{ext} / {base}_test{ext}", flush=True)
    for tmp in (raw, three_col):
        os.unlink(tmp)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
