"""``mf_cpu`` — sequential CPU baseline trainer (reference
mf_sequential.cu parity; built as ``bin/mf_cpu`` by makefile:7-9).

    python -m cu2rec_torch.cli.mf_cpu -c config train.csv test.csv
"""

from __future__ import annotations

import argparse
import os
import time

from cu2rec_torch.data.csr import build_csr
from cu2rec_torch.data.ratings import read_ratings_csv, write_component
from cu2rec_torch.train.reference import sequential_train
from cu2rec_torch.utils.config import Config


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mf_cpu", description=__doc__)
    p.add_argument("-c", "--config", default=None)
    p.add_argument("train_csv")
    p.add_argument("test_csv")
    args = p.parse_args(argv)

    train_rd = read_ratings_csv(args.train_csv)
    train_csr = build_csr(train_rd)
    test_rd = read_ratings_csv(args.test_csv)
    test_csr = build_csr(test_rd)

    cfg = Config()
    if args.config:
        cfg.read_config(args.config)
    cfg.print_config()

    start = time.perf_counter()
    comps, _losses = sequential_train(train_csr, test_csr, cfg,
                                      train_rd.global_bias)
    elapsed = time.perf_counter() - start
    print(f"Time taken for {cfg.total_iterations} of iterations is "
          f"{elapsed:f}")

    outdir = os.path.dirname(args.train_csv) or "."
    base = os.path.splitext(os.path.basename(args.train_csv))[0]
    F = cfg.n_factors
    U, I = train_csr.n_users, train_csr.n_items
    write_component(outdir, base, "p", comps["p"], U, F, F)
    write_component(outdir, base, "q", comps["q"], I, F, F)
    write_component(outdir, base, "user_bias", comps["user_bias"], U, 1, F)
    write_component(outdir, base, "item_bias", comps["item_bias"], I, 1, F)
    write_component(outdir, base, "global_bias", comps["global_bias"], 1, 1, F)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
