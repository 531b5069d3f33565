"""``synth`` — generate a planted-model synthetic ratings CSV.

    python -m cu2rec_torch.cli.synth raw.csv --preset ml20m --seed 0

No-network stand-in for the reference benchmark grid's real datasets
(reference experiments/cu2rec.sh:8-10); see ``data/synth.py`` for
the planted-model construction and its exact quality floor.  Presets:

    --preset ml20m     138,000 users × 27,000 items × 20M ratings
    --preset netflix   480,189 users × 17,770 items × 100.48M ratings

Writes the raw CSV plus a ``<out>.meta.json`` with the noise floor.
"""

from __future__ import annotations

import argparse
import json
import time

PRESETS = {
    "ml100k": dict(users=610, items=9_724, ratings=100_836),
    "ml20m": dict(users=138_000, items=27_000, ratings=20_000_000),
    "netflix": dict(users=480_189, items=17_770, ratings=100_480_507),
}


def build_parser():
    p = argparse.ArgumentParser(prog="synth", description=__doc__)
    p.add_argument("out_csv")
    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    # Defaults are None so an explicit flag can override a preset
    # (preset supplies whatever the user did not pin down).
    p.add_argument("--users", type=int, default=None)
    p.add_argument("--items", type=int, default=None)
    p.add_argument("--ratings", type=int, default=None)
    p.add_argument("--factors", type=int, default=20,
                   help="planted latent rank")
    p.add_argument("--noise", type=float, default=0.30,
                   help="rating noise std == Bayes test RMSE")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--clip", action="store_true",
                   help="censor ratings to [1, 5] (floor becomes inexact)")
    p.add_argument("--implicit", action="store_true",
                   help="implicit-feedback variant: observations drawn "
                        "from a per-user softmax over the planted affinity "
                        "(ranking signal for BPR/iALS); ratings all 1.0, "
                        "meta records the oracle AUC ceiling")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from cu2rec_torch.data.synth import (
        generate_planted, generate_planted_implicit, write_planted_csv)

    dims = dict(users=10_000, items=2_000, ratings=1_000_000)
    if args.preset:
        dims = dict(PRESETS[args.preset])
    for k in dims:
        if getattr(args, k) is not None:
            dims[k] = getattr(args, k)
    t0 = time.perf_counter()
    oracle_auc = None
    if args.implicit:
        data, oracle_auc = generate_planted_implicit(
            dims["users"], dims["items"], dims["ratings"],
            n_factors=args.factors, seed=args.seed)
    else:
        data = generate_planted(dims["users"], dims["items"],
                                dims["ratings"],
                                n_factors=args.factors, noise=args.noise,
                                seed=args.seed,
                                clip=(1.0, 5.0) if args.clip else None)
    t1 = time.perf_counter()
    # The implicit generator dedupes repeated (u, i) draws, so the actual
    # count can be below the requested one — record what was written.
    dims["ratings"] = int(len(data.users))
    write_planted_csv(data, args.out_csv)
    t2 = time.perf_counter()
    meta = dict(noise_floor=data.noise_floor, mu=data.mu,
                planted_factors=args.factors, seed=args.seed, **dims)
    if oracle_auc is not None:
        meta["oracle_auc"] = oracle_auc
    with open(args.out_csv + ".meta.json", "w") as f:
        json.dump(meta, f, indent=2)
        f.write("\n")
    print(f"Generated {dims['ratings']} ratings "
          f"({dims['users']}x{dims['items']}, planted F={args.factors}, "
          + (f"oracle AUC={oracle_auc:.4f}" if oracle_auc is not None
             else f"floor RMSE={data.noise_floor}")
          + f") in {t1 - t0:.1f}s, wrote {args.out_csv} in {t2 - t1:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
