"""``predict`` — fold in a new user and print ranked recommendations
(reference predict.cu parity).

    python -m cu2rec_torch.cli.predict -c cfg -i item_bias.csv \\
        -g global_bias.csv -q q.csv user_ratings.csv

Same flow as predict.cu:72-133: load trained Q/item_bias/global_bias, read
the user's ratings (any user ids are remapped to user 0, predict.cu:119-122),
partial-fit only the P row and user bias (``is_train=false``: frozen item
tables; K0a on the card), score the whole catalog, filter already-rated
items, print ranked recommendations.  ``--implicit`` folds in with the exact
iALS ridge solve instead (K1 on the card).  It runs on the CUDA device
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cu2rec_torch.data.ratings import read_ratings_csv
from cu2rec_torch.serve.foldin import fold_in_user
from cu2rec_torch.serve.recommend import predict_all_items, ranked_items
from cu2rec_torch.utils.checkpoint import load_item_components
from cu2rec_torch.utils.config import Config
from cu2rec_torch.utils.device import resolve_device


def build_parser():
    p = argparse.ArgumentParser(prog="predict", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-i", "--item-bias", required=True)
    p.add_argument("-g", "--global-bias", required=True)
    p.add_argument("-q", "--q-matrix", required=True)
    p.add_argument("user_ratings_csv")
    p.add_argument("-k", "--top-k", type=int, default=0,
                   help="print only the top K recommendations (0 = all)")
    p.add_argument("--implicit", action="store_true",
                   help="iALS-exported model: fold in with the exact "
                        "one-shot ridge solve (ratings act as confidence "
                        "strengths) instead of SGD iterations")
    p.add_argument("--alpha", type=float, default=40.0,
                   help="implicit confidence slope c = 1 + alpha*r")
    p.add_argument("--reg", type=float, default=None,
                   help="implicit ridge lambda (default: config P_reg)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to fold in on (default: cuda; no fall-back)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    cfg = Config()
    cfg.read_config(args.config)
    cfg.is_train = False

    Q, item_bias, global_bias = load_item_components(
        args.q_matrix, args.item_bias, args.global_bias)

    user_rd = read_ratings_csv(args.user_ratings_csv)
    rated = user_rd.items
    ratings = user_rd.ratings

    if args.implicit:
        # Exact one-shot implicit partial fit (ops/ials.ials_fold_in):
        # no iterations or lr; biases play no role in the implicit score.
        from cu2rec_torch.ops.ials import ials_fold_in
        Qd = torch.from_numpy(np.asarray(Q, np.float32)).to(device)
        x = ials_fold_in(
            Qd, np.asarray(rated, np.int32)[None, :],
            np.asarray(ratings, np.float32)[None, :],
            np.ones((1, len(rated)), bool), args.alpha,
            args.reg if args.reg is not None else cfg.P_reg)[0]
        scores = (Qd @ x).cpu().numpy()
    else:
        model, _losses = fold_in_user(Q, item_bias, global_bias, rated,
                                      ratings, cfg, device=device)
        scores = predict_all_items(
            model.P[0], model.user_bias[0], model.Q, model.item_bias,
            model.global_bias).cpu().numpy()

    # Print predictions (predict.cu:31-38 format).
    print("Predictions: ")
    print("[" + "".join(f"{s:g}, " for s in scores) + "]")

    rated_set = set(int(i) for i in rated)
    recs = [(s, i) for s, i in ranked_items(scores) if i not in rated_set]
    if args.top_k:
        recs = recs[:args.top_k]
    print("Recommendations:")
    for rank, (score, item) in enumerate(recs, 1):
        print(f"Rank: {rank}\tItem: {item}\tEstimated rating: {score:f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
