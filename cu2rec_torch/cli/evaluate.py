"""``evaluate`` — score an exported model against a ratings file,
standalone.

    python -m cu2rec_torch.cli.evaluate -p p.csv -q q.csv -u user_bias.csv \
        -i item_bias.csv -g global_bias.csv test.csv [--ranking --train
        train.csv -k 10]
    python -m cu2rec_torch.cli.evaluate --checkpoint model.npz test.csv

The reference only reports metrics from inside a training run
(training.cu:135-137); evaluating an already-exported model requires
re-running training.  This CLI closes that: it loads the five component
CSVs (the ``{base}_f{F}_{comp}.csv`` export contract, util.cu:101) or an
``.npz`` checkpoint, computes test RMSE/MAE (loss.cu:40-49 + 150-200
semantics; K0b on the card), and with ``--ranking`` adds recall@k / NDCG@k
over held-out items (train-split items masked).  It runs on the CUDA
device unless ``--device cpu`` is given.  Output: the reference's ``TEST:``
line shape plus one JSON summary line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from cu2rec_torch.data.csr import build_csr, csr_from_arrays, to_device
from cu2rec_torch.data.ratings import load_matrix, read_ratings_csv
from cu2rec_torch.models.state import model_from_numpy
from cu2rec_torch.ops.loss import evaluate
from cu2rec_torch.serve.recommend import ranking_eval
from cu2rec_torch.utils.checkpoint import (
    load_checkpoint, load_item_components,
)
from cu2rec_torch.utils.device import resolve_device


def build_parser():
    p = argparse.ArgumentParser(prog="evaluate", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("ratings_csv", help="ratings file to score (e.g. the "
                   "held-out test split)")
    src = p.add_argument_group("model source (components or checkpoint)")
    src.add_argument("--checkpoint", help=".npz checkpoint (full model)")
    src.add_argument("-p", "--p-matrix")
    src.add_argument("-q", "--q-matrix")
    src.add_argument("-u", "--user-bias")
    src.add_argument("-i", "--item-bias")
    src.add_argument("-g", "--global-bias")
    p.add_argument("--ranking", action="store_true",
                   help="also compute recall@k / NDCG@k (implicit-task "
                        "metrics) over the ratings file's items")
    p.add_argument("--train", help="train ratings CSV — masks "
                   "rated-in-train items from the ranking metrics")
    p.add_argument("-k", "--top-k", type=int, default=10)
    p.add_argument("--max-users", type=int, default=0,
                   help="cap the ranking-eval user sample (0 = all)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to score on (default: cuda; no fall-back)")
    return p


def load_model(args, device):
    """The model from ``--checkpoint`` or from the five component CSVs."""
    if args.checkpoint:
        model, _cfg, _extra = load_checkpoint(args.checkpoint, device=device)
        return model
    need = ("p_matrix", "q_matrix", "user_bias", "item_bias",
            "global_bias")
    missing = [n for n in need if getattr(args, n) is None]
    if missing:
        raise SystemExit(
            "need --checkpoint or all of -p/-q/-u/-i/-g (missing: "
            + ", ".join(missing) + ")")
    Q, item_bias, global_bias = load_item_components(
        args.q_matrix, args.item_bias, args.global_bias)
    return model_from_numpy({
        "p": load_matrix(args.p_matrix), "q": Q,
        "user_bias": load_matrix(args.user_bias).reshape(-1),
        "item_bias": item_bias,
        "global_bias": np.float32(global_bias)}, device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    model = load_model(args, device)
    n_users = int(model.P.shape[0])
    n_items = int(model.Q.shape[0])
    rd = read_ratings_csv(args.ratings_csv)
    if rd.n_users > n_users or rd.n_items > n_items:
        raise SystemExit(
            f"ratings reference user/item ids ({rd.n_users}, {rd.n_items}) "
            f"beyond the model tables ({n_users}, {n_items})")
    csr = build_csr(rd, n_users=n_users, n_items=n_items)
    rmse, mae = evaluate(model, to_device(csr, device))
    # training.cu:135-137 line shape, grep-compatible.
    label = "CPU" if device.type == "cpu" else "GPU"
    print(f"TEST: Iteration 0 {label} MAE: {mae:f} RMSE: {rmse:f}")
    summary = {"event": "eval", "ratings": csr.nnz,
               "test_rmse": rmse, "test_mae": mae}

    if args.ranking:
        if args.train:
            train_csr = build_csr(read_ratings_csv(args.train),
                                  n_users=n_users, n_items=n_items)
        else:
            train_csr = csr_from_arrays(
                np.empty(0, np.int32), np.empty(0, np.int32),
                np.empty(0, np.float32), n_users, n_items)
        k = min(args.top_k, n_items)  # same clamp as the trainers
        m = ranking_eval(model, train_csr, csr, k=k,
                         max_users=args.max_users or None)
        print(f"RANKING: recall@{k} = {m['recall']:.4f}  "
              f"ndcg@{k} = {m['ndcg']:.4f}")
        summary.update(recall_at_k=m["recall"], ndcg_at_k=m["ndcg"], k=k)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
