"""``serve`` — warm-pool serving daemon on one GPU, or over an item-sharded
catalog on several (``--devices N``).

The reference serves one user per process launch (predict.cu:72-133); this
CLI loads the model and uploads the catalog ONCE, then answers JSONL
requests (stdin or a unix socket) with cross-request micro-batching — see
``cu2rec_torch.serve.daemon``.

Two model sources:

    # full checkpoint (recommend-known + fold-in)
    python -m cu2rec_torch.cli.serve --checkpoint run.npz --train train.csv

    # item components only, predict.cu-style (fold-in only)
    python -m cu2rec_torch.cli.serve -c cfg -q q.csv -i item_bias.csv \\
        -g global_bias.csv

It runs on the CUDA devices unless ``--device cpu`` is given.  The
catalog is cut into one item shard a device, in one process: with
``--device cuda`` on every card of the host, or with ``--devices N`` on
``cuda:0 … cuda:N-1`` (it raises on a host of fewer cards); with
``--device cpu`` one shard on the CPU, or N shards there.  Request/
response protocol is documented in ``serve/daemon.py``; try:

    echo '{"id": 1, "op": "fold_in", "items": [3, 7],
           "ratings": [5.0, 3.0], "k": 5}' | \\
        python -m cu2rec_torch.cli.serve --checkpoint m.npz
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(prog="serve", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    src = p.add_argument_group("model source")
    src.add_argument("--checkpoint", help=".npz checkpoint (full model)")
    src.add_argument("-q", "--q-matrix", help="Q factor CSV (predict.cu mode)")
    src.add_argument("-i", "--item-bias", help="item bias CSV")
    src.add_argument("-g", "--global-bias", help="global bias CSV")
    p.add_argument("-c", "--config", help="config file (fold-in hyperparams)")
    p.add_argument("--train", help="train ratings CSV — enables known-user "
                   "recommends with rated-item filtering")
    p.add_argument("--socket", help="unix socket path (default: stdio)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to serve on (default: cuda; no fall-back)")
    p.add_argument("--devices", type=int, default=0,
                   help="item-shard the catalog over N devices: cuda:0 … "
                   "cuda:N-1, or N shards on the CPU with --device cpu "
                   "(0 = all: every CUDA device, or the one CPU device)")
    p.add_argument("-k", "--top-k", type=int, default=10)
    p.add_argument("--max-batch", type=int, default=512)
    p.add_argument("--window-ms", type=float, default=4.0)
    p.add_argument("--completion-workers", type=int, default=4,
                   help="parallel result-fetch threads (each dispatched "
                   "group's materialization waits for the device; a pool "
                   "overlaps them)")
    p.add_argument("--warm-batch", type=int, default=0,
                   help="run the padded-signature ladder up to this batch "
                   "size before taking traffic (0 = lazily)")
    p.add_argument("--warm-width", type=int, default=32,
                   help="max fold-in rated-list width to warm")
    p.add_argument("--warm-ks", default="",
                   help="comma-separated top-k values to warm "
                   "(default: just --top-k)")
    return p


def load_model(args, device):
    """Build the MFModel on ``device`` from either source (checkpoint
    wins); returns (model, checkpoint config or None)."""
    import torch

    from cu2rec_torch.models.state import MFModel
    from cu2rec_torch.utils.checkpoint import (load_checkpoint,
                                               load_item_components)

    if args.checkpoint:
        model, ckpt_cfg, _ = load_checkpoint(args.checkpoint, device=device)
        return model, ckpt_cfg
    if not (args.q_matrix and args.item_bias and args.global_bias):
        raise SystemExit("need --checkpoint or all of -q/-i/-g")
    Q, item_bias, global_bias = load_item_components(
        args.q_matrix, args.item_bias, args.global_bias)
    F = int(np.shape(Q)[1])
    model = MFModel(
        P=torch.zeros((0, F)),                    # no known users
        Q=torch.from_numpy(np.asarray(Q, np.float32)),
        user_bias=torch.zeros((0,)),
        item_bias=torch.from_numpy(np.asarray(item_bias, np.float32)),
        global_bias=torch.tensor(global_bias, dtype=torch.float32),
    )
    return model.to(device), None


def shard_devices(device, n: int) -> list:
    """The devices of ``n`` item shards: ``cuda:0 … cuda:n-1`` (raising,
    with both counts, on a host of fewer cards) or ``n`` times the CPU;
    ``device`` itself for one shard.  ``n`` 0 means every device, as in
    the TPU package's ``serve``: every CUDA device of the host, or the
    one CPU device."""
    import torch

    if n == 0 and device.type == "cuda":
        n = torch.cuda.device_count()
    if n <= 1:
        return [device]
    if device.type == "cpu":
        return [device] * n
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(
            f"--devices {n} shards the catalog over {n} CUDA devices, and "
            f"this host has {have}")
    return [torch.device("cuda", s) for s in range(n)]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from cu2rec_torch.serve.daemon import ServingDaemon, run_socket, run_stdio
    from cu2rec_torch.serve.engine import ShardedServingEngine
    from cu2rec_torch.utils.config import Config
    from cu2rec_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    devices = shard_devices(device, args.devices)
    cfg = Config()
    if args.config:
        cfg.read_config(args.config)
    cfg.is_train = False  # fold-in freezes the catalog (predict.cu:105)

    model, ckpt_cfg = load_model(args, device)
    if ckpt_cfg is not None and not args.config:
        cfg = ckpt_cfg.replace(is_train=False)

    train_csr = None
    if args.train:
        from cu2rec_torch.data import build_csr, read_ratings_csv
        rd = read_ratings_csv(args.train)
        train_csr = build_csr(rd, n_users=max(rd.n_users, model.n_users),
                              n_items=max(rd.n_items, model.n_items))

    engine = ShardedServingEngine(model, devices=devices)
    daemon = ServingDaemon(engine, train_csr=train_csr, cfg=cfg,
                           max_batch=args.max_batch,
                           window_ms=args.window_ms,
                           default_k=args.top_k,
                           completion_workers=args.completion_workers)
    print(f"model: {model.n_users} users x {model.n_items} items, "
          f"F={model.n_factors}, {engine.n_ip} item shard(s) on "
          f"{', '.join(str(d) for d in engine.devices)}",
          file=sys.stderr, flush=True)
    if args.warm_batch:
        ks = tuple(int(x) for x in args.warm_ks.split(",") if x.strip())
        n = daemon.warm(max_batch=args.warm_batch,
                        max_width=args.warm_width,
                        ks=ks or (args.top_k,))
        print(f"warm: {n} signatures run", file=sys.stderr, flush=True)
    if args.socket:
        return run_socket(daemon, args.socket)
    return run_stdio(daemon, sys.stdin, sys.stdout)


if __name__ == "__main__":
    raise SystemExit(main())
