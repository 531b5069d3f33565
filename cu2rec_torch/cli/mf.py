"""``mf`` — train a matrix-factorization model (reference mf.cu parity).

Usage matches the reference binary (README.md:31):

    python -m cu2rec_torch.cli.mf -c path/to/config train.csv test.csv

plus the TPU package's extensions: ``--jsonl`` metrics stream,
``--checkpoint`` / ``--resume`` (mid-run resume), ``--collision`` policy,
and the other training families, ``--algo als|ials|bpr`` (``--solver``,
``--alpha``).  It trains on the CUDA device unless ``--device cpu`` is
given.  ``--dtype bfloat16`` trains bf16 tables (float32 arithmetic);
``--collision mean`` (and ``sum`` through a JSON config) adds colliding
item updates together, in a fixed order.  ``--devices N > 1`` trains on N
ranks of a dp grid (``parallel/``), each a process this command starts:
with ``--device cuda`` N NCCL ranks, one card each (it raises where the
host has fewer cards), with ``--device cpu`` N gloo ranks.  Rank 0 prints,
exports the CSVs and writes the checkpoint.

Output contract preserved: the five component CSVs are written next to the
train file as ``{base}_f{factors}_{p,q,user_bias,item_bias,global_bias}.csv``
(mf.cu:63-87).
"""

from __future__ import annotations

import argparse
import os
import sys

from cu2rec_torch.data.csr import build_csr
from cu2rec_torch.data.ratings import read_ratings_csv
from cu2rec_torch.ops.als import SOLVERS
from cu2rec_torch.train.trainer import train
from cu2rec_torch.utils.checkpoint import (
    export_components, load_checkpoint, save_checkpoint,
)
from cu2rec_torch.utils.config import Config
from cu2rec_torch.utils.device import print_free_memory, resolve_device
from cu2rec_torch.utils.metrics import MetricsLogger


def build_parser():
    p = argparse.ArgumentParser(prog="mf", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("-c", "--config", default=None, help="config file "
                   "(legacy 9-field, extended 13-field, or JSON)")
    p.add_argument("train_csv")
    p.add_argument("test_csv")
    p.add_argument("--jsonl", default=None, help="append metrics JSONL here")
    p.add_argument("--checkpoint", default=None,
                   help="write a resumable .npz checkpoint here at the end")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="also checkpoint every N eval points")
    p.add_argument("--resume", default=None,
                   help="resume from a .npz checkpoint")
    p.add_argument("--devices", type=int, default=0,
                   help="shard over this many devices, a rank each "
                   "(0 or 1 = one device)")
    p.add_argument("--collision", choices=["first_wins", "mean", "twin"],
                   default=None,
                   help="item-update policy: first_wins = deterministic "
                        "Hogwild parity; mean = average colliding updates; "
                        "twin = per-item sampling")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None)
    p.add_argument("--algo", choices=["sgd", "als", "ials", "bpr"],
                   default=None,
                   help="training algorithm (als/ials: total_iterations = "
                        "number of sweeps; ials = implicit-feedback "
                        "weighted MF and bpr = pairwise ranking, both "
                        "evaluated by recall@10)")
    p.add_argument("--solver", choices=SOLVERS, default="auto",
                   help="ridge solver for als/ials sweeps (every name runs "
                        "the same kernel here)")
    p.add_argument("--alpha", type=float, default=40.0,
                   help="iALS confidence slope (c = 1 + alpha*r)")
    p.add_argument("--outdir", default=None,
                   help="component output dir (default: next to train csv)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to train on (default: cuda; no fall-back)")
    return p


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.devices > 1:
        return _launch_ranks(args, argv)
    return _train(args, None)


def _launch_ranks(args, argv) -> int:
    """``--devices N``: N ranks of this command, NCCL on N cards or gloo on
    the CPU."""
    import torch

    from cu2rec_torch.parallel.distributed import launch

    n = args.devices
    device = resolve_device(args.device)
    if device.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(
            f"--devices {n} trains on {n} CUDA devices, one a rank, and "
            f"this host has {torch.cuda.device_count()}")
    launch(_rank_main, n, "gloo" if device.type == "cpu" else "nccl",
           device.type, args=(argv,))
    return 0


def _rank_main(argv) -> int:
    from cu2rec_torch.parallel.sharded import make_mesh

    args = build_parser().parse_args(argv)
    return _train(args, make_mesh(args.devices, 1))


def _train(args, mesh) -> int:
    """Train as ``args`` say, on one device (``mesh`` None) or as one rank
    of ``mesh``."""
    lead = mesh is None or mesh.rank == 0
    device = mesh.device if mesh is not None else resolve_device(args.device)
    say = print if lead else (lambda *a, **k: None)

    # Free-memory probe at startup (mf.cu:33-37).
    if lead:
        print_free_memory(device)

    # Both CSRs share dimensions (max over the two files): evaluation
    # indexes the model tables by user/item id.
    train_rd = read_ratings_csv(args.train_csv)
    test_rd = read_ratings_csv(args.test_csv)
    n_users = max(train_rd.n_users, test_rd.n_users)
    n_items = max(train_rd.n_items, test_rd.n_items)
    train_csr = build_csr(train_rd, n_users=n_users, n_items=n_items)
    test_csr = build_csr(test_rd, n_users=n_users, n_items=n_items)

    model = None
    if args.resume:
        model, cfg, _extra = load_checkpoint(args.resume, device=device)
        say(f"Resuming from {args.resume} at iteration {cfg.cur_iterations}")
    else:
        cfg = Config()
    if args.config:
        # The config file overrides the checkpoint's hyperparameters, but a
        # resumed cur_iterations survives unless the file sets it.
        cur = cfg.cur_iterations
        cfg.read_config(args.config)
        if args.resume and cfg.cur_iterations == 0:
            cfg.cur_iterations = cur
    if args.collision:
        cfg.collision_policy = args.collision
    if args.dtype:
        cfg.dtype = args.dtype
    if args.algo:
        cfg.algo = args.algo
    if lead:
        cfg.print_config()

    logger = MetricsLogger(jsonl_path=args.jsonl if lead else None,
                           verbose=lead,
                           label="CPU" if device.type == "cpu" else "GPU")
    if cfg.algo == "bpr":
        from cu2rec_torch.train.bpr import train_bpr
        model, _losses = train_bpr(train_csr, test_csr, cfg, model=model,
                                   logger=logger, mesh=mesh, device=device)
    elif cfg.algo == "ials":
        from cu2rec_torch.train.ials import train_ials
        model, _losses = train_ials(train_csr, test_csr, cfg,
                                    alpha=args.alpha, model=model,
                                    logger=logger, mesh=mesh,
                                    solver=args.solver, device=device)
    elif cfg.algo == "als":
        from cu2rec_torch.train.als import train_als
        model, _losses = train_als(train_csr, test_csr, cfg,
                                   train_rd.global_bias, model=model,
                                   logger=logger, mesh=mesh,
                                   solver=args.solver, device=device)
    else:
        engine = None
        if mesh is not None:
            from cu2rec_torch.parallel.sharded import ShardedEngine
            engine = ShardedEngine(train_csr, test_csr, cfg, mesh=mesh)
        model, _losses = train(train_csr, test_csr, cfg,
                               train_rd.global_bias, model=model,
                               logger=logger, engine=engine,
                               checkpoint_path=args.checkpoint,
                               checkpoint_every=args.checkpoint_every,
                               device=device)

    # Component export next to the train file (mf.cu:63-87).
    if lead:
        outdir = args.outdir or (os.path.dirname(args.train_csv) or ".")
        os.makedirs(outdir, exist_ok=True)
        base = os.path.splitext(os.path.basename(args.train_csv))[0]
        for p in export_components(model, outdir, base, cfg.n_factors):
            print(f"Wrote {p}")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, model, cfg)
        say(f"Wrote checkpoint {args.checkpoint}")
    logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
