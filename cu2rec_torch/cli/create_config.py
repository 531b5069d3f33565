"""Generate a config file (reference preprocessing/create_config.py CLI).

Unlike the reference (which could not serialize n_threads/check_error/
patience/learning_rate_decay — create_config.py:16-17 TODO), ``--extended``
writes the 13-field format and ``--json`` writes JSON with every field.
"""

from __future__ import annotations

import argparse

from cu2rec_torch.utils.config import Config


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Creates a config file")
    d = Config()
    p.add_argument("output")
    p.add_argument("--cur_iterations", type=int, default=d.cur_iterations)
    p.add_argument("--total_iterations", type=int, default=d.total_iterations)
    p.add_argument("--n_factors", type=int, default=d.n_factors)
    p.add_argument("--learning_rate", type=float, default=d.learning_rate)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--P_reg", type=float, default=d.P_reg)
    p.add_argument("--Q_reg", type=float, default=d.Q_reg)
    p.add_argument("--user_bias_reg", type=float, default=d.user_bias_reg)
    p.add_argument("--item_bias_reg", type=float, default=d.item_bias_reg)
    p.add_argument("--n_threads", type=int, default=d.n_threads)
    p.add_argument("--check_error", type=int, default=d.check_error)
    p.add_argument("--patience", type=float, default=d.patience)
    p.add_argument("--learning_rate_decay", type=float,
                   default=d.learning_rate_decay)
    p.add_argument("--extended", action="store_true",
                   help="write the 13-field extended format")
    p.add_argument("--json", action="store_true", help="write JSON")
    args = p.parse_args(argv)

    cfg = Config(**{k: getattr(args, k) for k in (
        "cur_iterations", "total_iterations", "n_factors", "learning_rate",
        "seed", "P_reg", "Q_reg", "user_bias_reg", "item_bias_reg",
        "n_threads", "check_error", "patience", "learning_rate_decay")})
    if args.json:
        cfg.write_json(args.output)
    else:
        cfg.write_config(args.output, legacy=not args.extended)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
