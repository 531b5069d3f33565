"""Structured metrics logging.

The reference's observability is raw printf (training.cu:135-137, 154,
176-177) captured to text files by the experiment harness (cu2rec.sh:16).
The same stdout lines (so grep-based tooling ports over), plus a JSONL
stream with per-eval records, as in the TPU package.  The device word in
the lines (``label``) is the reference's ``GPU`` by default; the trainer
passes ``CPU`` when it runs on the CPU.
"""

from __future__ import annotations

import json
import sys
import time


class MetricsLogger:
    def __init__(self, jsonl_path: str | None = None, verbose: bool = True,
                 label: str = "GPU"):
        self.jsonl_path = jsonl_path
        self.verbose = verbose
        self.label = label
        self._fh = open(jsonl_path, "a") if jsonl_path else None
        self.history: list[dict] = []

    def _emit(self, record: dict) -> None:
        record = {"ts": time.time(), **record}
        self.history.append(record)
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()

    def log_eval(self, iteration: int, *, train_mae: float, train_rmse: float,
                 test_mae: float, test_rmse: float,
                 learning_rate: float, updates_per_s: float | None = None,
                 extras: dict | None = None) -> None:
        """``extras`` merges additional metric columns into the JSONL
        record (e.g. the implicit trainers' auc/recall_at_k/ndcg_at_k);
        the reference-format stdout lines are unchanged."""
        if self.verbose:
            # Same line shape as reference training.cu:135-137.
            print(f"TRAIN: Iteration {iteration} {self.label} "
                  f"MAE: {train_mae:f} RMSE: {train_rmse:f}")
            print(f"TEST: Iteration {iteration} {self.label} "
                  f"MAE: {test_mae:f} RMSE: {test_rmse:f}")
            sys.stdout.flush()
        rec = {"event": "eval", "iteration": iteration,
               "train_mae": train_mae, "train_rmse": train_rmse,
               "test_mae": test_mae, "test_rmse": test_rmse,
               "learning_rate": learning_rate,
               "updates_per_s": updates_per_s}
        if extras:
            rec.update(extras)
        self._emit(rec)

    def log_eval_implicit(self, iteration: int, *, algo: str, auc: float,
                          recall_at_k: float, ndcg_at_k: float, k: int,
                          objective: float | None = None,
                          learning_rate: float = 0.0,
                          updates_per_s: float | None = None,
                          line_prefix: str | None = None,
                          extras: dict | None = None) -> None:
        """Implicit-task eval record with first-class ranking columns —
        no aliasing into the rating-task mae/rmse schema (the r3 scheme
        of packing ``1-auc``/``1-recall`` into test_mae/test_rmse is
        gone).  ``objective`` is the minimized scalar that plateau /
        convergence logic keys off; it defaults to ``1 - recall@k``, the
        value the trainers also return in their ``losses`` dict.  Schema
        documented in docs/API.md §metrics.  ``extras`` merges further
        columns into the JSONL record, as in ``log_eval``."""
        if objective is None:
            objective = 1.0 - recall_at_k
        if self.verbose:
            prefix = line_prefix or f"{algo.upper()} iteration"
            print(f"{prefix} {iteration}: AUC = {auc:.4f}  "
                  f"recall@{k} = {recall_at_k:.4f}  "
                  f"ndcg@{k} = {ndcg_at_k:.4f}")
            sys.stdout.flush()
        self._emit({"event": "eval", "task": "implicit", "algo": algo,
                    "iteration": iteration, "objective": float(objective),
                    "auc": float(auc), "recall_at_k": float(recall_at_k),
                    "ndcg_at_k": float(ndcg_at_k), "k": int(k),
                    "learning_rate": learning_rate,
                    "updates_per_s": updates_per_s, **(extras or {})})

    def log_lr_decay(self, new_lr: float) -> None:
        if self.verbose:
            # training.cu:154
            print(f"New Learning Rate: {new_lr:f}")
        self._emit({"event": "lr_decay", "learning_rate": new_lr})

    def log_time(self, iterations: int, seconds: float) -> None:
        if self.verbose:
            # training.cu:176-177
            print(f"Time taken for {iterations} of iterations is {seconds:f}")
        self._emit({"event": "time", "iterations": iterations,
                    "seconds": seconds,
                    "updates_per_s": None})

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
