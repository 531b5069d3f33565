"""Hyperparameter configuration.

Capability parity with the reference config system
(matrix_factorization/config.{h,cu}): the same 13 hyperparameters with the
same defaults (config.h:20-58), the same 9-field space-separated legacy file
format ``cur_iterations total_iterations n_factors learning_rate seed P_reg
Q_reg user_bias_reg item_bias_reg`` (config.cu:7-22), and a ``print_config``
dump (config.cu:50-64).

This is the PyTorch package's own copy of the TPU package's
``utils/config.py`` (the port imports nothing of that package); the fields,
defaults and file formats are identical, so a config written by either
package reads in the other.

Differences from the reference:
  * no CUDA ``__constant__`` memory mirror (config.h:8-18) — the values are
    ordinary Python scalars handed to the torch ops that use them;
  * the four parameters the reference could not serialize
    (``n_threads``/``check_error``/``patience``/``learning_rate_decay``,
    see preprocessing/create_config.py:16-17 TODO) round-trip through an
    extended 13-field format and a JSON format, while the 9-field legacy
    format is still read and written bit-compatibly.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass


@dataclass
class Config:
    """Training configuration. Defaults match reference config.h:20-58."""

    # Current iteration count (supports resume; reference config.h:22-23).
    cur_iterations: int = 0
    # Total iteration count. One "iteration" = one sampled SGD update per
    # user (reference sgd.cu:26-37), NOT an epoch.
    total_iterations: int = 5000
    # Number of latent factors.
    n_factors: int = 50
    # SGD learning rate.
    learning_rate: float = 0.01
    # PRNG seed.
    seed: int = 42
    # Regularization for the user factor matrix P.
    P_reg: float = 0.02
    # Regularization for the item factor matrix Q.
    Q_reg: float = 0.02
    # Regularization for user biases.
    user_bias_reg: float = 0.02
    # Regularization for item biases.
    item_bias_reg: float = 0.02
    # Full training (True) vs partial fit / fold-in (False): when False the
    # item-side tables Q and item_bias are frozen (reference sgd.cu:61,70).
    is_train: bool = True
    # Reference CUDA block size (config.h:41-42). Kept for config-file
    # compatibility and used as a batching hint nowhere hot.
    n_threads: int = 32
    # Evaluate train/test RMSE+MAE every `check_error` iterations
    # (plus the first and last iteration; reference training.cu:118).
    check_error: int = 500
    # Number of eval points validation RMSE may fail to improve before the
    # learning rate is decayed (reference training.cu:100-155; int, matching
    # reference config.h:47).
    patience: int = 2
    # Multiplier applied to the learning rate when patience runs out.
    learning_rate_decay: float = 0.2

    # --- extensions of both packages (no reference counterpart) ---
    # Item-update collision policy: "first_wins" reproduces the reference's
    # Hogwild first-writer-wins semantics deterministically (sgd.cu:47-63);
    # "mean" averages all colliding updates (usually converges faster);
    # "twin" replaces the election entirely — each item samples its own
    # (user, rating) per iteration, making the step scatter-free (the
    # fastest policy in the TPU package).
    collision_policy: str = "first_wins"
    # Compute dtype for factor tables ("float32" or "bfloat16").
    dtype: str = "float32"
    # Training algorithm: "sgd" (the reference's sampled parallel SGD),
    # "als" (alternating least squares; total_iterations = sweeps), or
    # "ials" (implicit-feedback weighted MF, Hu/Koren/Volinsky).
    algo: str = "sgd"
    # If > 0, evaluate the TRAIN-split RMSE/MAE on a random subsample of at
    # most this many ratings (the reference evaluates the full train set
    # every check_error iterations, training.cu:121-123 — exact but
    # expensive at Netflix scale).
    train_eval_sample: int = 0
    # Same, for the TEST split.  Note the plateau LR scheduler keys off the
    # test RMSE, so a subsampled test eval perturbs the decay schedule —
    # use only at 100M-rating scale where full eval dominates step time.
    test_eval_sample: int = 0

    LEGACY_FIELDS = (
        "cur_iterations", "total_iterations", "n_factors", "learning_rate",
        "seed", "P_reg", "Q_reg", "user_bias_reg", "item_bias_reg",
    )
    EXTENDED_FIELDS = LEGACY_FIELDS + (
        "n_threads", "check_error", "patience", "learning_rate_decay",
    )

    def read_config(self, file_path: str) -> bool:
        """Load from a legacy 9-field or extended 13-field space-separated
        file, or a JSON file (detected by leading '{')."""
        with open(file_path) as f:
            text = f.read().strip()
        if text.startswith("{"):
            for k, v in json.loads(text).items():
                if hasattr(self, k):
                    setattr(self, k, v)
            return True
        tokens = text.split()
        fields = (self.EXTENDED_FIELDS if len(tokens) >= len(self.EXTENDED_FIELDS)
                  else self.LEGACY_FIELDS)
        for name, tok in zip(fields, tokens):
            typ = type(getattr(self, name))
            setattr(self, name, typ(float(tok)) if typ is int else typ(tok))
        return True

    def write_config(self, file_path: str, legacy: bool = True) -> bool:
        """Write the space-separated config file. ``legacy=True`` emits the
        reference's exact 9-field format (config.cu:15-22)."""
        fields = self.LEGACY_FIELDS if legacy else self.EXTENDED_FIELDS
        parts = []
        for name in fields:
            v = getattr(self, name)
            parts.append(str(int(v)) if isinstance(v, bool) else str(v))
        with open(file_path, "w") as f:
            f.write(" ".join(parts) + "\n")
        return True

    def write_json(self, file_path: str) -> bool:
        with open(file_path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)
            f.write("\n")
        return True

    def print_config(self) -> None:
        """Stdout dump, same fields as reference config.cu:50-64."""
        print("Hyperparameters:")
        print(f"total_iterations: {self.total_iterations}")
        print(f"n_factors: {self.n_factors}")
        print(f"learning_rate: {self.learning_rate:f}")
        print(f"P_reg: {self.P_reg:f}")
        print(f"Q_reg: {self.Q_reg:f}")
        print(f"user_bias_reg: {self.user_bias_reg:f}")
        print(f"item_bias_reg: {self.item_bias_reg:f}")
        print(f"is_train: {'true' if self.is_train else 'false'}")
        print(f"n_threads: {self.n_threads}")
        print(f"check_error: {self.check_error}")
        print(f"patience: {self.patience:f}")
        print(f"learning_rate_decay: {self.learning_rate_decay:f}")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
