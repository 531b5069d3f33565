"""Training: the SGD host loop and its one-device engine."""

from cu2rec_torch.train.trainer import (
    SingleChipEngine, eval_segments, run_steps, single_step, train,
    train_with_engine,
)

__all__ = ["train", "train_with_engine", "SingleChipEngine", "run_steps",
           "single_step", "eval_segments"]
