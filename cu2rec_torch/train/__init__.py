"""Training: the SGD host loop and its one-device engine."""

from cu2rec_torch.train.trainer import (  # noqa: F401
    SingleChipEngine, train, train_with_engine,
)
