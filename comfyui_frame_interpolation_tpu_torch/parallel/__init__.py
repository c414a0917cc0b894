"""Multi-device inference and the training step (the JAX package's
``parallel/``): a ``(data, space)`` mesh of torch devices, the batch split
over ``data``; the ``space`` axis is kept as policy and not run."""

from .infer import make_sharded_model_fn, make_sharded_pair_fns
from .mesh import (
    MIN_ROWS_PER_SHARD,
    data_sharding,
    frame_sharding,
    make_mesh,
    replicated,
)
from .train import l1_loss, make_train_step

__all__ = [
    "MIN_ROWS_PER_SHARD",
    "data_sharding",
    "frame_sharding",
    "make_mesh",
    "make_sharded_model_fn",
    "make_sharded_pair_fns",
    "replicated",
    "l1_loss",
    "make_train_step",
]
