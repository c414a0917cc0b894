"""Multi-device inference and the training step (the JAX package's
``parallel/``): a ``(data, space)`` mesh of torch devices, the batch split
over ``data`` and, where the policy splits rows, each frame over ``space``
as row bands (``parallel.space``: every family's inference, and the
training step of every family that ``make_train_step`` carries; an op
without a row-band rule raises ``NotImplementedError`` naming
``ROADMAP.md`` Queue 1 item 3). Run the ``space`` axis on the CPU on
logical replicas (``make_mesh(2, devices=[torch.device("cpu")] * 2)`` is
``(1, 2)``) and on the card through ``chip_smoke.py`` (phases 71-93)."""

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
