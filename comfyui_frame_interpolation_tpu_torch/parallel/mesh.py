"""Device mesh and sharding policy, PyTorch port of the JAX package's
``parallel/mesh.py``.

Frame-pair tasks are independent, so the batch dimension splits over a
``data`` axis; the JAX package also splits tall frames by rows over a
``space`` axis and lets XLA's GSPMD insert the convolutions' halo
exchanges. Weights are replicated: the VFI nets are small.

A :class:`Mesh` is a ``(data, space)`` grid of ``torch.device``\\ s with the
JAX shape rule (``space`` = 2 when the device count is even and above 1). A
grid may repeat one device: logical replicas, which split the work as
separate devices would, on one device (the CPU tests use them).

:func:`frame_sharding` keeps JAX's policy: the batch over ``data`` always,
the rows over ``space`` only when every shard keeps
:data:`MIN_ROWS_PER_SHARD` rows. A sharding is the mesh and a spec, a tuple
naming the mesh axis of each dimension (``("data", None, None, None)``), as
JAX's ``PartitionSpec`` does.

Both axes run. Torch has no GSPMD halo exchange, so the ``space`` axis is
``parallel.space``: a frame held as row bands on one data shard's row of
devices, and an allow-list of rules (halo rows for the convolutions and the
cost volume, the global ratio for the resizes, the whole source gathered
for the warp and the global ops' keys, partial sums for the splat and the
reductions over rows) by which every family's inference runs band by band:
RIFE (every arch), FILM, IFRNet, AMT, IFUnet, CAIN, Sepconv, ATM and MoMo
(:func:`~.infer.make_sharded_model_fn`), the window-4 models FLAVR and
STMFNet (:func:`core.run_plan_window4`), and the pair-cached inference of
M2M, XVFI (Vimeo and X4K), GMFSS Fortuna (base and union) and EISAI
(:func:`~.infer.make_sharded_pair_fns`); and the training step
(:func:`~.train.make_train_step`) of every family it carries: RIFE,
M2M, XVFI, GMFSS Fortuna (base and union), EISAI, AMT, FILM, CAIN,
Sepconv, IFRNet, ATM, IFUnet and MoMo (FLAVR and STMFNet take four
frames, which no ``make_train_step`` carries). A value's band edges move
where an op needs other ones (the re-banding rule). Every other op (one
that no family uses) raises ``NotImplementedError`` on a band, naming
itself and the ``ROADMAP.md`` item (:data:`SPACE_TODO`): no run that the
policy splits over ``space`` runs
data-parallel in its place (:func:`check_runnable` raises for a caller
that cannot split rows). On the CPU the axis runs on logical replicas
(``make_mesh(8, devices=[torch.device("cpu")] * 8)``: a ``(4, 2)`` mesh);
on one card,
``chip_smoke.py`` runs it on a ``(1, 2)`` mesh of replicas of ``cuda:0``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = [
    "MIN_ROWS_PER_SHARD",
    "Mesh",
    "Sharding",
    "check_runnable",
    "data_sharding",
    "frame_sharding",
    "make_mesh",
    "replicated",
]

# Minimum frame rows per 'space' shard for spatial sharding to be applied.
MIN_ROWS_PER_SHARD = 64

# what a run on the space axis that no row-band rule covers is told
SPACE_TODO = (
    "the 'space' axis (rows split over devices) runs every family's inference and the training step of every family "
    "that make_train_step carries; an op that no family uses is ROADMAP.md Queue 1 item 3"
)


@dataclass(frozen=True)
class Mesh:
    """A ``(data, space)`` grid of devices: ``devices[i][j]`` is the device
    of data shard ``i`` and row shard ``j``."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "space": len(self.devices[0])}

    def data_devices(self) -> Tuple[torch.device, ...]:
        """The device of each data shard (row shard 0)."""
        return tuple(row[0] for row in self.devices)


@dataclass(frozen=True)
class Sharding:
    """How an array lies on ``mesh``: ``spec`` names the mesh axis of each
    dimension, or None for a dimension that is not split."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def make_mesh(
    n_devices: Optional[int] = None,
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """2-D ``(data, space)`` mesh over the first ``n_devices`` of ``devices``
    (every CUDA device by default; without CUDA this raises unless the caller
    passes ``devices``, e.g. ``[torch.device("cpu")] * 8``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= (e.g. CPU replicas) to run elsewhere")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    # "cuda" names the current device: give it its index, as tensors report it
    devices = [
        torch.device("cuda", torch.cuda.current_device()) if torch.device(d) == torch.device("cuda") else torch.device(d)
        for d in devices
    ]
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"make_mesh: {n} devices asked for, {len(devices)} given")
    devices = devices[:n]
    if shape is None:
        space = 2 if n % 2 == 0 and n > 1 else 1
        shape = (n // space, space)
    if shape[0] * shape[1] != n:
        raise ValueError(f"make_mesh: shape {shape} does not hold {n} devices")
    grid = tuple(tuple(devices[i * shape[1] : (i + 1) * shape[1]]) for i in range(shape[0]))
    return Mesh(grid)


def data_sharding(mesh: Mesh) -> Sharding:
    """NHWC batch sharded over ``data``, height over ``space``."""
    return Sharding(mesh, ("data", "space", None, None))


def frame_sharding(mesh: Mesh, shape: Sequence[int], min_rows_per_shard: int = MIN_ROWS_PER_SHARD) -> Sharding:
    """Sharding for an NHWC frame batch of ``shape``, by JAX's policy: batch
    over ``data`` always, height over ``space`` only when every shard keeps
    ``min_rows_per_shard`` rows."""
    space = mesh.shape["space"]
    if space > 1 and shape[1] // space >= min_rows_per_shard:
        return Sharding(mesh, ("data", "space", None, None))
    return Sharding(mesh, ("data", None, None, None))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def check_runnable(mesh: Mesh, frame_shape: Sequence[int], rows: bool = False) -> bool:
    """Whether a batch of NHWC frames of ``frame_shape`` splits its rows
    over ``mesh``'s ``space`` axis (:func:`frame_sharding`'s policy). Raises
    unless the batch is a multiple of the ``data`` axis, and, for a caller
    that cannot split rows (``rows=False``), when the policy would."""
    split = "space" in frame_sharding(mesh, frame_shape).spec
    if split and not rows:
        raise NotImplementedError(f"{SPACE_TODO}; frames {tuple(frame_shape)} on mesh {mesh.shape}")
    if frame_shape[0] % mesh.shape["data"]:
        raise ValueError(f"batch {frame_shape[0]} is not a multiple of the mesh's data axis {mesh.shape['data']}")
    return split
