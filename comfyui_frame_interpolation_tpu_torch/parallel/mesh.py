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
JAX's ``PartitionSpec`` does. The port runs the ``data`` axis; torch has no
GSPMD halo exchange, and one H100 holds every shape of the paths, so a
run that the policy would split over ``space`` raises ``NotImplementedError``
(:func:`check_runnable`) instead of running data-parallel in its place.
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

# what a run that needs the space axis is told
SPACE_TODO = "the 'space' axis (rows split over devices) is not ported: ROADMAP.md Queue 1 item 3"


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


def check_runnable(mesh: Mesh, frame_shape: Sequence[int]) -> None:
    """Raise unless a batch of NHWC frames of ``frame_shape`` runs on
    ``mesh`` as the port runs it: split over ``data`` only, the batch a
    multiple of the ``data`` axis."""
    if "space" in frame_sharding(mesh, frame_shape).spec:
        raise NotImplementedError(f"{SPACE_TODO}; frames {tuple(frame_shape)} on mesh {mesh.shape}")
    if frame_shape[0] % mesh.shape["data"]:
        raise ValueError(f"batch {frame_shape[0]} is not a multiple of the mesh's data axis {mesh.shape['data']}")
