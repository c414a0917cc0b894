"""Multi-device inference: wrap an executor-shaped model callable for a mesh,
PyTorch port of the JAX package's ``parallel/infer.py``.

The JAX version jits one callable over the mesh and lets GSPMD split it. A
torch model callable is bound to the device its weights are on, so here each
wrapper takes a factory, ``make_fn(device)``, built once per distinct device
of the mesh's ``data`` axis (logical replicas of one device share one), and
splits the work itself: every batch argument is cut into ``data`` equal
shards along its first dimension, shard ``i`` runs on the ``i``-th data
device, and the outputs are concatenated on the first one. The executors
then slice along the batch, as they do with one device. Launches are
asynchronous, so shards on different cards overlap.

A mesh of one data shard takes the same path, with one shard of the whole
batch: the same result, bit for bit, as calling the model unwrapped.

A batch that :func:`~.mesh.frame_sharding` splits over ``space`` (frames of
at least ``64 * space`` rows on a mesh whose ``space`` axis is over 1): both
wrappers also cut each data shard's NHWC frames into row bands over that
shard's row of devices (``parallel.space.split_rows``), the model runs on
them through the row-band rules, and the output's bands are gathered on the
first device in global row order. :func:`make_sharded_model_fn` runs RIFE
(every arch), FILM, IFRNet, AMT, IFUnet, CAIN, Sepconv, ATM (base and lite,
global motion off, on and with the ensemble) and MoMo (base and lite) so,
and the window-4 models FLAVR and STMFNet (``run_plan_window4``: all four
frames of each window cut into the same bands);
:func:`make_sharded_pair_fns` runs every pair-cached family: M2M, XVFI
(Vimeo and X4K), GMFSS Fortuna (base and union) and EISAI, whose caches
then hold row bands (``RowBands`` leaves beside plain tensors such as M2M's
frame mean; all of XVFI's, GMFSS's flows, metrics and feature pyramids,
EISAI's two flows), each shard's on its own row of devices, and go back to
the same shard's ``infer_fn``. So every family's inference splits by rows;
a model with an op that no rule covers raises at it, naming it and
``ROADMAP.md``'s item, and nothing runs data-parallel or on the whole frame
in place of a row split. MoMo draws noise: each data shard draws the whole
batch's and keeps its own samples (``batch_slice``), so a seed gives one
device's frames on any mesh.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Tuple

import torch

from .mesh import Mesh, check_runnable
from .space import RowBands, split_rows

__all__ = ["make_sharded_model_fn", "make_sharded_pair_fns"]


def _per_device(make_fn: Callable[[torch.device], Any], mesh: Mesh) -> List[Any]:
    """``make_fn(device)`` for each data shard, built once per distinct device."""
    built: Dict[torch.device, Any] = {}
    for d in mesh.data_devices():
        if d not in built:
            built[d] = make_fn(d)
    return [built[d] for d in mesh.data_devices()]


def _takes_batch_slice(fn: Callable) -> bool:
    try:
        return "batch_slice" in inspect.signature(fn).parameters
    except (TypeError, ValueError):  # a callable without a signature
        return False


def _split(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """``x`` cut into the mesh's data shards along its first dimension, each
    on its shard's device."""
    return [part.to(d) for part, d in zip(torch.chunk(x, mesh.shape["data"]), mesh.data_devices())]


def _gather(parts: List[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The shards' outputs concatenated on the first data device (row bands
    gathered there first, in global row order)."""
    first = mesh.data_devices()[0]
    return torch.cat([p.gather(first) if isinstance(p, RowBands) else p.to(first) for p in parts], 0)


def _split_args(args, mesh: Mesh, rows: bool) -> List[list]:
    """Each data shard's arguments: every argument cut along its first
    dimension (:func:`_split`), and with ``rows`` each 4-D one (the NHWC
    frames) cut into row bands over the shard's row of devices."""
    shards = [list(part) for part in zip(*(_split(a, mesh) for a in args))]
    if rows:
        for part, devices in zip(shards, mesh.devices):
            part[:] = [split_rows(a, devices) if a.dim() == 4 else a for a in part]
    return shards


def make_sharded_model_fn(make_fn: Callable[[torch.device], Callable], mesh: Mesh) -> Callable:
    """``model_fn(*args) -> frames`` run split over ``mesh``'s ``data`` axis.

    ``make_fn(device)`` returns the model callable on ``device`` (for example
    ``lambda d: rife.make_model_fn(params, "4.7", device=d)``): positional
    NHWC batches, ``model_fn(f0, f1, t)`` for :func:`core.run_plan` or
    ``model_fn(f0, f1, f2, f3)`` for :func:`core.run_plan_window4`. Every
    argument (the ``[B]`` timestep vector too) is split along its first
    dimension, which must be a multiple of ``mesh.shape['data']`` (pick an
    executor ``batch_size`` that is); where the policy splits rows, the
    frames also go to each shard as row bands (the module docstring). A
    callable that declares a ``batch_slice`` parameter (MoMo's, which draws
    noise) is told which samples of the batch its shard holds,
    ``batch_slice=(start, total)``, so that it can draw for the whole batch
    and keep its own: the split then gives one device's frames."""
    fns = _per_device(make_fn, mesh)
    sliced = [_takes_batch_slice(fn) for fn in fns]

    def sharded_fn(*args):
        rows = check_runnable(mesh, next((a.shape for a in args if a.dim() == 4), (args[0].shape[0], 0, 0, 0)), rows=True)
        total = args[0].shape[0]
        per = total // mesh.shape["data"]
        return _gather([
            fn(*part, **({"batch_slice": (i * per, total)} if s else {}))
            for i, (fn, s, part) in enumerate(zip(fns, sliced, _split_args(args, mesh, rows)))
        ], mesh)

    return sharded_fn


def make_sharded_pair_fns(make_pair_fns: Callable[[torch.device], Tuple[Callable, Callable]], mesh: Mesh) -> tuple:
    """Split a ``run_plan_pair_cached`` ``(reuse_fn, infer_fn)`` pair over
    ``mesh``'s ``data`` axis.

    ``make_pair_fns(device)`` returns the pair on ``device`` (for example
    ``lambda d: m2m.make_pair_fns(params, device=d)``). Returns
    ``(sharded_reuse, sharded_infer)`` with the executor's signatures
    (``reuse_fn(f0, f1) -> cache``, ``infer_fn(f0, f1, cache, t) -> mids``).
    The cache, whose structure only the model knows, is the tuple of the
    shards' own caches: each holds the per-pair tensors of its shard of the
    batch, on its device (as row bands on its row of devices where the
    policy splits rows: the module docstring), and goes back to the same
    shard's ``infer_fn``. The executor's ``batch_size`` must be a multiple
    of ``mesh.shape['data']``."""
    pairs = _per_device(make_pair_fns, mesh)

    def sharded_reuse(f0, f1):
        rows = check_runnable(mesh, f0.shape, rows=True)
        return tuple(reuse(a, b) for (reuse, _), (a, b) in zip(pairs, _split_args((f0, f1), mesh, rows)))

    def sharded_infer(f0, f1, cache, t):
        rows = check_runnable(mesh, f0.shape, rows=True)
        parts = zip(pairs, _split_args((f0, f1, t), mesh, rows), cache)
        return _gather([infer(a, b, c, tt) for (_, infer), (a, b, tt), c in parts], mesh)

    return sharded_reuse, sharded_infer
