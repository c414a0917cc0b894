"""Training step (fine-tuning / distillation harness), PyTorch port of the
JAX package's ``parallel/train.py``.

Every op on the flow models' paths is differentiable: the warp through
``ops.cuda.warp_kernel.WarpFunction`` on the card (the routed forward kernel
and a hand-written backward kernel), through autograd of the plain twin on
the CPU. The JAX step is functional (``(params, opt_state)`` in and out,
``jax.value_and_grad`` and ``optax``); here a module and a
``torch.optim`` optimizer over its parameters are updated in place, the
torch idiom.

The batch is split over the mesh's ``data`` shards as ``parallel.infer``
splits it (one shard of the whole batch on a one-device mesh). Each shard
runs the model on its device with the parameters copied there (``torch.func.functional_call``; the copies are
differentiable, so backward sums every shard's gradient onto the module's
own parameters), and the loss is the mean over the whole batch, taken on the
first device: the gradient equals the one-device gradient.

Where :func:`~.mesh.frame_sharding` splits rows over ``space``, each shard's
frames are also cut into row bands over the shard's row of devices
(``parallel.space``), the model runs band by band, and the bands are
gathered on the first device in global row order (a differentiable
``cat``) before the same loss: autograd sums the gradient over every band
and shard back through the same parameter copies. Every family whose
two-frame step this carries trains so: RIFE, M2M, XVFI, GMFSS Fortuna
(base and union), EISAI, AMT, FILM, CAIN, Sepconv, IFRNet, ATM, IFUnet
and MoMo (the splat's band partials through the splat's backward kernel
on the band; AMT's correlation and EISAI's all-pairs pyramid through the
target gathered whole). FLAVR and STMFNet take four frames, which no
``make_train_step`` carries, in the JAX package either. A model with an
op that has no row-band rule raises at it, naming the op and the
``ROADMAP.md`` item; it never falls back to a data-parallel or one-device
step.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn as nn

from .infer import _gather, _split_args
from .mesh import Mesh, check_runnable, make_mesh

__all__ = ["dryrun", "l1_loss", "make_train_step"]


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


class _Applied(nn.Module):
    """``apply_fn(net, ...)`` as a module's forward, for
    ``torch.func.functional_call``."""

    def __init__(self, net: nn.Module, apply_fn: Callable):
        super().__init__()
        self.net = net
        self.apply_fn = apply_fn

    def forward(self, *args):
        return self.apply_fn(self.net, *args)


def make_train_step(
    apply_fn: Callable, optimizer: torch.optim.Optimizer, mesh: Mesh, net: nn.Module
) -> Callable:
    """Build ``step(f0, f1, t, target) -> loss``: one L1 step of ``net``
    (which lives on the mesh's first data device, and whose parameters
    ``optimizer`` updates) on NHWC batches and a ``[B]`` timestep vector.

    ``apply_fn(net, f0, f1, t) -> pred`` is the model forward (already
    closed over static config such as scale lists). The gradients are left
    in the parameters' ``.grad`` after the step; the loss comes back
    detached."""
    first = mesh.data_devices()[0]
    for name, p in net.named_parameters():
        if p.device != first:
            raise ValueError(f"make_train_step: parameter {name} on {p.device}, the mesh's first device is {first}")
    applied = _Applied(net, apply_fn)
    state = {**dict(applied.named_parameters()), **dict(applied.named_buffers())}

    def step(f0: torch.Tensor, f1: torch.Tensor, t: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        rows = check_runnable(mesh, f0.shape, rows=True)
        optimizer.zero_grad(set_to_none=True)
        preds = []
        for d, (a, b, tt) in zip(mesh.data_devices(), _split_args((f0, f1, t), mesh, rows)):
            on_d = {k: v.to(d) for k, v in state.items()}
            preds.append(torch.func.functional_call(applied, on_d, (a, b, tt)))
        loss = l1_loss(_gather(preds, mesh), target.to(first))
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def dryrun(n_devices: int, device: str = "cuda") -> None:
    """One training step of RIFE 4.7 (random weights, seed 0, Adam 1e-4) on
    ``make_mesh(n_devices)``, the counterpart of the JAX package's
    ``__graft_entry__.py:dryrun_multichip``: the first ``n_devices`` CUDA
    devices, or with ``device="cpu"`` that many logical replicas of the CPU.
    As JAX's, the mesh takes JAX's shape rule and the batch JAX's 128x128
    crops, so an even count trains in the spatially sharded regime (``space``
    = 2, 64 rows a band). Checks that the loss is finite and the parameters
    moved, and prints the JAX dry run's line."""
    from ..models import rife

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < n_devices:
            raise RuntimeError(
                f"dryrun({n_devices}): {torch.cuda.device_count() if torch.cuda.is_available() else 0} CUDA device(s)"
            )
        devices = None
    else:
        devices = [torch.device(device)] * n_devices
    mesh = make_mesh(n_devices, devices=devices)
    first = mesh.data_devices()[0]
    net = rife.IFNet("4.7")
    net.load_state_dict(rife.init_params(0, "4.7"), strict=True)
    net = net.to(first, memory_format=torch.channels_last)
    scale_list = rife.default_scale_list("4.7")

    def apply_fn(net, f0, f1, t):
        return rife.apply(net, f0, f1, t, scale_list)

    step = make_train_step(apply_fn, torch.optim.Adam(net.parameters(), lr=1e-4), mesh, net)
    b = max(2, mesh.shape["data"])
    rng = np.random.default_rng(0)
    f0 = torch.from_numpy(rng.random((b, 128, 128, 3), np.float32)).to(first)
    f1 = torch.from_numpy(rng.random((b, 128, 128, 3), np.float32)).to(first)
    t = torch.full((b,), 0.5, device=first)
    before: Dict[str, torch.Tensor] = {k: v.detach().clone() for k, v in net.named_parameters()}
    loss = float(step(f0, f1, t, (f0 + f1) / 2))
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun({n_devices}): loss {loss}")
    moved = max(float((v.detach() - before[k]).abs().max()) for k, v in net.named_parameters())
    if not moved > 0.0:
        raise RuntimeError(f"dryrun({n_devices}): no parameter moved")
    print(f"dryrun_multichip({n_devices}) OK: loss={loss:.5f}, mesh={mesh.shape}")
