"""What the training tests on the ``space`` axis (``tests/test_torch_space_train*.py``)
share: each family's module in a dtype, its ``apply`` as
``make_train_step`` takes it, and one step of it on a mesh of CPU replicas.

The families are those whose two-frame step ``make_train_step`` carries,
with the weights, variants and options of their one-device train tests
(``tests/test_torch_<family>_train.py``): ``init_params(0)``, Sepconv's and
MoMo's conditioned (``chip_smoke.sepconv_conditioned``,
``chip_smoke.momo_conditioned``), EISAI at 2 iterations, XVFI Vimeo at its
checkpoint's scale and ``S_tst``, AMT S with 3 flows, ATM base with global
motion and no ensemble, MoMo lite 2 steps on noise injected from a seed.
"""

from __future__ import annotations

import functools
import os
import sys
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from comfyui_frame_interpolation_tpu_torch import parallel
from comfyui_frame_interpolation_tpu_torch.models import (
    amt, atm, cain, eisai, film, gmfss, ifrnet, ifunet, m2m, momo, sepconv, xvfi,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the script at the repository's root; it imports nothing heavy)

CPU = torch.device("cpu")
LR = 1e-4
XVFI_CKPT = "XVFInet_Vimeo_exp1_latest.pt"
MOMO_CKPT, MOMO_STEPS = "momo-lite.pth", 2
EISAI_ITERS = 2


@functools.lru_cache(maxsize=None)
def params(name: str) -> Dict[str, torch.Tensor]:
    """Family ``name``'s random checkpoint (every tensor, f32)."""
    if name in ("gmfss", "gmfss_union"):
        return gmfss.init_params(0, union=name == "gmfss_union")
    if name == "xvfi":
        return xvfi.init_params(XVFI_CKPT, 0)
    if name in ("amt", "ifrnet"):
        return (amt if name == "amt" else ifrnet).init_params("S", 0)
    if name == "atm":
        return atm.init_params("base", 0)
    if name == "sepconv":
        return chip_smoke.sepconv_conditioned(0)
    if name == "momo":
        return chip_smoke.momo_conditioned(momo.init_params(0, MOMO_CKPT))
    return {"m2m": m2m, "eisai": eisai, "film": film, "cain": cain, "ifunet": ifunet}[name].init_params(0)


def net(name: str, dtype: torch.dtype) -> torch.nn.Module:
    """Family ``name``'s module in ``dtype`` on the CPU, ``channels_last``
    (IFUnet's batch norms in ``eval()``, as ``_load`` leaves them)."""
    sd = {k: v.clone() for k, v in params(name).items()}
    if name in ("gmfss", "gmfss_union"):
        return gmfss._load(sd, name == "gmfss_union", dtype, CPU)
    if name == "xvfi":
        return xvfi._load(sd, xvfi.CKPT_CONFIGS[XVFI_CKPT]["module_scale_factor"], dtype, CPU)
    if name == "amt":
        return amt._load(sd, "S", 3, dtype, CPU)
    if name == "atm":
        return atm._load(sd, "base", dtype, CPU)
    if name == "momo":
        return momo._load(sd, MOMO_CKPT, dtype, CPU)
    if name in ("m2m", "ifrnet"):
        mod = m2m.M2M_PWC() if name == "m2m" else ifrnet.IFRNet("S")
        mod.load_state_dict(sd, strict=True)
        return mod.to(dtype=dtype, memory_format=torch.channels_last)
    return {"eisai": eisai, "film": film, "cain": cain, "sepconv": sepconv, "ifunet": ifunet}[name]._load(sd, dtype, CPU)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _momo_noises(b: int, hw: Tuple[int, int]):
    """MoMo's initial latent, then one noise per step: NCHW f32, from a seed."""
    rng = np.random.default_rng(18)
    return [torch.from_numpy(rng.standard_normal((b, 4, *hw)).astype(np.float32)).contiguous(memory_format=torch.channels_last)
            for _ in range(MOMO_STEPS + 1)]


def apply_fn(name: str) -> Callable:
    """``apply(net, f0, f1, t) -> pred`` of family ``name`` on NHWC frames."""
    if name == "eisai":
        return lambda n, f0, f1, t: eisai.apply(n, f0, f1, t, iters=EISAI_ITERS)
    if name == "xvfi":
        return lambda n, f0, f1, t: xvfi.apply(n, f0, f1, t, xvfi.CKPT_CONFIGS[XVFI_CKPT]["S_tst"])
    if name == "atm":
        return lambda n, f0, f1, t: atm.apply(n, f0, f1, global_motion=True, ensemble_global_motion=False)
    if name in ("cain", "sepconv"):
        mod = cain if name == "cain" else sepconv
        return lambda n, f0, f1, t: _nhwc(mod.apply(n, _nchw(f0), _nchw(f1)))
    if name == "momo":
        def run(n, f0, f1, t):
            z = _momo_noises(f0.shape[0], tuple(f0.shape[1:3]))
            frames = (_nchw(f).contiguous(memory_format=torch.channels_last) for f in (f0, f1))
            return _nhwc(momo.apply(n, *frames, MOMO_STEPS, init_latents=z[0], step_noises=z[1:]))
        return run
    return {"m2m": m2m, "gmfss": gmfss, "gmfss_union": gmfss, "amt": amt, "film": film, "ifrnet": ifrnet,
            "ifunet": ifunet}[name].apply


def batch(b: int, hw: Tuple[int, int], dtype: torch.dtype, seed: int = 16):
    """Two NHWC frames, the target and a ``[b]`` timestep in (0.1, 0.9), from
    numpy's ``seed``, in ``dtype``."""
    rng = np.random.default_rng(seed)
    f0, f1, target = (torch.from_numpy(rng.random((b, *hw, 3))).to(dtype) for _ in range(3))
    t = torch.from_numpy(rng.uniform(0.1, 0.9, b)).to(dtype)
    return f0, f1, t, target


def step(name: str, mesh_shape: Tuple[int, int], dtype: torch.dtype, b: int, hw: Tuple[int, int]):
    """One ``make_train_step`` step (L1, Adam ``LR``) of family ``name`` in
    ``dtype`` on a ``mesh_shape`` mesh of CPU replicas, on :func:`batch`:
    ``(loss, {parameter name: gradient})``, a zero tensor for a parameter
    that got none. A mesh of more than one row shard must split the rows."""
    module = net(name, dtype)
    n = mesh_shape[0] * mesh_shape[1]
    mesh = parallel.make_mesh(n, shape=mesh_shape, devices=[CPU] * n)
    assert parallel.mesh.check_runnable(mesh, (b, *hw, 3), rows=True) == (mesh_shape[1] > 1)
    run = parallel.make_train_step(apply_fn(name), torch.optim.Adam(module.parameters(), lr=LR), mesh, module)
    loss = float(run(*batch(b, hw, dtype)))
    grads = {k: (v.grad.clone() if v.grad is not None else torch.zeros_like(v)) for k, v in module.named_parameters()}
    return loss, grads


def rel_gap(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], atol: float) -> Tuple[float, str]:
    """The largest over tensors of ``max |got - ref| - atol`` over ``max
    |ref|`` (0 where the error is within ``atol``: a gradient that is 0 but
    for rounding, such as a bias before a normalisation), and its tensor."""
    worst = (0.0, "")
    for k, r in ref.items():
        err = float((got[k].double() - r.double()).abs().max())
        scale = float(r.abs().max())
        rel = 0.0 if err <= atol else (err - atol) / scale if scale > 0 else float("inf")
        worst = max(worst, (rel, k))
    return worst
