"""What the family training tests (``tests/test_torch_*_train.py``) share: one
L1 loss and every parameter's gradient through the port's ``apply`` and
through the JAX package's, on the same weights and the same numpy batch.

The weights are the port's ``init_params`` (every tensor of the family's
checkpoint), loaded into the module with ``strict=True`` and carried to JAX
by ``nest_state_dict``/``to_jax_tree``; JAX's gradients come back by
``params_from_jax``. ``jax.value_and_grad`` differentiates the tree's
floating leaves only (a tree may also hold integer leaves, such as batch
norms' ``num_batches_tracked``, which cannot be differentiated). Batch-norm
statistics are floating leaves in JAX and buffers in the module: their JAX
gradients are computed and not compared. A module parameter registered
under several state-dict names (XVFI's ``rec_ext_ds``) gets the sum of JAX's
gradients over those names, since JAX holds each name as its own leaf.
"""

from __future__ import annotations

import ctypes
import gc
import sys
from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu import parallel as jparallel
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch import parallel
from comfyui_frame_interpolation_tpu_torch.parallel import train
from comfyui_frame_interpolation_tpu_torch.utils.ckpt import params_from_jax

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def release_module_caches(request):
    """After a training module that imports this fixture: its cached weights,
    gradients and compiled JAX steps (its ``lru_cache``s) dropped, the
    weights that ``chip_smoke.family_trainer`` keeps for the process
    (``DRAWN_PARAMS``), and JAX's compiled functions. An xdist worker runs
    many files in one process, and what each file keeps adds up to several
    GB a worker; the freed heap is handed back to the system."""
    yield
    for value in vars(request.module).values():
        if callable(getattr(value, "cache_clear", None)):
            value.cache_clear()
    smoke = sys.modules.get("chip_smoke")
    if smoke is not None:
        smoke.DRAWN_PARAMS.clear()
    jax.clear_caches()
    gc.collect()
    try:  # glibc keeps freed heap pages in the process unless asked
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:
        pass
LR = 1e-4
# RIFE's tolerance (tests/test_torch_parallel.py): the loss within 1e-6
# relative, each gradient within 5e-5 of its tensor's largest magnitude plus
# 1e-7
LOSS_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 5e-5, 1e-7


def fresh(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of ``sd``'s tensors: a module loaded with ``assign=True`` (the
    models' ``_load``) holds the tensors it is given, which a step then
    updates in place."""
    return {k: v.clone() for k, v in sd.items()}


def batch(b: int, hw: Tuple[int, int], frames: int = 2, seed: int = 16):
    """``frames`` NHWC frames, the target and a ``[b]`` timestep in (0.1,
    0.9), f32 numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    fr = [rng.random((b, *hw, 3), dtype=np.float32) for _ in range(frames)]
    target = rng.random((b, *hw, 3), dtype=np.float32)
    t = rng.uniform(0.1, 0.9, b).astype(np.float32)
    return fr, t, target


def _split(tree, prefix=""):
    floats, others = {}, {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            f, o = _split(v, key)
            floats.update(f)
            others.update(o)
        elif jnp.issubdtype(jnp.asarray(v).dtype, jnp.floating):
            floats[key] = v
        else:
            others[key] = v
    return floats, others


def _nest(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *parents, leaf = k.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def jax_loss_and_grads(sd: Dict[str, torch.Tensor], apply_fn: Callable, target: np.ndarray, f64: bool = False, jit: bool = True):
    """``jax.value_and_grad`` (jitted, or eager without ``jit``) of ``l1_loss(apply_fn(params, dtype), target)``
    over the floating leaves of ``sd``'s JAX tree: ``(loss, {state dict name:
    f64 tensor})``. ``apply_fn`` casts its frames to ``dtype``: with ``f64``
    the floating leaves, the frames and the target are f64 (JAX's
    ``enable_x64`` is on for this call only)."""
    with jax.enable_x64(f64):
        floats, others = _split(to_jax_tree(nest_state_dict(sd)))
        if f64:
            floats = {k: jnp.asarray(np.asarray(v), jnp.float64) for k, v in floats.items()}
        tgt = jnp.asarray(target, jnp.float64 if f64 else jnp.float32)

        def loss_fn(fl):
            return jparallel.l1_loss(apply_fn(_nest({**fl, **others}), tgt.dtype), tgt)

        vg = jax.value_and_grad(loss_fn)
        loss, grads = (jax.jit(vg) if jit else vg)(floats)
        return float(loss), {k: torch.from_numpy(np.asarray(v, np.float64)) for k, v in params_from_jax(_nest(grads)).items()}


def port_loss_and_grads(net: torch.nn.Module, apply_fn: Callable, target: np.ndarray):
    """``l1_loss(apply_fn(net), target).backward()``: ``(loss, {parameter
    name: gradient})``, a zero tensor for a parameter that got none."""
    loss = train.l1_loss(apply_fn(net), torch.from_numpy(target))
    loss.backward()
    grads = {k: (v.grad.clone() if v.grad is not None else torch.zeros_like(v)) for k, v in net.named_parameters()}
    return float(loss.detach()), grads


def aliases(net: torch.nn.Module) -> Dict[str, List[str]]:
    """Each parameter's name -> every state-dict name that holds it."""
    names = {id(v): k for k, v in net.named_parameters()}
    out: Dict[str, List[str]] = {k: [] for k in names.values()}
    for k, v in net.state_dict(keep_vars=True).items():
        if id(v) in names:
            out[names[id(v)]].append(k)
    return out


def jax_param_grads(net: torch.nn.Module, jgrads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """JAX's gradients per module parameter: the sum over its state-dict
    names."""
    return {k: sum(jgrads[n] for n in names) for k, names in aliases(net).items()}


def rel_errors(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], atol: float = GRAD_ATOL) -> Dict[str, float]:
    """Per tensor, ``max |got - ref| - atol`` over ``max |ref|`` (0 where the
    error is within ``atol``)."""
    out = {}
    for k, r in ref.items():
        err = float((got[k].double() - r.double()).abs().max())
        scale = float(r.abs().max())
        out[k] = 0.0 if err <= atol else (err - atol) / scale if scale > 0 else float("inf")
    return out


def median_rel(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """The median over tensors of ``max |got - ref|`` over ``max |ref|``
    (tensors whose reference is 0 aside)."""
    rel = [float((got[k].double() - r.double()).abs().max()) / float(r.abs().max()) for k, r in ref.items() if float(r.abs().max()) > 0]
    return float(np.median(rel))


def assert_grads_close(got, ref, rtol: float = GRAD_RTOL, atol: float = GRAD_ATOL, rtol_by_key: Dict[str, float] = None):
    """Each gradient within ``rtol`` of its tensor's largest magnitude plus
    ``atol``; a tensor named in ``rtol_by_key`` within its own bound there."""
    assert got.keys() == ref.keys()
    loose = rtol_by_key or {}
    assert set(loose) <= set(ref), sorted(set(loose) - set(ref))
    over = {k: v for k, v in rel_errors(got, ref, atol).items() if not v <= loose.get(k, rtol)}
    assert not over, over


def spread_report(name: str, got, ref) -> str:
    """One line: ``got``'s median and worst errors against ``ref``, as the
    tests bound them."""
    return f"{name}: median {median_rel(got, ref):.3g}, worst {max(rel_errors(got, ref).values()):.3g}"


def by_threads(port_fn: Callable, counts: Iterable[int] = (1, 2, 4, 8)) -> Dict[int, object]:
    """``port_fn()`` with torch at each thread count in ``counts`` (the order
    of its CPU sums moves with it): ``{count: result}``."""
    before, out = torch.get_num_threads(), {}
    try:
        for n in counts:
            torch.set_num_threads(n)
            out[n] = port_fn()
    finally:
        torch.set_num_threads(before)
    return out


def untrained(grads: Dict[str, torch.Tensor]) -> List[str]:
    return sorted(k for k, g in grads.items() if not float(g.abs().max()) > 0.0)


def assert_untrained_are_zero_in_jax(grads, jgrads, expected: Iterable[str]):
    """The tensors that get no gradient in the port are ``expected``, and
    JAX's gradient of each is exactly 0."""
    none = untrained(grads)
    assert none == sorted(expected)
    assert all(float(jgrads[k].abs().max()) == 0.0 for k in none), [k for k in none if float(jgrads[k].abs().max()) != 0.0]


def step_on_cpu_mesh(make_net: Callable, apply_fn: Callable, fr, t, target):
    """One ``parallel.make_train_step`` step (L1, Adam ``LR``) on a
    one-device CPU mesh: ``(loss, grads, updates)``."""
    net = make_net()
    step = parallel.make_train_step(apply_fn, torch.optim.Adam(net.parameters(), lr=LR), parallel.make_mesh(1, devices=[CPU]), net)
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    loss = step(*(torch.from_numpy(x) for x in (*fr, t, target)))
    grads = {k: (v.grad.clone() if v.grad is not None else torch.zeros_like(v)) for k, v in net.named_parameters()}
    return float(loss), grads, {k: v.detach() - before[k] for k, v in net.named_parameters()}


def assert_adam_first_step(grads, deltas):
    """Adam's first step moves each parameter by ``-lr * g / (|g| + 1e-8)``:
    at most ``lr``, and ``-lr * sign(g)`` within 1e-3 of ``lr`` where
    ``|g| > 1e-5``; most parameters move."""
    moved = 0
    for k, g in grads.items():
        assert float(deltas[k].abs().max()) <= LR * (1 + 1e-3) + 2.0**-20, k
        moved += int((deltas[k] != 0).sum())
        big = g.abs() > 1e-5
        torch.testing.assert_close(deltas[k][big], -LR * torch.sign(g[big]), rtol=0, atol=1e-3 * LR + 2.0**-20)
    assert moved > 0.5 * sum(g.numel() for g in grads.values())
