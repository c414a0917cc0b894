"""bf16 training steps of the port against its own f32 steps, on the CPU.

JAX's ``make_train_step`` takes a parameter tree in any dtype; the port's
``parallel.make_train_step`` takes a module cast by ``models.common.cast_params``
(every family's ``_load(..., dtype)``) and Adam over its bf16 parameters.
The f32 steps are held against ``jax.value_and_grad`` in each family's
``tests/test_torch_<family>_train.py``, so here each family's one bf16 step
(``chip_smoke.family_trainer(name, "cpu", dtype=torch.bfloat16)``, frames
and target in bf16, L1, Adam 1e-4) is held against its f32 step on the
same weights and batch, at the f32 files' batches and shapes (EISAI 2
iterations, MoMo lite 2 denoising steps on injected noise):

* the loss is finite and within 2e-2 relative of the f32 step's;
* every gradient and every update is finite, and every parameter stays
  bf16 (but EISAI's RAFT update block, which its ``_load`` keeps in f32: it
  runs on f32 correlation features and keeps an f32 state);
* the parameters with a gradient are the f32 step's;
* the flattened gradient has a cosine of at least 0.99 with the f32 one.
  Not every parameter moves: Adam's first step of 1e-4 is below one bf16
  ulp of most weights near 0.1, in JAX's bf16 tree as here.

The soft splat's normaliser ``norm + 1e-7`` (JAX ``ops/softsplat.py:149-160``)
makes the flow's gradient ``x * exp(m) * dw / 1e-7`` at a target that only
a zero-weight tap reaches, which bf16 flows meet often (2 % of a ``randn *
4`` flow rounded to bf16 lands on an integer). That is the reference's
math: ``test_soft_splat_gradient_at_integer_taps_is_the_references``
holds the port's soft splat gradient to ``jax.grad`` of JAX's in f64 there.
So for GMFSS base and union and M2M the cosine is taken over the parameters
whose gradient reaches the loss without going back through a soft splat's
flow or metric (``COSINE_PREFIXES``): GMFSS's feature extractor (the
splat's values) and fusion net (after it); every M2M parameter reaches its
loss through the splat's flow or metric (``netFlow``, ``MRN``,
``paramAlpha``), so for M2M only finiteness is asserted. Measured cosines
of the whole gradient at seeds 16, 17, 18: GMFSS 0.114, -0.065, 0.942
(``flownet.*`` 0.480, -0.471, -0.254; ``fusionnet.*`` and ``feat_ext.*``
0.9993 or more), union 0.221, 0.041, 0.996, M2M 0.631, 0.993, 0.831. EISAI
and XVFI splat too, and measure 0.99996 or more (EISAI normalises with
zeroeps, so no ``1/eps``).

MoMo's flows are its latents times 128 through a bicubic sampler, so bf16's
rounding of the denoiser moves them by pixels: its cosine measured 0.988,
0.927 and 0.991 at seeds 16-18 (no module above 0.99 at seed 17), and is
held at 0.85, twice the largest gap. The others measured 0.992 (ATM at
seed 18) to 0.99999.

Held on the card only (``chip_smoke.py`` phase 94), because their bf16
step cannot run here (``CARD_ONLY``): STMFNet and FLAVR. torch 2.13.0+cpu's
oneDNN gives a bf16 ``conv_transpose3d`` weight gradient of ~1e36 or
non-finite values at FLAVR's ``[1, 128, 4, 32, 32]`` decoder input (f32, or
oneDNN off: finite, within 5e-3 of f32); with oneDNN off, as STMFNet's f32
file must run (a heap corruption in its f32 weight gradient), their bf16
convolutions take 126-134 s a step, and STMFNet's bf16 step with oneDNN on
did not finish in 600 s.
"""

import math
import os
import sys

import pytest
import torch

from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)
from torch_train_cases import release_module_caches  # noqa: F401  (autouse: drops the caches after the module)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the script at the repository's root; it imports nothing heavy)

SEED = 16
# each family's batch and frame size in its f32 training file
SIZES = {
    "gmfss": (1, (64, 64)), "gmfss_union": (1, (64, 64)), "eisai": (1, (64, 96)), "xvfi": (2, (64, 64)),
    "stmfnet": (1, (128, 128)), "ifrnet": (2, (64, 64)), "amt": (2, (64, 64)), "film": (1, (64, 64)),
    "ifunet": (1, (64, 64)), "atm": (1, (64, 64)), "cain": (1, (128, 128)), "flavr": (1, (64, 64)),
    "sepconv": (1, (64, 64)), "momo": (1, (64, 64)), "rife": (2, (64, 64)), "m2m": (2, (64, 64)),
}
CARD_ONLY = {
    "stmfnet": "bf16 convolutions with oneDNN off (its f32 file's heap corruption): 134 s a step; with it on, over 600 s",
    "flavr": "oneDNN's bf16 conv_transpose3d weight gradient is ~1e36 or non-finite; with oneDNN off 126-130 s a step",
}
CPU_FAMILIES = tuple(n for n in SIZES if n not in CARD_ONLY)
# where the loss reads a soft splat normalised by + eps: the parameters whose
# gradient reaches it through neither the splat's flow nor its metric (the
# card's phase 94 holds its steps by the same table)
COSINE_PREFIXES = chip_smoke.BF16_COSINE_PREFIXES
MIN_COSINE = chip_smoke.BF16_MIN_COSINE
LOSS_RTOL = chip_smoke.BF16_LOSS_RTOL
# the parameters that a family's _load keeps in f32 under a bf16 cast
F32_PARAMS = {"eisai": "raft.update_block."}


def _step(name, dtype):
    """One step of family ``name`` in ``dtype``: ``(loss, grads in f32, the
    names of the parameters whose update is not finite, each parameter's
    dtype after it)``, the gradients of the parameters that got one."""
    b, hw = SIZES[name]
    frames, t, target = chip_smoke.family_batch(name, b, hw, SEED, "cpu")
    frames, t, target = [f.to(dtype) for f in frames], t.to(dtype), target.to(dtype)
    net, step = chip_smoke.family_trainer(name, "cpu", dtype=dtype, eisai_iters=2, momo_run=("momo-lite.pth", 2))
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    loss = float(step(frames, t, target))
    grads = {k: v.grad.float() for k, v in net.named_parameters() if v.grad is not None}
    bad_updates = [k for k, v in net.named_parameters() if not bool(torch.isfinite(v.detach() - before[k]).all())]
    return loss, grads, bad_updates, {k: v.dtype for k, v in net.named_parameters()}


def _cosine(a, b, keys):
    x, y = (torch.cat([g[k].double().flatten() for k in keys]) for g in (a, b))
    return float(x @ y / (x.norm() * y.norm()))


def test_every_family_is_held_here_or_on_the_card():
    assert set(SIZES) == {*chip_smoke.FAMILIES, "rife", "m2m"} and len(SIZES) == 16
    assert set(CPU_FAMILIES) | set(CARD_ONLY) == set(SIZES)
    assert set(CARD_ONLY) <= set(chip_smoke.FAMILIES)  # phase 94 steps them in bf16


@pytest.mark.parametrize("name", CPU_FAMILIES)
def test_bf16_step_against_the_f32_step(name):
    loss32, grads32, _, _ = _step(name, torch.float32)
    loss16, grads16, bad_updates16, dtypes16 = _step(name, torch.bfloat16)
    assert math.isfinite(loss16) and abs(loss16 - loss32) <= LOSS_RTOL * abs(loss32), (loss16, loss32)
    f32 = F32_PARAMS.get(name)
    assert dtypes16 == {k: torch.float32 if f32 and k.startswith(f32) else torch.bfloat16 for k in dtypes16}
    assert sorted(grads16) == sorted(grads32)
    assert not [k for k, g in grads16.items() if not bool(torch.isfinite(g).all())]
    assert not bad_updates16
    prefixes = COSINE_PREFIXES.get(name, ("",))
    keys = [k for k in sorted(grads32) if k.startswith(prefixes)] if prefixes else []
    assert bool(keys) == (name != "m2m")
    if keys:
        cos = _cosine(grads16, grads32, keys)
        assert cos >= MIN_COSINE.get(name, 0.99), (cos, len(keys))


if __name__ == "__main__":
    for name in CPU_FAMILIES:
        loss32, grads32, _, _ = _step(name, torch.float32)
        loss16, grads16, _, _ = _step(name, torch.bfloat16)
        keys = sorted(grads32)
        mods = sorted({k.split(".")[0] for k in keys})
        print(f"{name}: loss {abs(loss16 - loss32) / abs(loss32):.3g} relative; cosine {_cosine(grads16, grads32, keys):.6f}; "
              + ", ".join(f"{m} {_cosine(grads16, grads32, [k for k in keys if k.split('.')[0] == m]):.5f}" for m in mods))
