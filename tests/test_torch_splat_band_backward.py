"""The splat's backward on a row band (the ``space`` axis of ``parallel/``)
on the CPU: the backward kernel's plain version with a band, and the splat
rule's gradient.

* ``ops.softsplat.softsplat_backward_torch`` with ``row0``/``out_rows`` on
  three uneven bands of ``[2, 97, 40, C]``, C = 4 and 65, f64 values and
  flows (the plain version sums in f32, as the kernel does), given the
  whole frame's output gradient: each band's ``(grad_in, grad_flow)`` is
  the whole frame's rows of its sources bit for bit (the gradient is a
  gather: each source reads the output's gradient at its own global
  corners). The flows reach across the band edges, off the frame (both
  ways and beyond the ``+-2h`` clamp) and to non-finite targets.
  ``row0 = 0, out_rows = h`` is the default call bit for bit;
* the whole frame's gradient against ``jax.vjp`` of the JAX package's
  ``_softsplat_xla`` on the same inputs in f32, with
  ``tests/test_torch_softsplat_grad.py``'s mask of dropped corners (a
  source beyond ``+-1e6`` px given to JAX as non-finite) and tolerances:
  the input's gradient within 2e-6, the flow's within 1e-5 of its largest
  magnitude plus 1e-6 (measured: the input's bit for bit, the flow's
  bit for bit at C = 4 and within 1.5e-7 of its largest magnitude at
  C = 65);
* ``softsplat_func`` on ``RowBands`` with a gradient, split by
  ``split_rows`` over ``(1, 2)`` and ``(1, 3)`` meshes of CPU replicas
  (200 rows: 128 + 72 and 128 + 64 + 8), against the whole tensor in f64:
  the values' and the flow's gradients within 1e-12 (measured: bit for
  bit: the bands' gradient, joined whole on each partial's device, is the
  whole frame's), the splat itself within 1e-6 (its sums are f32 in both,
  the bands' partials added in another order; measured 4.8e-7);
* a band that does not lie within the output's rows raises.

``PYTHONPATH=.:tests python tests/test_torch_splat_band_backward.py``
prints the gaps. No JAX compile of note (``jax.vjp`` runs eagerly).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.ops.softsplat import _softsplat_xla
from comfyui_frame_interpolation_tpu_torch.ops.cuda import softsplat_kernel
from comfyui_frame_interpolation_tpu_torch.ops.softsplat import softsplat_backward_torch, softsplat_func
from comfyui_frame_interpolation_tpu_torch.parallel import space
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

CPU = torch.device("cpu")
H, W = 97, 40
BANDS = ((0, 40), (40, 33), (73, 24))
IN_ATOL, FLOW_RTOL, FLOW_ATOL = 2e-6, 1e-5, 1e-6
GRAD_ATOL_F64 = 1e-12
SPLAT_ATOL = 1e-6


def _inputs(c, h=H, w=W, seed=0, dtype=np.float64):
    """Values in [0, 1), flows of up to +-30 px (across the band edges and
    off the frame), a block of sources sent beyond the ``+-2h`` clamp, a few
    non-finite targets, and an output gradient in [-1, 1]."""
    rng = np.random.default_rng(seed + c)
    vals = rng.random((2, h, w, c)).astype(dtype)
    flow = ((rng.random((2, h, w, 2)) * 2 - 1) * 30).astype(dtype)
    flow[0, 10:14, 5:9] = (0.5, 5 * h)  # far below the frame: clamped, dropped
    flow[1, h - 6 :, :4] = (-4 * w, 0.25)  # far left: clamped, dropped
    flow[0, 50, 7, 0] = np.inf
    flow[1, 30, 20, 1] = np.nan
    flow[1, 80, 33] = (np.nan, np.inf)
    grad_out = rng.uniform(-1.0, 1.0, (2, h, w, c)).astype(np.float32)
    return vals, flow, grad_out


def _band_grads(vals, flow, grad_out, bands=BANDS):
    h = vals.shape[1]
    return [softsplat_backward_torch(vals[:, a : a + n], flow[:, a : a + n], grad_out, row0=a, out_rows=h) for a, n in bands]


@pytest.mark.parametrize("c", [4, 65])
def test_band_backward_is_the_whole_frames_rows(c):
    vals, flow, grad_out = (torch.from_numpy(a) for a in _inputs(c))
    whole_i, whole_f = softsplat_backward_torch(vals, flow, grad_out)
    assert whole_i.dtype == whole_f.dtype == torch.float64
    assert float(whole_i.abs().max()) > 0 and float(whole_f.abs().max()) > 0
    for (a, n), (gi, gf) in zip(BANDS, _band_grads(vals, flow, grad_out)):
        assert gi.shape == (2, n, W, c) and gf.shape == (2, n, W, 2)
        assert torch.equal(gi, whole_i[:, a : a + n]) and torch.equal(gf, whole_f[:, a : a + n])
    same_i, same_f = softsplat_backward_torch(vals, flow, grad_out, row0=0, out_rows=H)
    assert torch.equal(same_i, whole_i) and torch.equal(same_f, whole_f)


def test_dropped_band_sources_pass_no_gradient():
    """The sources sent off the frame, beyond the clamp and to non-finite
    targets get zero gradients in their bands too."""
    vals, flow, grad_out = (torch.from_numpy(a) for a in _inputs(4))
    (gi0, gf0), (gi1, gf1), (gi2, gf2) = _band_grads(vals, flow, grad_out)
    for gi, gf, b, y, x in ((gi0, gf0, 0, 12, 6), (gi2, gf2, 1, H - 1 - 73, 0), (gi1, gf1, 0, 50 - 40, 7),
                            (gi0, gf0, 1, 30, 20), (gi2, gf2, 1, 80 - 73, 33)):
        assert float(gi[b, y, x].abs().max()) == 0.0 and float(gf[b, y, x].abs().max()) == 0.0, (b, y, x)


def _dropped(flow):
    """The flow with every source whose target is beyond +-1e6 px made
    non-finite, for the JAX side (as ``tests/test_torch_softsplat_grad.py``
    gives it)."""
    f = flow.copy()
    f[np.abs(f).max(-1) > 1e6] = np.inf
    return f


def _jax_gaps(c):
    vals, flow, grad_out = _inputs(c, dtype=np.float32)
    _, vjp = jax.vjp(_softsplat_xla, jnp.asarray(vals), jnp.asarray(_dropped(flow)))
    ref_i, ref_f = (np.asarray(g) for g in vjp(jnp.asarray(grad_out)))
    bands = _band_grads(*(torch.from_numpy(a) for a in (vals, flow, grad_out)))
    got_i = torch.cat([gi for gi, _ in bands], 1).numpy()
    got_f = torch.cat([gf for _, gf in bands], 1).numpy()
    return got_i, got_f, ref_i, ref_f


@pytest.mark.parametrize("c", [4, 65])
def test_band_backward_matches_jax_vjp(c):
    got_i, got_f, ref_i, ref_f = _jax_gaps(c)
    assert np.isfinite(got_i).all() and np.isfinite(got_f).all()
    np.testing.assert_allclose(got_i, ref_i, atol=IN_ATOL, rtol=0)
    np.testing.assert_allclose(got_f, ref_f, atol=FLOW_RTOL * float(np.abs(ref_f).max()) + FLOW_ATOL, rtol=0)


def _split_gaps(n, c):
    """``softsplat_func`` on ``n`` bands of 200 rows (``split_rows`` over CPU
    replicas) with a gradient against the whole tensor, f64: the gaps of the
    splat, the values' gradient and the flow's."""
    vals, flow, _ = _inputs(c, h=200, seed=n)
    grad = torch.from_numpy(np.random.default_rng(n).uniform(-1.0, 1.0, vals.shape))
    x, f = torch.from_numpy(vals).requires_grad_(), torch.from_numpy(flow).requires_grad_()
    whole = softsplat_func(x, f)
    ref_x, ref_f = torch.autograd.grad(whole, (x, f), grad)
    xb, fb = space.split_rows(x, [CPU] * n), space.split_rows(f, [CPU] * n)
    assert [b.shape[1] for b in xb.bands] == {2: [128, 72], 3: [128, 64, 8]}[n]
    out = softsplat_func(xb, fb)
    assert isinstance(out, space.RowBands) and out.dtype == torch.float64
    split = out.gather(CPU)
    got_x, got_f = torch.autograd.grad(split, (x, f), grad)
    gap = lambda a, b: float((a - b).abs().max())  # noqa: E731
    return gap(split.detach(), whole.detach()), gap(got_x, ref_x), gap(got_f, ref_f), float(ref_f.abs().max())


@pytest.mark.parametrize("c", [4, 65])
@pytest.mark.parametrize("n", [2, 3])
def test_split_splat_gradient_matches_the_whole_tensor(n, c):
    splat, gx, gf, scale = _split_gaps(n, c)
    assert scale > 0
    assert splat <= SPLAT_ATOL and gx <= GRAD_ATOL_F64 and gf <= GRAD_ATOL_F64, (splat, gx, gf)


def test_a_band_outside_the_rows_raises():
    """The plain version refuses a band that does not lie within the
    output's rows, as the kernel's entry does (-2); the CUDA wrapper refuses
    CPU tensors before anything is built (no fallback to the plain version)."""
    vals, flow, grad_out = (torch.from_numpy(a) for a in _inputs(4))
    with pytest.raises(ValueError, match="does not lie within"):
        softsplat_backward_torch(vals[:, :40], flow[:, :40], grad_out, row0=60, out_rows=H)
    with pytest.raises(ValueError, match="CUDA tensors"):
        softsplat_kernel.softsplat_bilinear_backward(vals[:, :40].permute(0, 3, 1, 2).float(), flow[:, :40].permute(0, 3, 1, 2).float(),
                                                     grad_out.permute(0, 3, 1, 2), row0=40, out_rows=H)


if __name__ == "__main__":
    for c in (4, 65):
        gi, gf, ri, rf = _jax_gaps(c)
        print(f"C = {c}: against jax.vjp, grad_in {np.abs(gi - ri).max():.3g}, grad_flow {np.abs(gf - rf).max() / np.abs(rf).max():.3g} "
              "of its largest magnitude", flush=True)
        for n in (2, 3):
            splat, gx, gff, scale = _split_gaps(n, c)
            print(f"C = {c}, {n} bands: splat {splat:.3g}, grad_in {gx:.3g}, grad_flow {gff:.3g} (largest {scale:.3g})", flush=True)
