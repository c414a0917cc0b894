"""The warp's gradient in the port against the JAX package's, on the CPU.

``ops.warp.warp_backward_torch`` (``torch.autograd.grad`` through the plain
twin, the backward kernel's plain version) against ``jax.vjp`` of
``comfyui_frame_interpolation_tpu.ops.warp.warp_xla``, which is the gradient
the JAX package trains with (XLA's VJP of the gather; no Pallas kernel has
a backward), on the same numpy inputs and the same output gradient, f32
only (``warp_xla`` builds its grid in the flow's dtype):

* the flow cases of ``tests/warp_cases.py`` at 32x64, border and zeros;
* samples exactly on each bound of the frame, where JAX's ``jnp.clip``
  gives the derivative 0.5 (``torch.clamp`` would give 1);
* integer flows (every sample on a pixel);
* the backward kernel's cases that those lack (``warp_cases.backward_cases``
  at 32x64): a pile of 256 samples on each of four taps, a half-pixel
  constant offset, and C = 8 and 9 (the edges of the kernel's channel
  padding to a multiple of 4 and of its groups of 8 channels);
* zeros mode with non-finite flow: ``warp_xla`` gives NaN there (and
  scatters NaN into the image's gradient at the taps it clamped to), the
  port gives zero gradients, so those pixels are masked, as the forward
  tests mask them.

Tolerances, on values in [0, 1] and output gradients in [-1, 1]: the
image's gradient within 2e-6 (a few products summed in another order than
XLA's scatter; measured 0 on these cases); the flow's within 1e-5 of the
largest magnitude of its case plus 1e-6 (a sum of up to 40 channels'
products in another order; measured 3.9e-7 of it).

The backward wrapper's host-side helpers are checked here too: the
padded channel count of its image-gradient buffer and the vector width in
which it reads each input.

On the card the backward kernel is held to this plain version in
``tests/test_torch_cuda_warp.py``; a CUDA splat with an input that needs a
gradient must go through the splat's autograd Function (marked ``cuda``,
so it skips here).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import warp_cases
from comfyui_frame_interpolation_tpu.ops.warp import warp_xla
from comfyui_frame_interpolation_tpu_torch.ops.cuda import warp_kernel
from comfyui_frame_interpolation_tpu_torch.ops.warp import _clip, warp, warp_backward_torch, warp_torch
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

IMG_ATOL = 2e-6
FLOW_RTOL = 1e-5
FLOW_ATOL = 1e-6

CASES = warp_cases.warp_cases(3, 32, 64)
CASE_MODES = [(c["name"], m) for c in CASES for m in c["modes"]]
BACKWARD_CASES = {c["name"]: c for c in warp_cases.backward_cases(4, 32, 64)}


def _jax_grads(img, flow, g, mode):
    _, vjp = jax.vjp(lambda i, f: warp_xla(i, f, mode), jnp.asarray(img), jnp.asarray(flow))
    gi, gf = vjp(jnp.asarray(g))
    return np.asarray(gi), np.asarray(gf)


def _port_grads(img, flow, g, mode):
    gi, gf = warp_backward_torch(torch.from_numpy(img), torch.from_numpy(flow), torch.from_numpy(g), mode)
    return gi.numpy(), gf.numpy()


def _out_grad(img, seed):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, img.shape).astype(np.float32)


def _compare(img, flow, mode, seed=0):
    g = _out_grad(img, seed)
    ref_i, ref_f = _jax_grads(img, flow, g, mode)
    got_i, got_f = _port_grads(img, flow, g, mode)
    assert got_i.shape == img.shape and got_f.shape == flow.shape
    finite = np.isfinite(flow).all(-1)
    # warp_xla's NaN at a non-finite pixel reaches the image's gradient at
    # the taps it clamped to: compare where JAX's gradient is finite
    img_ok = np.isfinite(ref_i)
    assert np.isfinite(got_i).all() and np.isfinite(got_f).all()
    np.testing.assert_allclose(got_i[img_ok], ref_i[img_ok], atol=IMG_ATOL, rtol=0)
    scale = float(np.abs(ref_f[finite]).max(initial=0.0))
    np.testing.assert_allclose(got_f[finite], ref_f[finite], atol=FLOW_RTOL * scale + FLOW_ATOL, rtol=0)
    if mode == "zeros":
        assert np.all(got_f[~finite] == 0.0)
    return ref_f, got_f


@pytest.mark.parametrize("name,mode", CASE_MODES)
def test_backward_matches_jax_vjp(name, mode):
    case = next(c for c in CASES if c["name"] == name)
    _compare(case["img"], case["flow"], mode)


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_backward_on_exact_bounds_matches_jax(mode):
    h, w = 20, 24
    img = np.random.default_rng(5).random((1, h, w, 3), dtype=np.float32)
    flow = warp_cases.bound_flow(1, h, w)
    ref_f, got_f = _compare(img, flow, mode, seed=5)
    if mode == "border":
        # at x = 0 the flow's x gradient is JAX's 0.5 times the one-sided
        # slope: the twin with torch.clamp's derivative (1) is twice as large
        g = _out_grad(img, 5)
        q = h // 5  # rows 0 .. q - 1 have zero flow: column 0 samples x = 0, taps x0 = 0 and x1 = 1
        slope = ((img[0, :q, 1] - img[0, :q, 0]) * g[0, :q, 0]).sum(-1)
        np.testing.assert_allclose(got_f[0, :q, 0, 0], 0.5 * slope, atol=FLOW_ATOL, rtol=1e-5)
        assert np.abs(slope).max() > 0.1


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_backward_integer_flows_matches_jax(mode):
    rng = np.random.default_rng(7)
    img = rng.random((2, 16, 40, 7), dtype=np.float32)
    flow = rng.integers(-5, 6, (2, 16, 40, 2)).astype(np.float32)
    _compare(img, flow, mode, seed=7)


@pytest.mark.parametrize("mode", ["border", "zeros"])
@pytest.mark.parametrize("name", ["bwd_pile_c7", "bwd_half_offset_c7", "bwd_c8", "bwd_c9"])
def test_backward_kernel_cases_match_jax(name, mode):
    case = BACKWARD_CASES[name]
    _compare(case["img"], case["flow"], mode, seed=13)


def test_padded_channels():
    assert [warp_kernel.padded_channels(c) for c in (1, 2, 3, 4, 5, 7, 8, 9, 16, 40)] == [4, 4, 4, 4, 8, 8, 8, 12, 16, 40]


@pytest.mark.parametrize(
    "c,strides,itemsize,address,expected",
    [
        (8, (8 * 64 * 32, 1, 8 * 64, 8), 4, 0, 16),  # channels_last f32, C = 8: whole float4s
        (7, (7 * 64 * 32, 1, 7 * 64, 7), 4, 0, 4),  # C = 7 f32: 28-byte pixels, elements
        (3, (3 * 64 * 32, 1, 3 * 64, 3), 4, 0, 4),
        (2, (2 * 64 * 32, 1, 2 * 64, 2), 4, 0, 8),  # 8-byte pixels
        (8, (8 * 64 * 32, 1, 8 * 64, 8), 2, 0, 16),  # bf16 C = 8
        (4, (4 * 64 * 32, 1, 4 * 64, 4), 2, 0, 8),
        (8, (8 * 64 * 32, 1, 8 * 64, 8), 4, 8, 8),  # an address 8 bytes off 16
        (8, (8 * 64 * 32, 1, 8 * 64, 8), 4, 4, 4),  # a channel slice with an odd start
        (8, (10 * 64 * 32, 1, 10 * 64, 10), 4, 0, 8),  # pixel stride 10 f32: 40 bytes
        (8, (8 * 64 * 32, 64 * 32, 64, 1), 4, 0, 4),  # NCHW planes
        (8, (0, 1, 0, 0), 4, 0, 16),  # expanded over N, H, W
        (8, (0, 0, 0, 0), 4, 0, 4),  # expanded over C too
        (1, (64 * 32, 64 * 32, 64, 1), 4, 0, 4),  # one channel
    ],
)
def test_vector_bytes(c, strides, itemsize, address, expected):
    assert warp_kernel.vector_bytes(c, strides, itemsize, address) == expected


def test_backward_nonfinite_zeros_matches_jax_where_finite():
    case = next(c for c in CASES if c["name"] == "nonfinite")
    flow = case["flow"].copy()
    flow[0, 3, 10, 1] = -np.inf
    _, got_f = _compare(case["img"], flow, "zeros", seed=11)
    assert np.all(got_f[~np.isfinite(flow).all(-1)] == 0.0)


def test_cpu_autograd_through_warp_takes_the_twin():
    """``warp`` on CPU tensors that need a gradient differentiates the twin:
    no kernel wrapper is reached and the gradients equal the plain
    version's."""
    case = next(c for c in CASES if c["name"] == "moderate_amp20")
    img = torch.from_numpy(case["img"]).requires_grad_()
    flow = torch.from_numpy(case["flow"]).requires_grad_()
    g = torch.from_numpy(_out_grad(case["img"], 2))
    before = (warp_kernel.launches, warp_kernel.wide_launches, warp_kernel.backward_launches)
    out = warp(img, flow)
    gi, gf = torch.autograd.grad(out, (img, flow), g)
    ref_i, ref_f = warp_backward_torch(img, flow, g)
    assert (warp_kernel.launches, warp_kernel.wide_launches, warp_kernel.backward_launches) == before
    torch.testing.assert_close(gi, ref_i, rtol=0, atol=0)
    torch.testing.assert_close(gf, ref_f, rtol=0, atol=0)


def test_clip_keeps_the_forward_bits():
    """The twin's border clamp with JAX's derivative gives ``clamp``'s values,
    NaN included."""
    case = next(c for c in CASES if c["name"] == "extreme_x400")
    img, flow = torch.from_numpy(case["img"]), torch.from_numpy(case["flow"]).clone()
    flow[0, 2, 3, 0] = float("nan")
    n, h, w, _ = flow.shape
    sx = torch.arange(w, dtype=torch.float32).view(1, 1, w) + flow[..., 0]
    sy = torch.arange(h, dtype=torch.float32).view(1, h, 1) + flow[..., 1]
    torch.testing.assert_close(_clip(sx, w - 1.0), sx.clamp(0.0, w - 1.0), rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(_clip(sy, h - 1.0), sy.clamp(0.0, h - 1.0), rtol=0, atol=0, equal_nan=True)
    out = warp_torch(img, flow)
    assert torch.isnan(out[0, 2, 3]).all()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_splat_with_grad_goes_through_splat_function_on_cuda(cuda, monkeypatch):
    """A CUDA splat whose input needs a gradient goes through
    ``SplatFunction``: the backward kernel launches and the twin is not
    called; a direct call of the forward wrapper with such an input still
    raises, naming ``softsplat_func``."""
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import softsplat_kernel

    # ops.softsplat is also a function's name in ops/
    softsplat_mod = importlib.import_module("comfyui_frame_interpolation_tpu_torch.ops.softsplat")

    def no_twin(*args):
        raise AssertionError("the twin was called")

    monkeypatch.setattr(softsplat_mod, "softsplat_torch", no_twin)
    vals = torch.rand(1, 8, 8, 3, device=cuda, requires_grad=True)
    flow = torch.rand(1, 8, 8, 2, device=cuda, requires_grad=True)
    before = (softsplat_kernel.launches, softsplat_kernel.backward_launches)
    gi, gf = torch.autograd.grad(softsplat_mod.softsplat_func(vals, flow).sum(), (vals, flow))
    torch.cuda.synchronize()
    assert (softsplat_kernel.launches, softsplat_kernel.backward_launches) == (before[0] + 1, before[1] + 1)
    assert gi.shape == vals.shape and gf.shape == flow.shape
    with pytest.raises(NotImplementedError, match="softsplat_func"):
        softsplat_kernel.softsplat_bilinear(vals.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2))
