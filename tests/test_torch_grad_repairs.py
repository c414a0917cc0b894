"""Gradients through the three ops that wrote into tensors autograd could not
differentiate, against the JAX package's ``jax.vjp`` on the CPU, and their
inference paths unchanged.

The port computed each of them with writes that autograd refuses:
``ops/correlation.py:correlation_func`` summed into a preallocated output
(``torch.sum(..., out=)``), ``ops/bidir_corr.py:BidirCorr.windowed`` wrote
each band's dots with ``torch.bmm(..., out=)``, and
``models/ifrnet.py:ResBlock.forward`` (IFRNet's, and AMT's decoders') wrote
its side channels in place into a tensor that the convolution's backward
still reads. So a loss through STMFNet, AMT or IFRNet raised where JAX
returns a gradient. Each now takes an out-of-place form when grad mode is on
and an input needs a gradient, and keeps the old form otherwise.

* ``correlation_func``: the gradients of both inputs at 32x64, C = 8 and 65,
  against ``jax.vjp`` of JAX ``ops/correlation.py:correlation_func``, within
  1e-6 of the largest magnitude (81 products a value, summed in another
  order; measured: the values 2.0e-7 apart, the gradients 2.1e-7).
* ``BidirCorr.lookup``: the gradients of both feature maps (each is one
  direction's query and the other's pyramid) and of both coordinate maps
  (through the window's fractions), against ``jax.vjp`` of JAX
  ``models/amt.py:_BidirCorr``'s lookup, with bands of 16 queries and 15,
  16 and 18 queries (both sides of a band edge), and ``test_torch_amt``'s
  12x20 case in one band and in many; within 1e-5 of the largest magnitude
  (the dots and lerps in another order; measured 3.1e-7).
* ``ResBlock``: the gradients of the input and of all its parameters
  against ``jax.vjp`` of JAX ``models/ifrnet.py:_resblock``, within 1e-5 of
  each one's largest magnitude (measured 1.6e-6).
* Inference is unchanged: under ``torch.no_grad()`` each op gives bit for
  bit what its gradient path gives and what the old form gives (kept here as
  ``_old_*``, the parent's code) on ``test_torch_stmfnet``'s and
  ``test_torch_amt``'s cases; and IFRNet S's and AMT S's forwards with a
  gradient give their inference forwards' output bit for bit.

JAX's VJPs run jitted, one compile per shape (eager JAX compiles each op
apart, which took longer).
"""

import functools
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.models import amt as ja
from comfyui_frame_interpolation_tpu.models import ifrnet as ji
from comfyui_frame_interpolation_tpu.ops.correlation import correlation_func as jax_correlation
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch.models import amt as pa
from comfyui_frame_interpolation_tpu_torch.models import ifrnet as pi
from comfyui_frame_interpolation_tpu_torch.ops import bidir_corr
from comfyui_frame_interpolation_tpu_torch.ops.correlation import correlation_func
from comfyui_frame_interpolation_tpu_torch.utils.ckpt import params_from_jax
from test_torch_amt import _corr_case
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)


def _within(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= tol * float(np.abs(ref).max()) + 1e-12, (what, err, float(np.abs(ref).max()))


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


@functools.partial(jax.jit, static_argnums=0)
def _jax_vjp(fn, primals, cotangent):
    """``fn(*primals)`` and its VJP at ``cotangent``, one compile per shape."""
    out, vjp = jax.vjp(fn, *primals)
    return (out, *vjp(cotangent))


def _jax_lookup(f0, f1, c0, c1):
    return ja._BidirCorr(f0, f1).lookup(c0, c1)


def _jax_resblock(p, x):
    return ji._resblock(p, x, 24)


# ---- the old forms (the parent's code), the inference paths' reference ----------------


def _old_correlation(ten_one, ten_two, r=4):
    n, h, w, c = ten_one.shape
    one = ten_one.float()
    padded = F.pad(ten_two.float(), (0, 0, r, r, r, r))
    out = torch.empty((n, h, w, (2 * r + 1) ** 2), dtype=torch.float32, device=ten_one.device)
    for dy in range(2 * r + 1):
        rows = padded[:, dy : dy + h]
        for dx in range(2 * r + 1):
            torch.sum(one * rows[:, :, dx : dx + w], -1, out=out[..., dy * (2 * r + 1) + dx])
    return out.div_(c).to(ten_one.dtype)


def _old_windowed(self, query, pyr, coords):
    b, c, h, w = query.shape
    r, lv = self.radius, pyr.levels
    n, pp = 2 * r + 1, 2 * r + 2
    nq = b * h * w
    dev = query.device
    q_all = query.permute(0, 2, 3, 1).reshape(nq, c).float()
    inv = torch.tensor([2.0**-k for k in range(lv)], device=dev).view(1, lv, 1)
    cl = coords.reshape(nq, 1, 2).float() * inv
    fl = torch.floor(cl)
    t = cl - fl
    bx = fl[..., 0].long() - r
    by = fl[..., 1].long() - r
    hl, wl = pyr.hw[:, 0], pyr.hw[:, 1]
    ok = (bx + n >= 0) & (bx <= wl - 1) & (by + n >= 0) & (by <= hl - 1)
    bx = torch.minimum((bx + pp).clamp_min(0), wl + pp)
    by = torch.minimum((by + pp).clamp_min(0), hl + pp)
    hpad, wpad = hl + 2 * pp, wl + 2 * pp
    bi = (torch.arange(nq, device=dev) // (h * w)).view(-1, 1)
    base = pyr.offsets + (bi * hpad + by) * wpad + bx
    idx = (base[..., None] + torch.arange(pp, device=dev).view(1, 1, pp) * wpad.view(1, lv, 1)).view(-1)
    d = torch.empty((nq, lv * pp * pp, 1), dtype=torch.float32, device=dev)
    band = max(1, bidir_corr.BAND_ELEMENTS // (lv * pp * pp * c))
    for q0 in range(0, nq, band):
        q1 = min(nq, q0 + band)
        patch = pyr.rows.index_select(0, idx[q0 * lv * pp : q1 * lv * pp]).view(q1 - q0, lv * pp * pp, c)
        torch.bmm(patch, q_all[q0:q1, :, None], out=d[q0:q1])
    d = d.view(nq, lv, pp, pp) * ok[..., None, None]
    tx, ty = t[..., 0, None, None], t[..., 1, None, None]
    dy = (1.0 - ty) * d[:, :, :n, :] + ty * d[:, :, 1:, :]
    dxy = (1.0 - tx) * dy[..., :n] + tx * dy[..., 1:]
    out = dxy.transpose(-1, -2).reshape(nq, lv * n * n) * (1.0 / math.sqrt(c))
    return out.view(b, h, w, -1).permute(0, 3, 1, 2).to(query.dtype)


def _old_resblock(self, x):
    s = self.side
    out = self.conv1(x)
    out[:, -s:] = self.conv2(out[:, -s:])
    out = self.conv3(out)
    out[:, -s:] = self.conv4(out[:, -s:])
    return self.prelu(x + self.conv5(out))


# ---- correlation_func ------------------------------------------------------------------


@pytest.mark.parametrize("c", [8, 65])
def test_correlation_gradient_matches_jax_vjp(c):
    rng = np.random.default_rng(c)
    a, b, g = (rng.standard_normal(shape).astype(np.float32) for shape in ((2, 32, 64, c), (2, 32, 64, c), (2, 32, 64, 81)))
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    out = correlation_func(ta, tb)
    ga, gb = torch.autograd.grad(out, (ta, tb), torch.from_numpy(g))
    ref_out, ra, rb = _jax_vjp(jax_correlation, (jnp.asarray(a), jnp.asarray(b)), jnp.asarray(g))
    _within(out.detach().numpy(), ref_out, 1e-6, "correlation")
    _within(ga.numpy(), ra, 1e-6, "correlation: the first input's gradient")
    _within(gb.numpy(), rb, 1e-6, "correlation: the second input's gradient")


@pytest.mark.parametrize("shape", [(2, 7, 9, 5), (1, 12, 10, 32), (2, 32, 64, 8), (2, 32, 64, 65)])
def test_correlation_inference_path_is_unchanged(shape):
    """``test_torch_stmfnet.py::test_correlation``'s shapes and this file's."""
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        plain = correlation_func(a, b)
    graded = correlation_func(a.clone().requires_grad_(), b)
    assert graded.requires_grad
    assert torch.equal(plain, graded.detach())
    assert torch.equal(plain, _old_correlation(a, b))


# ---- BidirCorr.windowed ------------------------------------------------------------------


def _lookup_case(b, h, w, c=8, seed=3):
    """Feature maps and coordinates as ``test_torch_amt``'s ``_corr_case``
    (fractional inside, windows over each edge and wholly outside, integers,
    where the map has room for them), and output gradients."""
    if h * w >= 10:
        f0, f1, (c0, c1) = _corr_case(seed=seed, b=b, h=h, w=w, c=c)
    else:
        rng = np.random.default_rng(seed)
        f0, f1 = (rng.standard_normal((b, h, w, c)).astype(np.float32) for _ in range(2))
        c0, c1 = (np.stack([rng.uniform(-2, w + 1, (b, h, w)), rng.uniform(-2, h + 1, (b, h, w))], -1).astype(np.float32)
                  for _ in range(2))
    rng = np.random.default_rng(seed + 1)
    g0, g1 = (rng.standard_normal((b, h, w, 196)).astype(np.float32) for _ in range(2))
    return f0, f1, c0, c1, g0, g1


@pytest.mark.parametrize(
    "b,h,w,band_queries",
    [(1, 3, 5, 16), (1, 4, 4, 16), (1, 3, 6, 16), (2, 12, 20, None), (2, 12, 20, 16)],
    ids=["15q-band16", "16q-band16", "18q-band16", "12x20-one-band", "12x20-bands16"],
)
def test_corr_lookup_gradients_match_jax_vjp(b, h, w, band_queries, monkeypatch):
    """The lookup's gradients with respect to both feature maps and both
    coordinate maps; ``band_queries`` sets ``BAND_ELEMENTS`` to that many
    queries' patches (C = 8: 2048 elements a query)."""
    if band_queries is not None:
        monkeypatch.setattr(bidir_corr, "BAND_ELEMENTS", band_queries * 4 * 8 * 8 * 8)
    f0, f1, c0, c1, g0, g1 = _lookup_case(b, h, w)
    tf0, tf1 = (_nchw(f).requires_grad_() for f in (f0, f1))
    tc0, tc1 = (torch.from_numpy(c).requires_grad_() for c in (c0, c1))
    o0, o1 = bidir_corr.BidirCorr(tf0, tf1).lookup(tc0, tc1)
    grads = torch.autograd.grad((o0, o1), (tf0, tf1, tc0, tc1), (_nchw(g0), _nchw(g1)))

    (r0, r1), *refs = _jax_vjp(_jax_lookup, tuple(jnp.asarray(x) for x in (f0, f1, c0, c1)), (jnp.asarray(g0), jnp.asarray(g1)))
    _within(o0.detach().permute(0, 2, 3, 1).numpy(), r0, 1e-5, "lookup 0->1")
    _within(o1.detach().permute(0, 2, 3, 1).numpy(), r1, 1e-5, "lookup 1->0")
    for got, ref, what in zip(grads, refs, ("f0", "f1", "coords0", "coords1")):
        got = got.permute(0, 2, 3, 1) if what.startswith("f") else got
        assert float(np.abs(np.asarray(ref)).max()) > 0.0, what
        _within(got.numpy(), ref, 1e-5, f"lookup: {what}'s gradient")


@pytest.mark.parametrize("band,hw", [(None, (12, 20)), (1000, (12, 20)), (None, (3, 5))])
def test_corr_lookup_inference_path_is_unchanged(band, hw, monkeypatch):
    """``test_torch_amt.py::test_corr_lookup_matches_jax``'s cases."""
    if band is not None:
        monkeypatch.setattr(bidir_corr, "BAND_ELEMENTS", band)
    f0, f1, (c0, c1) = _corr_case(h=hw[0], w=hw[1])
    a, b = _nchw(f0), _nchw(f1)
    xy0, xy1 = torch.from_numpy(c0), torch.from_numpy(c1)
    with torch.no_grad():
        corr = bidir_corr.BidirCorr(a, b)
        plain = corr.lookup(xy0, xy1)
        old = (_old_windowed(corr, a, corr.pyr1, xy0), _old_windowed(corr, b, corr.pyr0, xy1))
    graded = bidir_corr.BidirCorr(a.clone().requires_grad_(), b.clone().requires_grad_()).lookup(xy0, xy1)
    for p, g, o in zip(plain, graded, old):
        assert g.requires_grad
        assert torch.equal(p, g.detach()) and torch.equal(p, o)


# ---- ResBlock -------------------------------------------------------------------------------


def _resblock(c=36, side=24, seed=5):
    block = pi.ResBlock(c, side)
    sd = pi.init_state_dict(block, seed)
    block.load_state_dict(sd, strict=True)
    return block.to(memory_format=torch.channels_last), sd


def test_resblock_gradient_matches_jax_vjp():
    block, sd = _resblock()
    rng = np.random.default_rng(6)
    x, g = (rng.standard_normal((2, 16, 24, 36)).astype(np.float32) for _ in range(2))
    tx = _nchw(x).requires_grad_()
    out = block(tx)
    names = [k for k, _ in block.named_parameters()]
    grads = torch.autograd.grad(out, [tx, *block.parameters()], _nchw(g))

    ref_out, rp, rx = _jax_vjp(_jax_resblock, (to_jax_tree(nest_state_dict(sd)), jnp.asarray(x)), jnp.asarray(g))
    flat = {k: v.numpy() for k, v in params_from_jax(rp).items()}
    _within(out.detach().permute(0, 2, 3, 1).numpy(), ref_out, 1e-5, "ResBlock")
    _within(grads[0].permute(0, 2, 3, 1).numpy(), rx, 1e-5, "ResBlock: the input's gradient")
    assert sorted(flat) == sorted(names)
    for k, got in zip(names, grads[1:]):
        _within(got.numpy(), flat[k], 1e-5, f"ResBlock: {k}'s gradient")


def test_resblock_inference_path_is_unchanged():
    block, _ = _resblock()
    x = _nchw(np.random.default_rng(7).standard_normal((2, 16, 24, 36)).astype(np.float32))
    with torch.no_grad():
        plain = block(x)
        old = _old_resblock(block, x)
    graded = block(x)  # the parameters need a gradient
    assert graded.requires_grad
    assert torch.equal(plain, graded.detach()) and torch.equal(plain, old)


@pytest.mark.parametrize("family", ["ifrnet", "amt"])
def test_forward_with_a_gradient_is_the_inference_forward(family):
    """IFRNet S and AMT S at 64x64 (b2, t = 0.3 and 0.7): the forward that
    autograd records gives the inference forward's output bit for bit."""
    if family == "ifrnet":
        net = pi.IFRNet("S")
        net.load_state_dict(pi.init_params("S", 0), strict=True)
        net, apply = net.to(memory_format=torch.channels_last), pi.apply
    else:
        net, apply = pa._load(pa.init_params("S", 0), "S", 3, torch.float32, "cpu"), pa.apply
    rng = np.random.default_rng(8)
    f0, f1 = (torch.from_numpy(rng.random((2, 64, 64, 3), dtype=np.float32)) for _ in range(2))
    t = torch.tensor([0.3, 0.7])
    with torch.no_grad():
        plain = apply(net, f0, f1, t)
    graded = apply(net, f0, f1, t)
    assert graded.requires_grad
    assert torch.equal(plain, graded.detach())
