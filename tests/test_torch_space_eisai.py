"""EISAI's pair-cached inference on the ``space`` axis of the port's
``parallel/`` (rows split over devices) through ``make_sharded_pair_fns``
and ``run_plan_pair_cached``, against the JAX package and against the
port's own one-device runs, on logical replicas of the CPU.

RAFT's all-pairs correlation (``_corr_pyramid`` and ``_corr_lookup``),
its convex upsampling and the distance transform (``ops.edt.batch_edt``)
hand their row bands over to ``parallel.space``'s rules: each band's
queries against the target gathered whole, the y pass of the distance
transform on the x pass gathered whole, a halo row for the 3x3 taps. The
max pools (the opening's and the ResNet's) take halo rows padded with -inf
at the frame's edges only; the resizes to the frame's sizes (``_prep8``,
the ResNet's 256 rows, the flows to each feature size) take the non-integer
ratio rule, and the strided encoders own their outputs by the middle rows.

* on a ``(4, 2)`` mesh, 3 frames x 256x128 f32, ``plan_timestep(3, 3)``
  (2 pairs x 2 timesteps, batch 4), 2 RAFT iterations, against JAX's one
  device (the bodies of JAX's ``make_pair_fns``, jitted with the weights
  an argument, through JAX's ``run_plan_pair_cached``) within 1e-4;
* on a ``(2, 2)`` mesh at 256x128, ``plan_timestep(3, 2)``, in f64
  against the port's one device within 1e-6. EISAI keeps RAFT's
  correlation and update block, the Lab metric, the edge maps and the
  splats in f32 in every dtype, so its "f64" run still rounds there;
* 140 x 64 frames (not a multiple of 8: ``_prep8`` resizes them to 136
  rows) split 128 + 12 on a ``(1, 2)`` mesh, in f64: the flows of
  ``reuse`` within 1e-6 of one device's, and ``infer`` on the split's
  flows within 1e-6 of one device's ``infer`` on the same flows, with the
  re-bands counted. The whole run is held in these two halves: ``infer``
  amplifies the f32 rounding that RAFT's update block leaves between the
  two runs' flows past 1e-6, as it does for one device alone;
* each data shard's cache holds both flows as row bands;
* each handed-over function alone, on plain tensors cut into three uneven
  bands, against its whole-tensor result: the correlation pyramid and its
  lookup (at plain and banded coordinates), the convex upsampling, the
  max pools (stride 1 after a -inf pad, and 3x3 stride 2 padded by 1) and
  ``batch_edt``, the last two bit for bit.

Two JAX compiles (``reuse`` and ``infer`` at 256x128).

``PYTHONPATH=.:tests python tests/test_torch_space_eisai.py`` prints the
gaps these tolerances rest on.
"""

import functools
import os

if __name__ == "__main__":  # JAX's virtual CPU mesh, as tests/conftest.py sets it under pytest
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu import parallel as jparallel
from comfyui_frame_interpolation_tpu.core import plan_timestep as jplan_timestep
from comfyui_frame_interpolation_tpu.core import run_plan_pair_cached as jrun_plan_pair_cached
from comfyui_frame_interpolation_tpu.models import eisai as je
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch import parallel
from comfyui_frame_interpolation_tpu_torch.core.loop import run_plan_pair_cached
from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_timestep
from comfyui_frame_interpolation_tpu_torch.models import eisai
from comfyui_frame_interpolation_tpu_torch.ops.edt import batch_edt
from comfyui_frame_interpolation_tpu_torch.parallel import space
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

CPU = torch.device("cpu")
H, W = 256, 128
ITERS = 2
JAX_ATOL = 1e-4
F64_ATOL = 1e-6
REBANDS = 14  # in one infer call of the uneven split


def _replicas(n):
    return [CPU] * n


@functools.lru_cache(maxsize=None)
def _params():
    sd = eisai.init_params(0)
    return sd, to_jax_tree(nest_state_dict(sd))


def _make(dtype=torch.float32):
    return lambda d: eisai.make_pair_fns(_params()[0], dtype=dtype, device=d, iters=ITERS)


def _frames(h=H, w=W, seed=70):
    return np.random.default_rng(seed).random((3, h, w, 3), np.float32)


def _run(frames, make, mesh=None, mids=2, batch_size=4):
    fns = make(CPU) if mesh is None else parallel.make_sharded_pair_fns(make, mesh)
    return run_plan_pair_cached(torch.from_numpy(frames), plan_timestep(3, mids + 1), *fns, batch_size=batch_size)


@jax.jit
def _jax_reuse(p, f0, f1):
    """The body of JAX ``make_pair_fns``'s ``reuse_fn``, weights an argument."""
    return je.raft_flow(p["raft"], f0, f1, iters=ITERS), je.raft_flow(p["raft"], f1, f0, iters=ITERS)


@jax.jit
def _jax_infer(p, f0, f1, cache, t):
    """The body of JAX ``make_pair_fns``'s ``infer_fn``, weights an argument."""
    out_ssl, locs = je.ssl_forward(p["ssl"], f0, f1, cache[0], cache[1], t=t.reshape(-1, 1, 1, 1))
    return je.dtm_forward(p["dtm"], out_ssl, locs)[..., :3]


@functools.lru_cache(maxsize=None)
def _jax_run():
    jp = _params()[1]
    fns = (lambda f0, f1: _jax_reuse(jp, f0, f1)), (lambda f0, f1, c, t: _jax_infer(jp, f0, f1, c, t))
    return np.asarray(jrun_plan_pair_cached(jnp.asarray(_frames()), jplan_timestep(3, 3), *fns, batch_size=4))


def test_eisai_on_a_4x2_mesh_matches_jax_one_device():
    frames = _frames()
    mesh = parallel.make_mesh(8, devices=_replicas(8))
    assert dict(mesh.shape) == {"data": 4, "space": 2}
    assert parallel.frame_sharding(mesh, frames.shape).spec == ("data", "space", None, None)
    out = _run(frames, _make(), mesh)
    assert out.shape == (7, H, W, 3)
    np.testing.assert_allclose(out.numpy(), _jax_run(), rtol=0, atol=JAX_ATOL)


def test_eisai_on_a_2x2_mesh_matches_one_device_in_f64():
    frames = _frames(seed=71)
    mesh = parallel.make_mesh(4, devices=_replicas(4))
    assert dict(mesh.shape) == {"data": 2, "space": 2}
    ref = _run(frames, _make(torch.float64), mids=1, batch_size=2)
    out = _run(frames, _make(torch.float64), mesh, mids=1, batch_size=2)
    assert out.shape == ref.shape == (5, H, W, 3) and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=0, atol=F64_ATOL)


def test_rows_not_a_multiple_of_8_split_unevenly():
    assert space.band_rows(140, 2) == [(0, 128), (128, 12)]
    f0, f1 = (torch.from_numpy(f[None]).double() for f in _frames(140, 64, seed=72)[:2])
    t = torch.tensor([0.5])
    one_reuse, one_infer = _make(torch.float64)(CPU)
    reuse, infer = parallel.make_sharded_pair_fns(_make(torch.float64), parallel.make_mesh(2, devices=_replicas(2)))
    ref = one_reuse(f0, f1)
    (cache,) = reuse(f0, f1)
    for got, want in zip(cache, ref):
        assert isinstance(got, space.RowBands)
        torch.testing.assert_close(got.gather(CPU), want, rtol=0, atol=F64_ATOL)
    space.rebands = space.rows_moved = 0
    out = infer(f0, f1, (cache,), t)
    # the flows come back from reuse with their second band from row 131 (8
    # x the 1/8 level's 16 rows of 17, 128 of 136, resized to 140) and meet
    # the frames' bands from row 128 in the Lab metric, the splats (the
    # ResNet levels' too) and the channel cats: each is re-banded there
    assert space.rebands == REBANDS and space.rows_moved > 0, (space.rebands, space.rows_moved)
    torch.testing.assert_close(out, one_infer(f0, f1, tuple(c.gather(CPU) for c in cache), t), rtol=0, atol=F64_ATOL)


def test_eisai_cache_holds_row_bands():
    f = torch.from_numpy(_frames()[:2])
    reuse, _ = parallel.make_sharded_pair_fns(_make(), parallel.make_mesh(2, devices=_replicas(2)))
    (cache,) = reuse(f, f.flip(1))
    assert len(cache) == 2 and all(isinstance(v, space.RowBands) and v.axis == 1 for v in cache)
    assert all(tuple(v.shape) == (2, H, W, 2) and v.starts == (0, 128) for v in cache)


# ---- each handed-over function alone, band by band ------------------------------------------

SPANS = ((0, 7), (7, 9), (16, 4))  # three uneven bands of 20 rows


def _bands(x, spans=SPANS):
    """NCHW ``x`` cut into row bands."""
    return space.RowBands([x[:, :, a : a + n] for a, n in spans], [a for a, _ in spans], x.shape[2], 2)


def _nchw(seed, c, h=20, w=12, b=2, scale=1.0, dtype=torch.float64):
    return (torch.from_numpy(np.random.default_rng(seed).standard_normal((b, c, h, w))) * scale).to(dtype)


def _gathered(x):
    return x.gather(CPU) if isinstance(x, space.RowBands) else x


@pytest.mark.parametrize("banded_coords", [False, True], ids=["plain coords", "banded coords"])
def test_correlation_pyramid_and_lookup_on_bands(banded_coords):
    f1, f2 = _nchw(1, 32), _nchw(2, 32)
    coords = eisai._coords_grid(2, 20, 12, CPU) + _nchw(3, 2, scale=2.0, dtype=torch.float32)
    whole = eisai._corr_lookup(eisai._corr_pyramid(f1, f2), coords)
    pyr = eisai._corr_pyramid(_bands(f1), _bands(f2))
    got = eisai._corr_lookup(pyr, _bands(coords) if banded_coords else coords)
    assert isinstance(got, space.RowBands) and got.starts == (0, 7, 16)
    # f32 dots of each band's queries: rounding apart from the whole product
    torch.testing.assert_close(got.gather(CPU), whole, rtol=0, atol=1e-5 * float(whole.abs().max()))


def test_convex_upsample_flow_on_bands():
    flow, mask = _nchw(4, 2, scale=3.0), _nchw(5, 576)
    got = eisai._convex_upsample_flow(_bands(flow), _bands(mask))
    assert got.starts == (0, 56, 128) and got.height == 160
    torch.testing.assert_close(got.gather(CPU), eisai._convex_upsample_flow(flow, mask), rtol=0, atol=1e-10)


def test_max_pools_on_bands():
    x = _nchw(6, 3)
    opened = eisai._morph_open(_bands(x), 5)
    assert torch.equal(opened.gather(CPU), eisai._morph_open(x, 5))
    pooled = F.max_pool2d(_bands(x), 3, 2, 1)
    assert pooled.starts == (0, 4, 8) and torch.equal(pooled.gather(CPU), F.max_pool2d(x, 3, 2, 1))
    assert torch.equal(F.max_pool2d(_bands(x), 3, 1).gather(CPU), F.max_pool2d(x, 3, 1))


@pytest.mark.parametrize("dims", [3, 4])
def test_batch_edt_on_bands_bit_for_bit(dims):
    edges = (torch.from_numpy(np.random.default_rng(7).random((2, 1, 20, 12))) > 0.93).float()
    edges[1] = 0.0  # an empty map: the diameter everywhere
    x = edges if dims == 4 else edges[:, 0]
    axis = dims - 2
    bands = space.RowBands([x.narrow(axis, a, n) for a, n in SPANS], [a for a, _ in SPANS], 20, axis)
    got = batch_edt(bands)
    assert isinstance(got, space.RowBands) and got.starts == (0, 7, 16)
    assert torch.equal(got.gather(CPU), batch_edt(x))


def test_channel_ops_on_bands():
    """The Lab metric's channel norm and the flows' channel flip."""
    x = _nchw(8, 3)
    assert torch.equal(torch.linalg.vector_norm(_bands(x), dim=1, keepdim=True).gather(CPU),
                       torch.linalg.vector_norm(x, dim=1, keepdim=True))
    assert torch.equal(_bands(x).flip(1).gather(CPU), x.flip(1))
    with pytest.raises(NotImplementedError, match="over the rows"):
        torch.linalg.vector_norm(_bands(x), dim=2)


def _gaps():
    """The gaps behind the tolerances: the port's split and one device
    against JAX's one device, and the split against the port's one device
    in f32 and f64; JAX's own split (``make_pair_fns`` through JAX's
    ``make_sharded_pair_fns`` on its ``(4, 2)`` virtual mesh) against JAX's
    one device."""
    frames = _frames()
    jsplit = jparallel.make_sharded_pair_fns(*je.make_pair_fns(_params()[1], iters=ITERS), jparallel.make_mesh(8))
    jax_split = np.asarray(jrun_plan_pair_cached(jnp.asarray(frames), jplan_timestep(3, 3), *jsplit, batch_size=4))
    mesh = parallel.make_mesh(8, devices=_replicas(8))
    split, one = _run(frames, _make(), mesh).numpy(), _run(frames, _make()).numpy()
    f64 = [_run(frames, _make(torch.float64), m).numpy() for m in (None, mesh)]
    gap = lambda a, b: float(np.abs(a - b).max())  # noqa: E731
    return {
        "jax split vs jax one device": gap(jax_split, _jax_run()),
        "port split vs jax one device": gap(split, _jax_run()),
        "port one device vs jax one device": gap(one, _jax_run()),
        "port split vs port one device, f32": gap(split, one),
        "port split vs port one device, f64": gap(*f64),
    }


if __name__ == "__main__":
    for k, v in _gaps().items():
        print(k, v, flush=True)
