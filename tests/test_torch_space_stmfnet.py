"""STMFNet on the ``space`` axis of the port's ``parallel/`` (rows split over
devices) through ``make_sharded_model_fn`` and ``run_plan_window4``, against
the JAX package and against the port's own one-device runs, on logical
replicas of the CPU.

STMFNet reflect-pads its frames to multiples of 128 rows at the bottom
(the last band takes the pad), then runs every rule of the axis at once:
grouped and transposed grouped convolutions, eval batch norms, the SE means
over the rows, bilinear resizes with ``align_corners=True`` by 2 and 4 (the
global ratio), the 8-tap upsampler (``stmfnet._upsampler_8tap``, handed
over), AdaCoF against the gathered padded frame (``ops.adacof.adacof_func``,
handed over, each band from its ``row0``), the PWC correlation against the
``+-4`` rows around each band (``ops.correlation.correlation_func``, handed
over), the dilated refiner's halos of up to 32 rows (past a whole band at
1/4 of 128 rows), the masked backwarps (K1 and the wide kernel on a band,
the f32 ones plane a plain source), the ``"softmax"`` splat of both
directions (K2's band partials), the GridNet, and the UNet3d's 3-D
convolutions with the rows on dimension 3.

JAX's own split (``apply`` jitted with the frames sharded over its ``(4,
2)`` virtual mesh by ``frame_sharding``, as JAX's
``parallel.make_sharded_model_fn`` shards it) is 4.4e-4 from JAX's one
device at 128x64, where the PWC's coarsest level holds one row a shard:
its pyramid agrees, its flow at 1/4 is 2.4e-4 off; at 256x64 it agrees
within 8.3e-7 (``ROADMAP.md`` Queue 3; ``PYTHONPATH=.:tests python
tests/test_torch_space_stmfnet.py`` prints the gaps). So the port's split
is held against JAX's one device:

* on a ``(4, 2)`` mesh, 7 frames x 128x64 f32 (padded to 128x128 inside),
  ``plan_window4(7)`` (4 windows at batch 4: each data shard one window,
  two bands of 64 rows), through ``run_plan_window4``, against JAX's
  ``stmfnet.apply`` (the weights an argument) through JAX's
  ``run_plan_window4``: within ``tests/test_parallel.py``'s 1e-4 (measured
  9.2e-7; the port's one device is 8.8e-7 from it);
* on a ``(2, 2)`` mesh at b2 x 136x64 in f64 (``apply`` in f64, f64 out)
  against the port's one device. 136 rows split 128 + 8, and the reflect
  pad to 256 rows puts 120 rows into the 8-row band, which it reads from
  its neighbour: 128 + 128. Within 1e-6: every op runs in f64 but three,
  which sum in f32 in both runs (the correlation's channel sums, AdaCoF's
  tap sums and the splat), in another order on a band; measured 1.9e-8,
  under one f32 ulp of the output (6e-8 between 0.5 and 1);
* on a ``(1, 2)`` mesh at 5 frames x 128x64 f32 through
  ``run_plan_window4`` against the port's one device: within 1e-5
  (measured 6.0e-7: f32 rounding). The plain versions of the hand kernels
  are spied: each of the one device's warps (routed to K1 or the wide
  kernel as the card routes them) is made once on each band, the source
  whole and the flow's rows from the band's first row, and its splat once
  on each band of sources into the whole frame's rows: twice the one
  device's calls.

One JAX compile (the one-device ``apply`` at 128x64).
"""

import functools
import importlib
import os

if __name__ == "__main__":  # JAX's virtual CPU mesh, as tests/conftest.py sets it under pytest
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu import parallel as jparallel
from comfyui_frame_interpolation_tpu.core import plan_window4 as jplan_window4
from comfyui_frame_interpolation_tpu.core import run_plan_window4 as jrun_plan_window4
from comfyui_frame_interpolation_tpu.models import stmfnet as jstmfnet
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch import parallel
from comfyui_frame_interpolation_tpu_torch.core.loop import run_plan_window4
from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_window4
from comfyui_frame_interpolation_tpu_torch.models import stmfnet
from comfyui_frame_interpolation_tpu_torch.ops.cuda import warp_kernel
from comfyui_frame_interpolation_tpu_torch.parallel import space
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

# the modules (``ops`` exports functions of the same names)
softsplat_ops = importlib.import_module("comfyui_frame_interpolation_tpu_torch.ops.softsplat")
warp_ops = importlib.import_module("comfyui_frame_interpolation_tpu_torch.ops.warp")

CPU = torch.device("cpu")
JAX_ATOL = 1e-4  # tests/test_parallel.py:132
F32_ATOL = 1e-5
F64_ATOL = 1e-6


def _replicas(n):
    return [CPU] * n


@functools.lru_cache(maxsize=None)
def _params():
    return stmfnet.init_params(0)


def _make(device):
    return stmfnet.make_model_fn(_params(), device=device)


def _make_f64(device):
    """``stmfnet.apply`` in f64 with f64 out."""
    net = stmfnet._load(_params(), torch.float64, device)

    @torch.inference_mode()
    def model_fn(f0, f1, f2, f3):
        frames = [stmfnet._nchw(f.to(device=device, dtype=torch.float64)) for f in (f0, f1, f2, f3)]
        return stmfnet.apply(net, *frames).permute(0, 2, 3, 1)

    return model_fn


def _frames(n, h, seed):
    return np.random.default_rng(seed).random((n, h, 64, 3), np.float32)


_jax_apply = jax.jit(jstmfnet.apply)


def _jax_sharded(h):
    """JAX's ``apply`` jitted with the frames sharded over its ``(4, 2)``
    virtual mesh by ``frame_sharding`` at b4 x ``h`` x 64 (the weights an
    argument), as JAX's ``parallel.make_sharded_model_fn`` shards a
    window-4 model."""
    jmesh = jparallel.make_mesh(8)
    batch = jparallel.frame_sharding(jmesh, (4, h, 64, 3))
    assert batch.spec == ("data", "space", None, None)
    sharded = jax.jit(
        jstmfnet.apply, in_shardings=(jparallel.replicated(jmesh), batch, batch, batch, batch),
        out_shardings=jparallel.replicated(jmesh),
    )

    def fn(params, *frames):
        with jmesh:
            return sharded(params, *frames)

    return fn


def _jax_run(apply_fn, frames):
    params = to_jax_tree(nest_state_dict(_params()))
    fn = lambda f0, f1, f2, f3: apply_fn(params, f0, f1, f2, f3)  # noqa: E731
    return np.asarray(jrun_plan_window4(jnp.asarray(frames), jplan_window4(len(frames)), fn, batch_size=4))


def _port_4x2(frames):
    mesh = parallel.make_mesh(8, devices=_replicas(8))
    assert dict(mesh.shape) == {"data": 4, "space": 2}
    return run_plan_window4(
        torch.from_numpy(frames), plan_window4(len(frames)), parallel.make_sharded_model_fn(_make, mesh), batch_size=4
    ).numpy()


def test_stmfnet_on_a_4x2_mesh_matches_jax():
    frames = _frames(7, 128, 50)
    ref = _jax_run(_jax_apply, frames)
    out = _port_4x2(frames)
    assert out.shape == ref.shape == (11, 128, 64, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=JAX_ATOL)


def test_stmfnet_on_a_2x2_mesh_matches_one_device_in_f64(monkeypatch):
    """The reflect pad of 120 rows lands in the 8-row band: 128 + 128."""
    pads = []
    rule = space._RULES[torch.nn.functional.pad]

    def spy(func, args, kwargs):
        out = rule(func, args, kwargs)
        if (args[0].height, out.height) == (136, 256):
            pads.append((args[0].starts, out.starts, [b.shape[out.axis] for b in out.bands]))
        return out

    monkeypatch.setitem(space._RULES, torch.nn.functional.pad, spy)
    rng = np.random.default_rng(51)
    f = [torch.from_numpy(rng.random((2, 136, 64, 3))) for _ in range(4)]
    ref = _make_f64(CPU)(*f)
    mesh = parallel.make_mesh(4, devices=_replicas(4))
    assert dict(mesh.shape) == {"data": 2, "space": 2}
    out = parallel.make_sharded_model_fn(_make_f64, mesh)(*f)
    assert pads == [((0, 128), (0, 128), [128, 128])] * 8  # four frames of each data shard
    assert out.shape == ref.shape == (2, 136, 64, 3) and out.dtype == torch.float64
    torch.testing.assert_close(out, ref, rtol=0, atol=F64_ATOL)


def _spied_calls(monkeypatch):
    """The calls of the plain warp and splat, as ``(kernel the card routes
    it to, channels, source rows, band rows, row0, out rows)``."""
    calls = []
    real_warp, real_sums = warp_ops.warp_torch, softsplat_ops._splat_sums

    def warp_spy(img, flow, mode, row0=0):
        planes = img.permute(0, 3, 1, 2)
        kernel = "wide" if warp_kernel.route(planes.shape, planes.stride(), planes.dtype) == "wide" else "narrow"
        calls.append((kernel, img.shape[-1], img.shape[1], flow.shape[1], row0, img.shape[1]))
        return real_warp(img, flow, mode, row0)

    def sums_spy(ten_in, ten_flow, row0, out_rows):
        calls.append(("splat", ten_in.shape[-1], None, ten_in.shape[1], row0, out_rows or ten_in.shape[1]))
        return real_sums(ten_in, ten_flow, row0, out_rows)

    monkeypatch.setattr(warp_ops, "warp_torch", warp_spy)
    monkeypatch.setattr(softsplat_ops, "_splat_sums", sums_spy)
    return calls


def test_stmfnet_on_a_1x2_mesh_matches_one_device(monkeypatch):
    frames = torch.from_numpy(_frames(5, 128, 52))
    plan = plan_window4(5)
    calls = _spied_calls(monkeypatch)
    ref = run_plan_window4(frames, plan, _make(CPU), batch_size=2)
    one = list(calls)
    calls.clear()
    mesh = parallel.make_mesh(2, devices=_replicas(2))
    out = run_plan_window4(frames, plan, parallel.make_sharded_model_fn(_make, mesh), batch_size=2)
    assert out.shape == ref.shape == (7, 128, 64, 3)
    torch.testing.assert_close(out, ref, rtol=0, atol=F32_ATOL)

    want = stmfnet.warps_per_forward(torch.float32)
    counts = lambda cs: {k: sum(c[0] == k for c in cs) for k in ("narrow", "wide", "splat")}  # noqa: E731
    assert counts(one) == {**want, "splat": stmfnet.splats_per_forward()}
    assert counts(calls) == {k: 2 * v for k, v in counts(one).items()}
    # each one-device call made on two bands in turn: the same kernel, width
    # and source rows, the band's rows from its first row, the bands
    # covering the frame's rows
    assert len(calls) == 2 * len(one)
    for whole, (top, bottom) in zip(one, zip(calls[0::2], calls[1::2])):
        kernel, c, src, rows, row0, out_rows = whole
        assert row0 == 0 and rows == out_rows
        for band in (top, bottom):
            assert band[:3] == (kernel, c, src) and band[5] == out_rows
        assert (top[4], bottom[4]) == (0, top[3]) and top[3] + bottom[3] == rows and 0 < top[3] < rows


if __name__ == "__main__":
    # JAX's own split against JAX's one device, and the port's (4, 2) split
    # against both, at 128 and 256 rows (two JAX compiles a height)
    for h in (128, 256):
        frames = _frames(7, h, 50)
        one, split, port = _jax_run(_jax_apply, frames), _jax_run(_jax_sharded(h), frames), _port_4x2(frames)
        gap = lambda a, b: float(np.abs(a - b).max())  # noqa: E731
        print(f"{h}x64: JAX's split from JAX's one device {gap(split, one):.3g}, the port's split from JAX's one device "
              f"{gap(port, one):.3g}, from JAX's split {gap(port, split):.3g}")
