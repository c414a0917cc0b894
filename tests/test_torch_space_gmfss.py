"""GMFSS Fortuna's pair-cached inference (base and union) on the ``space``
axis of the port's ``parallel/`` (rows split over devices) through
``make_sharded_pair_fns`` and ``run_plan_pair_cached``, against the JAX
package and against the port's own one-device runs, on logical replicas of
the CPU.

GMFlow's transformer, its correlation softmaxes, its flow attention and its
convex upsampling hand their row bands over to ``parallel.space``'s rules:
each band's queries against keys and values gathered whole (the window
attention in the global rows' windows, the shifted layers' roll wrapping
the frame's last rows onto its first whatever the bands), the local
correlation and the 3x3 neighbourhoods with halo rows. The rest (the
encoders' convolutions and instance norms, the warps, the metric net, the
splats on K2's band partials at every width, GridNet) runs on the rules
that were there.

* on a ``(4, 2)`` mesh, 3 frames x 256x128 f32, ``plan_timestep(3, 3)``
  (2 pairs x 2 timesteps, batch 4: each data shard one pair, two bands of
  128 rows), base and union, against JAX's one device: the bodies of JAX's
  ``make_pair_fns`` (``reuse`` and ``inference``, jitted with the weights
  an argument) through JAX's ``run_plan_pair_cached``, within 1e-4
  (measured 5.9e-6 and 8.6e-6; the port's one device is 1.2e-6 and 1.6e-6
  from JAX's);
* on a ``(2, 2)`` mesh, 3 frames x 256x128, ``plan_timestep(3, 2)``, base
  and union in f64 against the port's one device within 1e-6 (the splats
  sum in f32 in both, the bands' partials in another order; ``__main__``
  prints the ``(4, 2)`` mesh's f64 gap: 3.1e-7 and 4.8e-7);
* an uneven split whose windows cross the band edge: 320 x 64 frames on a
  ``(1, 2)`` mesh split 192 + 128, so GMFlow's 1/8 level holds 12 + 8 rows
  of 20 against windows of 10 rows (each shifted layer's windows straddle
  the edge too), in f64 within 1e-6;
* ``chip_smoke.py`` phase 87's band structure, 1080 rows split 576 + 504
  with the zero pad to 1088 in the second band, at 64 columns, in f64
  within 1e-6: on the card its f32 split is ~1e-2 from one device, as far
  as one device moves for its inputs one f32 ulp up (GMFlow's global
  softmax amplifies f32 rounding there);
* each data shard's cache holds row bands (flows, metrics, the feature
  pyramids);
* each handed-over function alone, on plain f64 tensors cut into three
  uneven bands, against its whole-tensor result: the transformer (a
  shifted layer alone first), both correlation softmaxes, both flow
  attention paths and the convex upsampling, within 1e-10.

Three JAX compiles (``reuse``, shared by base and union, whose flow,
metric and feature nets ``init_params`` draws alike, and ``inference`` of
each).

``PYTHONPATH=.:tests python tests/test_torch_space_gmfss.py`` prints the
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

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu import parallel as jparallel
from comfyui_frame_interpolation_tpu.core import plan_timestep as jplan_timestep
from comfyui_frame_interpolation_tpu.core import run_plan_pair_cached as jrun_plan_pair_cached
from comfyui_frame_interpolation_tpu.models import gmfss as jg
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch import parallel
from comfyui_frame_interpolation_tpu_torch.core.loop import run_plan_pair_cached
from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_timestep
from comfyui_frame_interpolation_tpu_torch.models import gmfss
from comfyui_frame_interpolation_tpu_torch.parallel import space
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

CPU = torch.device("cpu")
H, W = 256, 128
JAX_ATOL = 1e-4
F64_ATOL = 1e-6
PARTS_ATOL = 1e-10
_REUSE_NETS = ("flownet", "metricnet", "feat_ext")

_jax_reuse = jax.jit(jg.reuse)
_jax_infer = jax.jit(jg.inference, static_argnames="union")


def _replicas(n):
    return [CPU] * n


@functools.lru_cache(maxsize=None)
def _params(union):
    sd = gmfss.init_params(0, union=union)
    return sd, to_jax_tree(nest_state_dict(sd))


def _make(union, dtype=torch.float32):
    return lambda d: gmfss.make_pair_fns(_params(union)[0], union=union, dtype=dtype, device=d)


def _frames(h=H, w=W, seed=60):
    return np.random.default_rng(seed).random((3, h, w, 3), np.float32)


def _run(frames, make, mesh=None, mids=2, batch_size=4):
    fns = make(CPU) if mesh is None else parallel.make_sharded_pair_fns(make, mesh)
    return run_plan_pair_cached(torch.from_numpy(frames), plan_timestep(3, mids + 1), *fns, batch_size=batch_size)


@functools.lru_cache(maxsize=None)
def _jax_run(union):
    """JAX's one device at 3 x 256x128 (a multiple of 64: no pad), through
    JAX's ``run_plan_pair_cached`` at ``plan_timestep(3, 3)``, batch 4."""
    jp = _params(union)[1]
    reuse_params = {k: jp[k] for k in _REUSE_NETS}

    def reuse_fn(f0, f1):
        return _jax_reuse(reuse_params, f0, f1)

    def infer_fn(f0, f1, cache, t):
        return _jax_infer(jp, f0, f1, cache, t, union=union)

    frames = jnp.asarray(_frames())
    return np.asarray(jrun_plan_pair_cached(frames, jplan_timestep(3, 3), reuse_fn, infer_fn, batch_size=4))


def _stats(got, ref):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    return float(err.mean()), float(np.quantile(err, 0.999)), float(err.max())


@pytest.mark.parametrize("union", [False, True], ids=["base", "union"])
def test_gmfss_on_a_4x2_mesh_matches_jax_one_device(union):
    frames = _frames()
    mesh = parallel.make_mesh(8, devices=_replicas(8))
    assert dict(mesh.shape) == {"data": 4, "space": 2}
    assert parallel.frame_sharding(mesh, frames.shape).spec == ("data", "space", None, None)
    out = _run(frames, _make(union), mesh)
    assert out.shape == (7, H, W, 3)
    np.testing.assert_allclose(out.numpy(), _jax_run(union), rtol=0, atol=JAX_ATOL)


@pytest.mark.parametrize("union", [False, True], ids=["base", "union"])
def test_gmfss_on_a_2x2_mesh_matches_one_device_in_f64(union):
    frames = _frames(seed=61)
    mesh = parallel.make_mesh(4, devices=_replicas(4))
    assert dict(mesh.shape) == {"data": 2, "space": 2}
    ref = _run(frames, _make(union, torch.float64), mids=1, batch_size=2)
    out = _run(frames, _make(union, torch.float64), mesh, mids=1, batch_size=2)
    assert out.shape == ref.shape == (5, H, W, 3) and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=0, atol=F64_ATOL)


def test_uneven_split_whose_windows_cross_the_band_edge(monkeypatch):
    assert space.band_rows(320, 2) == [(0, 192), (192, 128)]
    seen = []
    rule = space._RULES[gmfss._transformer]

    def spy(func, args, kwargs):
        seen.append((args[3], args[1].starts, args[1].height))
        return rule(func, args, kwargs)

    monkeypatch.setitem(space._RULES, gmfss._transformer, spy)
    frames = _frames(320, 64, seed=62)
    ref = _run(frames, _make(False, torch.float64), mids=1, batch_size=1)
    out = _run(frames, _make(False, torch.float64), parallel.make_mesh(2, devices=_replicas(2)), mids=1, batch_size=1)
    # each pair's two directions: 1/8 of the half-resolution frame (12 + 8
    # rows of 20, windows of 10) and 1/4 (24 + 16 of 40, windows of 5)
    assert seen[:2] == [(2, (0, 12), 20), (8, (0, 24), 40)]
    assert len(seen) == 8
    torch.testing.assert_close(out, ref, rtol=0, atol=F64_ATOL)


def test_the_chip_phase_band_structure_in_f64():
    assert space.band_rows(1080, 2) == [(0, 576), (576, 504)]
    frames = _frames(1080, 64, seed=63)[:2]
    mesh = parallel.make_mesh(2, devices=_replicas(2))
    ref = run_plan_pair_cached(torch.from_numpy(frames), plan_timestep(2, 2), *_make(False, torch.float64)(CPU), batch_size=1)
    out = run_plan_pair_cached(
        torch.from_numpy(frames), plan_timestep(2, 2), *parallel.make_sharded_pair_fns(_make(False, torch.float64), mesh),
        batch_size=1,
    )
    assert out.shape == (3, 1080, 64, 3)
    torch.testing.assert_close(out, ref, rtol=0, atol=F64_ATOL)


def test_gmfss_cache_holds_row_bands():
    f = torch.from_numpy(_frames()[:2])
    reuse, _ = parallel.make_sharded_pair_fns(_make(False), parallel.make_mesh(2, devices=_replicas(2)))
    (cache,) = reuse(f, f.flip(1))
    flow01, flow10, metric0, metric1, feat1, feat2 = cache
    leaves = [flow01, flow10, metric0, metric1, *feat1, *feat2]
    assert all(isinstance(v, space.RowBands) and v.axis == 1 for v in leaves)
    assert flow01.starts == metric0.starts == (0, 64) and flow01.height == H // 2
    assert [v.starts for v in feat1] == [(0, 64), (0, 32), (0, 16)]


# ---- each handed-over function alone, band by band ------------------------------------------

SPANS = ((0, 7), (7, 9), (16, 4))  # three uneven bands of 20 rows


def _bands(x, spans=SPANS):
    return space.RowBands([x[:, a : a + n] for a, n in spans], [a for a, _ in spans], x.shape[1], 1)


def _nhwc(seed, c, h=20, w=12, b=2, scale=1.0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((b, h, w, c)) * scale)


@functools.lru_cache(maxsize=None)
def _net():
    return gmfss._load(_params(False)[0], False, torch.float64, CPU).flownet


def _close(got, ref):
    got = got.gather(CPU) if isinstance(got, space.RowBands) else got
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=0, atol=PARTS_ATOL)


@pytest.mark.parametrize("with_shift", [False, True], ids=["plain", "shifted"])
def test_one_window_attention_layer_on_bands(with_shift):
    """One transformer layer's window attention, each band's queries against
    the whole frame's keys, a shifted layer's windows wrapping the frame's
    last rows onto its first."""
    h, w, c, splits = 20, 12, 128, 2
    q, k, v = (_nhwc(s, c).reshape(2, -1, c) for s in (1, 2, 3))
    mask = gmfss.shift_window_mask(h, w, splits, CPU, torch.float64)
    whole = gmfss._window_attention(q, k, v, h, w, splits, with_shift, mask)
    parts = [
        gmfss._window_attention(q[:, a * w : (a + n) * w], k, v, h, w, splits, with_shift, mask, row0=a) for a, n in SPANS
    ]
    _close(torch.cat(parts, 1), whole)


@pytest.mark.parametrize("splits", [2, 4])
def test_transformer_on_bands(splits):
    f0, f1 = _nhwc(4, 128), _nhwc(5, 128)
    whole = gmfss._transformer(_net().transformer, f0, f1, splits)
    got = gmfss._transformer(_net().transformer, _bands(f0), _bands(f1), splits)
    for g, r in zip(got, whole):
        _close(g, r)


def test_correlation_softmaxes_on_bands():
    f0, f1 = _nhwc(6, 128), _nhwc(7, 128)
    _close(gmfss._global_corr_softmax(_bands(f0), _bands(f1)), gmfss._global_corr_softmax(f0, f1))
    _close(gmfss._local_corr_softmax(_bands(f0), _bands(f1), 4), gmfss._local_corr_softmax(f0, f1, 4))


@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
def test_flow_attention_on_bands(local):
    feat, flow = _nhwc(8, 128), _nhwc(9, 2, scale=3.0)
    p = _net().feature_flow_attn
    _close(gmfss._flow_attn(p, _bands(feat), _bands(flow), local), gmfss._flow_attn(p, feat, flow, local))


def test_convex_upsample_on_bands():
    flow, feat = _nhwc(10, 2, scale=3.0), _nhwc(11, 128)
    p = _net().upsampler
    got = gmfss._convex_upsample4(p, _bands(flow), _bands(feat))
    assert got.starts == (0, 28, 64) and got.height == 80
    _close(got, gmfss._convex_upsample4(p, flow, feat))


def _gaps():
    """The gaps behind the tolerances: the port's split against JAX's one
    device (mean, 99.9 % quantile, max) and against the port's one device
    in f32 and f64, base and union; JAX's own split (``make_pair_fns``
    through JAX's ``make_sharded_pair_fns`` on its ``(4, 2)`` virtual mesh)
    against JAX's one device."""
    frames = _frames()
    mesh = parallel.make_mesh(8, devices=_replicas(8))
    out = {}
    for union in (False, True):
        name = "union" if union else "base"
        jsplit = jparallel.make_sharded_pair_fns(*jg.make_pair_fns(_params(union)[1], union=union), jparallel.make_mesh(8))
        jax_split = np.asarray(jrun_plan_pair_cached(jnp.asarray(frames), jplan_timestep(3, 3), *jsplit, batch_size=4))
        out[f"{name}: jax split vs jax one device"] = _stats(jax_split, _jax_run(union))
        split = _run(frames, _make(union), mesh).numpy()
        one = _run(frames, _make(union)).numpy()
        out[f"{name}: port split vs jax one device"] = _stats(split, _jax_run(union))
        out[f"{name}: port one device vs jax one device"] = _stats(one, _jax_run(union))
        out[f"{name}: port split vs port one device, f32"] = float(np.abs(split - one).max())
        f64 = [_run(frames, _make(union, torch.float64), m).numpy() for m in (None, mesh)]
        out[f"{name}: port split vs port one device, f64"] = float(np.abs(f64[1] - f64[0]).max())
    return out


if __name__ == "__main__":
    for k, v in _gaps().items():
        print(k, v, flush=True)
