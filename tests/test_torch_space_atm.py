"""ATM on the ``space`` axis of the port's ``parallel/`` (rows split over
devices) through ``make_sharded_model_fn`` and ``run_plan``, against the
JAX package's one device and against the port's own one-device runs, on
logical replicas of the CPU.

ATM's Swin blocks hand their row bands over to ``parallel.space``'s rules
(``models.atm._windowed``): each band computes the windows of the padded,
rolled map that hold its own rows, reading their rows from its neighbours
and, under the half-window shift, the rows the roll wraps from the frame's
other end, with those windows' masks, and keeps its own rows. The layer
norms, the token MLPs (``F.linear``, GELU, the depthwise 3x3 through the
convolution rule), the cross-scale fusion's dilated strided convolutions,
the align-corners resizes and the warps (K1 and the wide kernel on each
band from its ``row0``) run on the existing rules; the ensemble's pick of
each sample's scale is a ``torch.where`` (bit for bit the index it
replaces) and its photometric loss a mean over the rows from partial sums.

* ATM lite with global motion on a ``(4, 2)`` mesh, 5 frames x 128x64 f32
  through ``run_plan`` (``plan_timestep(5, 2)``, batch 4: each data shard
  one pair, two bands of 64 rows), against JAX's ``apply`` on one device
  (the weights an argument), clipped as the port's output is, within
  ``tests/test_torch_atm.py``'s 1e-4 (measured 5.8e-6, as the port's one
  device).
* ATM base, global motion off, on and with the ensemble, on a ``(1, 2)``
  mesh at 300x64, which ``make_model_fn`` edge-pads to 320 rows, centred,
  so the bands of 192 + 108 rows become 202 + 118 and the band edge falls
  inside a window row at 1/8 (row 26 of 40, windows of 8) and at 1/16 (row
  13 of 20, padded to 24, windows of 12), in the shifted and the unshifted
  layers alike; in f64 against the port's one device within 1e-6
  (measured 0: ATM's attention runs in f32 in every dtype, and each
  window's f32 sums are the same on a band as on the whole frame). Lite
  with the ensemble on a ``(2, 2)`` mesh at 3 x 256x64 the same way.
* 1080x64 frames with the card's band structure (576 + 504, the centred
  pad to 1088 making them 580 + 508), base with global motion, f64.
* Each ``_windowed`` hand-over alone, ``ATMFormer`` (windows of 8 and 12)
  and ``RefineBottleneck``, shifted and not, on plain f64 tokens cut into
  three uneven bands of 20 and 26 rows (26: the centred pad, and the
  roll's wrap from the last band into the first), bit for bit the whole
  map's; the layer norm and GELU on bands bit for bit, the token linear
  map within 1e-12 (its product rounds otherwise for fewer rows).

One JAX compile (``apply`` at 4 x 128x64, the weights an argument).

``PYTHONPATH=.:tests python tests/test_torch_space_atm.py`` prints the
gaps these tolerances rest on.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.models import atm as ja
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch import parallel
from comfyui_frame_interpolation_tpu_torch.core.loop import run_plan
from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_timestep
from comfyui_frame_interpolation_tpu_torch.models import atm
from comfyui_frame_interpolation_tpu_torch.parallel import space
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

CPU = torch.device("cpu")
JAX_ATOL = 1e-4  # tests/test_torch_atm.py's
F64_ATOL = 1e-6
MODES = {"off": (False, False), "on": (True, False), "ensemble": (True, True)}


def _replicas(n):
    return [CPU] * n


@functools.lru_cache(maxsize=None)
def _params(variant):
    return atm.init_params(variant, 0)


def _make(variant, mode="on", dtype=torch.float32):
    gm, ens = MODES[mode]
    return lambda d: atm.make_model_fn(_params(variant), variant, gm, ens, dtype=dtype, device=d)


def _frames(n, h, w=64, seed=100):
    return np.random.default_rng(seed).random((n, h, w, 3), np.float32)


def _run(frames, make, mesh=None, batch_size=2):
    fn = make(CPU) if mesh is None else parallel.make_sharded_model_fn(make, mesh)
    return run_plan(torch.from_numpy(frames), plan_timestep(len(frames), 2), fn, batch_size=batch_size)


@functools.lru_cache(maxsize=None)
def _jax_one_device():
    """JAX's ``apply`` (lite, global motion) on one device, the 4 pairs of 5
    frames x 128x64 in one batch, clipped."""
    frames = _frames(5, 128)
    fn = jax.jit(lambda p, a, b: jnp.clip(ja.apply(p, a, b, None, variant="lite", global_motion=True), 0.0, 1.0))
    return np.asarray(fn(to_jax_tree(nest_state_dict(_params("lite"))), jnp.asarray(frames[:-1]), jnp.asarray(frames[1:])))


def test_atm_on_a_4x2_mesh_matches_jax_one_device():
    frames = _frames(5, 128)
    mesh = parallel.make_mesh(8, devices=_replicas(8))
    assert dict(mesh.shape) == {"data": 4, "space": 2}
    assert parallel.frame_sharding(mesh, frames.shape).spec == ("data", "space", None, None)
    out = _run(frames, _make("lite"), mesh, batch_size=4)
    assert out.shape == (9, 128, 64, 3)
    np.testing.assert_allclose(out[1::2].numpy(), _jax_one_device(), rtol=0, atol=JAX_ATOL)


def _spied(monkeypatch):
    """The ``_windowed`` hand-overs a run makes: (block, band starts, rows,
    shift)."""
    seen = []
    rule = space._RULES[atm._windowed]

    def spy(func, args, kwargs):
        seen.append((type(args[0]).__name__, args[1].starts, args[1].height, args[2]))
        return rule(func, args, kwargs)

    monkeypatch.setitem(space._RULES, atm._windowed, spy)
    return seen


@pytest.mark.parametrize("mode", list(MODES))
def test_atm_base_whose_windows_cross_the_band_edge_matches_one_device_in_f64(monkeypatch, mode):
    assert space.band_rows(300, 2) == [(0, 192), (192, 108)]
    frames = _frames(2, 300, seed=101)
    ref = _run(frames, _make("base", mode, torch.float64), batch_size=1)
    seen = _spied(monkeypatch)
    out = _run(frames, _make("base", mode, torch.float64), parallel.make_mesh(2, devices=_replicas(2)), batch_size=1)
    local = [("ATMFormer", (0, 26), 40, 0), ("ATMFormer", (0, 26), 40, 4),
             ("RefineBottleneck", (0, 26), 40, 0), ("RefineBottleneck", (0, 26), 40, 4)]
    glob = [("ATMFormer", (0, 13), 20, 0), ("ATMFormer", (0, 13), 20, 6)]
    # the ensemble's global motion at the frame's three scales (1/16 of 320, 160 and 80 rows)
    ens = [("ATMFormer", (0, s), n, sh) for s, n in ((13, 20), (7, 10), (4, 5)) for sh in (0, 6)]
    assert seen == {"off": local, "on": glob + local, "ensemble": ens + local}[mode]
    assert out.shape == ref.shape == (3, 300, 64, 3)
    torch.testing.assert_close(out, ref, rtol=0, atol=F64_ATOL)


def test_atm_lite_with_the_ensemble_on_a_2x2_mesh_matches_one_device_in_f64():
    frames = _frames(3, 256, seed=102)
    mesh = parallel.make_mesh(4, devices=_replicas(4))
    assert dict(mesh.shape) == {"data": 2, "space": 2}
    ref = _run(frames, _make("lite", "ensemble", torch.float64))
    out = _run(frames, _make("lite", "ensemble", torch.float64), mesh)
    assert out.shape == ref.shape == (5, 256, 64, 3)
    torch.testing.assert_close(out, ref, rtol=0, atol=F64_ATOL)


def test_the_chip_phase_band_structure_in_f64():
    assert space.band_rows(1080, 2) == [(0, 576), (576, 504)]
    frames = _frames(2, 1080, seed=103)
    ref = _run(frames, _make("base", "on", torch.float64), batch_size=1)
    out = _run(frames, _make("base", "on", torch.float64), parallel.make_mesh(2, devices=_replicas(2)), batch_size=1)
    assert out.shape == (3, 1080, 64, 3)
    torch.testing.assert_close(out, ref, rtol=0, atol=F64_ATOL)


# ---- each handed-over function alone, band by band ------------------------------------------

SPANS = {20: ((0, 7), (7, 9), (16, 4)), 26: ((0, 9), (9, 10), (19, 7))}


def _bands(x, spans):
    return space.RowBands([x[:, a : a + n] for a, n in spans], [a for a, _ in spans], x.shape[1], 1)


@functools.lru_cache(maxsize=None)
def _net():
    with torch.device("meta"):
        net = atm.ATM("lite")
    net.load_state_dict({k: v.double() for k, v in _params("lite").items()}, strict=True, assign=True)
    return net.eval()


BLOCKS = {
    "ATMFormer, window 8": lambda: _net().local_motion_atmformer[0],
    "ATMFormer, window 12": lambda: _net().global_motion_atmformer[1],
    "RefineBottleneck, window 8": lambda: _net().feat_enhance_transformer[1],
}


@pytest.mark.parametrize("rows", [20, 26])
@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_windowed_block_on_bands_bit_for_bit(block, shifted, rows):
    blk = BLOCKS[block]()
    c = blk.norm1.normalized_shape[0]
    x = torch.from_numpy(np.random.default_rng(rows + 2 * shifted).standard_normal((2, rows, 20, c)))
    shift = blk.window // 2 if shifted else 0
    with torch.no_grad():
        got, whole = atm._windowed(blk, _bands(x, SPANS[rows]), shift), atm._windowed(blk, x, shift)
    assert len(got) == len(whole) == (2 if isinstance(blk, atm.ATMFormer) else 1)
    for g, w in zip(got, whole):
        assert g.starts == tuple(a for a, _ in SPANS[rows])
        assert torch.equal(g.gather(CPU), w)


def test_layer_norm_gelu_and_linear_on_bands():
    blk = _net().local_motion_atmformer[0]
    x = torch.from_numpy(np.random.default_rng(104).standard_normal((2, 20, 12, blk.norm2.normalized_shape[0])))
    with torch.no_grad():
        assert torch.equal(blk.norm2(_bands(x, SPANS[20])).gather(CPU), blk.norm2(x))
        torch.testing.assert_close(blk.mlp.fc1(_bands(x, SPANS[20])).gather(CPU), blk.mlp.fc1(x), rtol=0, atol=1e-12)
        assert torch.equal(F.gelu(_bands(x, SPANS[20])).gather(CPU), F.gelu(x))
    with pytest.raises(NotImplementedError, match="layer_norm over 3 trailing dimensions.*ROADMAP.md Queue 1 item 3"):
        F.layer_norm(_bands(x, SPANS[20]), x.shape[1:])  # over the rows


def _gaps():
    """The gaps behind the tolerances."""
    frames = _frames(5, 128)
    out = {
        "port split (4, 2) vs jax one device": float(np.abs(
            _run(frames, _make("lite"), parallel.make_mesh(8, devices=_replicas(8)), batch_size=4)[1::2].numpy()
            - _jax_one_device()).max()),
        "port one device vs jax one device": float(np.abs(_run(frames, _make("lite"), batch_size=4)[1::2].numpy()
                                                          - _jax_one_device()).max()),
    }
    frames = _frames(2, 300, seed=101)
    for mode in MODES:
        for dtype in (torch.float64, torch.float32):
            ref = _run(frames, _make("base", mode, dtype), batch_size=1)
            got = _run(frames, _make("base", mode, dtype), parallel.make_mesh(2, devices=_replicas(2)), batch_size=1)
            out[f"base {mode} (1, 2) at 300x64 vs one device, {dtype}"] = float((got - ref).abs().max())
    return out


if __name__ == "__main__":
    for k, v in _gaps().items():
        print(k, v, flush=True)
