"""The port's VFI nodes against the JAX nodes, on the CPU.

The ROADMAP slice-1 gate: both RIFE nodes run on ``demo_frames/anime0.png``
and ``anime1.png`` at multiplier 2 with the same random weights, and the
port's output is held against the JAX node's at >= 40 dB in fp32 (the measure
of the ``rife47_node_vs_torch_psnr_db_*`` rows of ``PSNR_TORCH.json``).

Slice 2: the M2M nodes on a 64x128 crop of the same frames (anime0, anime1,
anime0: two pairs in one batch), x2 and x3, >= 40 dB fp32; the schemas are
equal once the tooltips, which speak of the TPU and of the card, are removed.

Slice 3: the FILM nodes (bisection schedule) on a 128x128 crop of the same
three frames, x2 and x4, >= 40 dB fp32; the schemas as for M2M.

GMFSS Fortuna: the node's schema equals the JAX node's once the
tooltips are removed; the node runs, base and union, from a checkpoint set
written to a temporary ``ckpts_path`` (one file per sub-network, as the
reference ships them) exactly as from the same weights passed as
``params``, and names the first missing file of a set. Its output is held
against JAX by ``tests/test_torch_gmfss.py``.

RIFE arch 4.0 (``sudo_rife4_269.662_testV1_scale1.pth``), both ``fast_mode``
values: the port's node against the JAX node on a 128x256 crop, >= 40 dB.

EISAI: the schema as for GMFSS; the node against the JAX node on a 64x96
crop (two pairs, x2 and x3, 2 RAFT iterations), >= 40 dB fp32; the node runs
from its three files (the RFR weights inside a training container under
``module.flownet.``) exactly as from ``params``, and names the first missing
file.

STMFNet and FLAVR (the 4-frame window executor): the schemas as for GMFSS;
each node runs end to end on the CPU on five demo frames (every eighth
pixel, 68x120; FLAVR edge-pads them to 80x128, centred, and crops back),
with and without doubled first and last frames, at a batch that leaves a
short chunk: the original frames pass bit for bit and each new frame is the
model function's on its window (the models are held against JAX by
``tests/test_torch_stmfnet.py`` and ``tests/test_torch_flavr.py``, the
executor by ``tests/test_torch_loop.py``); each runs from its checkpoint
file as the reference ships it (``stmfnet.pth`` under ``state_dict``,
``FLAVR_2x.pth`` under ``state_dict`` with ``module.``) exactly as from
``params``; multipliers other than 2 warn and go on; fewer than 4 frames
raise.

IFRNet, IFUnet and AMT (the generic timestep schedule, run by the resident
executor): the schemas as for GMFSS (IFUnet's ``ensemble`` defaults to True
in the schema and to False as ``vfi``'s keyword, as in the JAX node); each
node runs end to end on the CPU on three random frames, x2 and x3, at a
batch that leaves a short chunk: the original frames pass bit for bit and
each new frame is the model function's on its pair at its timestep (the
models are held against JAX by ``tests/test_torch_{ifrnet,ifunet,amt}.py``);
AMT edge-pads the clip to multiples of 16, centred, and crops back; each
runs from its checkpoint file exactly as from ``params``, builds its model
function once per params, and needs two frames.

ATM (bisection schedule, 2x only) and XVFI (timestep schedule, pair-cached):
the schemas as for GMFSS (XVFI keeps the reference's ``multipler``); ATM runs
end to end on three random frames with each ``global_motion`` setting, each
new frame the model function's on its pair (which edge-pads to multiples of
64, centred); XVFI runs on them at x2 and x3 (``multiplier`` as an alias),
each new frame the pair functions' at its timestep, Vimeo and X4K (padded to
512x512); ATM runs from a checkpoint that holds the ``attn_mask`` and ``HW``
buffers the node strips, XVFI from one under ``state_dict_Model``, exactly as
from ``params`` (the models are held against JAX by
``tests/test_torch_{atm,xvfi}.py``). The registry lists the twelve ported
nodes with the JAX display names.
"""

import contextlib
import functools
import inspect
import os

import numpy as np
import pytest
import jax
import torch
from PIL import Image

from comfyui_frame_interpolation_tpu.nodes import NODE_DISPLAY_NAME_MAPPINGS as JAX_DISPLAY_NAMES
from comfyui_frame_interpolation_tpu.nodes.rife_node import RIFE_VFI as JaxRIFE
from comfyui_frame_interpolation_tpu.nodes.vfi_nodes import AMT_VFI as JaxAMT
from comfyui_frame_interpolation_tpu.nodes.vfi_nodes import ATM_VFI as JaxATM
from comfyui_frame_interpolation_tpu.nodes.vfi_nodes import EISAI_VFI as JaxEISAI
from comfyui_frame_interpolation_tpu.nodes.vfi_nodes import FILM_VFI as JaxFILM
from comfyui_frame_interpolation_tpu.nodes.vfi_nodes import FLAVR_VFI as JaxFLAVR
from comfyui_frame_interpolation_tpu.nodes.vfi_nodes import GMFSS_Fortuna_VFI as JaxGMFSS
from comfyui_frame_interpolation_tpu.nodes.vfi_nodes import IFRNet_VFI as JaxIFRNet
from comfyui_frame_interpolation_tpu.nodes.vfi_nodes import IFUnet_VFI as JaxIFUnet
from comfyui_frame_interpolation_tpu.nodes.vfi_nodes import M2M_VFI as JaxM2M
from comfyui_frame_interpolation_tpu.nodes.vfi_nodes import STMFNet_VFI as JaxSTMFNet
from comfyui_frame_interpolation_tpu.nodes.vfi_nodes import XVFI_VFI as JaxXVFI
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch import NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS
from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_timestep
from comfyui_frame_interpolation_tpu_torch.core import config as port_config
from comfyui_frame_interpolation_tpu_torch.models import amt as pamt
from comfyui_frame_interpolation_tpu_torch.models import atm as patm
from comfyui_frame_interpolation_tpu_torch.models import eisai as peisai
from comfyui_frame_interpolation_tpu_torch.models import film as pfilm
from comfyui_frame_interpolation_tpu_torch.models import flavr as pflavr
from comfyui_frame_interpolation_tpu_torch.models import gmfss as pgmfss
from comfyui_frame_interpolation_tpu_torch.models import ifrnet as pifrnet
from comfyui_frame_interpolation_tpu_torch.models import ifunet as pifunet
from comfyui_frame_interpolation_tpu_torch.models import m2m as pm2m
from comfyui_frame_interpolation_tpu_torch.models import rife as prife
from comfyui_frame_interpolation_tpu_torch.models import stmfnet as pstmfnet
from comfyui_frame_interpolation_tpu_torch.models import xvfi as pxvfi
from comfyui_frame_interpolation_tpu_torch.nodes.rife_node import RIFE_VFI as PortRIFE
from comfyui_frame_interpolation_tpu_torch.nodes.vfi_nodes import AMT_VFI as PortAMT
from comfyui_frame_interpolation_tpu_torch.nodes.vfi_nodes import ATM_VFI as PortATM
from comfyui_frame_interpolation_tpu_torch.nodes.vfi_nodes import EISAI_VFI as PortEISAI
from comfyui_frame_interpolation_tpu_torch.nodes.vfi_nodes import FILM_VFI as PortFILM
from comfyui_frame_interpolation_tpu_torch.nodes.vfi_nodes import FLAVR_VFI as PortFLAVR
from comfyui_frame_interpolation_tpu_torch.nodes.vfi_nodes import GMFSS_Fortuna_VFI as PortGMFSS
from comfyui_frame_interpolation_tpu_torch.nodes.vfi_nodes import IFRNet_VFI as PortIFRNet
from comfyui_frame_interpolation_tpu_torch.nodes.vfi_nodes import IFUnet_VFI as PortIFUnet
from comfyui_frame_interpolation_tpu_torch.nodes.vfi_nodes import M2M_VFI as PortM2M
from comfyui_frame_interpolation_tpu_torch.nodes.vfi_nodes import STMFNet_VFI as PortSTMFNet
from comfyui_frame_interpolation_tpu_torch.nodes.vfi_nodes import XVFI_VFI as PortXVFI
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "demo_frames")


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def _demo_pair():
    imgs = [Image.open(os.path.join(DEMO, f"anime{i}.png")).convert("RGB") for i in (0, 1)]
    return np.stack([np.asarray(im, np.float32) / 255.0 for im in imgs])


def test_input_types_equal_jax_node():
    assert PortRIFE.INPUT_TYPES() == JaxRIFE.INPUT_TYPES()
    for attr in ("RETURN_TYPES", "FUNCTION", "CATEGORY"):
        assert getattr(PortRIFE, attr) == getattr(JaxRIFE, attr)
    assert NODE_CLASS_MAPPINGS == {
        "RIFE VFI": PortRIFE, "M2M VFI": PortM2M, "FILM VFI": PortFILM, "GMFSS Fortuna VFI": PortGMFSS,
        "EISAI VFI": PortEISAI, "STMFNet VFI": PortSTMFNet, "FLAVR VFI": PortFLAVR,
        "IFRNet VFI": PortIFRNet, "IFUnet VFI": PortIFUnet, "AMT VFI": PortAMT, "ATM VFI": PortATM, "XVFI VFI": PortXVFI,
    }
    assert NODE_DISPLAY_NAME_MAPPINGS == {k: JAX_DISPLAY_NAMES[k] for k in NODE_CLASS_MAPPINGS}


def test_node_matches_jax_node_on_demo_frames():
    frames = _demo_pair()  # 540x960, padded to 576x960 inside the model
    sd = prife.init_params(0, "4.7")
    kw = dict(multiplier=2, fast_mode=True, ensemble=False, batch_size=1)
    (ref,) = JaxRIFE().vfi("rife47.pth", frames, params=to_jax_tree(nest_state_dict(sd)), **kw)
    (got,) = PortRIFE().vfi("rife47.pth", frames, params=sd, device="cpu", **kw)
    ref = np.asarray(ref)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == ref.shape == (3, 540, 960, 3)
    np.testing.assert_array_equal(got.numpy()[[0, 2]], frames)
    assert psnr(got.numpy(), ref) >= 40.0


def test_node_without_params_or_checkpoint_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CFI_TORCH_CONFIG", str(tmp_path / "config.yaml"))
    (tmp_path / "config.yaml").write_text(f"ckpts_path: {tmp_path / 'ckpts'}\n")
    port_config.load_config.cache_clear()
    try:
        with pytest.raises(FileNotFoundError, match="rife47.pth"):
            PortRIFE().vfi("rife47.pth", np.zeros((2, 8, 8, 3), np.float32), device="cpu")
        with pytest.raises(FileNotFoundError, match=r"m2m.M2M\.pth"):
            PortM2M().vfi("M2M.pth", np.zeros((2, 8, 8, 3), np.float32), device="cpu")
        with pytest.raises(FileNotFoundError, match=r"film.film_net_fp32\.pt"):
            PortFILM().vfi("film_net_fp32.pt", np.zeros((2, 8, 8, 3), np.float32), device="cpu")
    finally:
        port_config.load_config.cache_clear()


def test_node_rejects_single_frame_and_unported_arch():
    sd = prife.init_params(0, "4.7")
    with pytest.raises(ValueError, match="at least 2 frames"):
        PortRIFE().vfi("rife47.pth", np.zeros((1, 8, 8, 3), np.float32), params=sd, device="cpu")
    # every arch is ported: a 4.0 checkpoint name given 4.7 weights fails the strict load
    with pytest.raises(RuntimeError, match="Missing key"):
        PortRIFE().vfi(
            "sudo_rife4_269.662_testV1_scale1.pth", np.zeros((2, 8, 8, 3), np.float32), params=sd, device="cpu"
        )


@pytest.mark.parametrize("fast_mode", [True, False])
def test_rife40_node_matches_jax_node_on_demo_crop(fast_mode):
    """``sudo_rife4_269.662_testV1_scale1.pth`` (arch 4.0; ``fast_mode=False``
    adds the Contextnet/Unet refinement) on a 128x256 crop, two pairs in one
    batch."""
    pair = _demo_pair()[:, 200:328, 400:656]
    frames = np.concatenate([pair, pair[:1]])
    sd = prife.init_params(0, "4.0")
    name = "sudo_rife4_269.662_testV1_scale1.pth"
    kw = dict(multiplier=2, fast_mode=fast_mode, ensemble=False, batch_size=2)
    (ref,) = JaxRIFE().vfi(name, frames, params=to_jax_tree(nest_state_dict(sd)), **kw)
    (got,) = PortRIFE().vfi(name, frames, params=sd, device="cpu", **kw)
    ref = np.asarray(ref)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (5, 128, 256, 3)
    np.testing.assert_array_equal(got.numpy()[::2], frames)
    assert psnr(got.numpy(), ref) >= 40.0


def test_node_caches_its_model_fn_per_params():
    sd = prife.init_params(0, "4.7")
    frames = np.random.default_rng(0).random((2, 32, 64, 3), dtype=np.float32)
    node = PortRIFE()
    a = node.vfi("rife47.pth", frames, params=sd, device="cpu", fast_mode=True)[0]
    b = node.vfi("rife47.pth", frames, params=sd, device="cpu", fast_mode=True)[0]
    assert len(node._model_fns) == 1
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    node.vfi("rife47.pth", frames, params=prife.init_params(1, "4.7"), device="cpu", fast_mode=True)
    assert len(node._model_fns) == 2


def _no_tooltips(schema):
    if isinstance(schema, dict):
        return {k: _no_tooltips(v) for k, v in schema.items() if k != "tooltip"}
    if isinstance(schema, (tuple, list)):
        return type(schema)(_no_tooltips(v) for v in schema)
    return schema


def test_m2m_input_types_equal_jax_node_without_tooltips():
    port, ref = PortM2M.INPUT_TYPES(), JaxM2M.INPUT_TYPES()
    assert _no_tooltips(port) == _no_tooltips(ref)
    assert port["required"]["batch_size"][1]["tooltip"] and "TPU" not in str(port)
    for attr in ("RETURN_TYPES", "FUNCTION", "CATEGORY"):
        assert getattr(PortM2M, attr) == getattr(JaxM2M, attr)


def _demo_crop():
    pair = _demo_pair()[:, 200:264, 400:528]
    return np.concatenate([pair, pair[:1]])  # two pairs: 0->1, 1->0


@functools.lru_cache(maxsize=None)
def _m2m_jax_params():
    """One JAX tree for both multipliers, so the JAX node compiles once."""
    return to_jax_tree(nest_state_dict(pm2m.init_params(0)))


@pytest.mark.parametrize("multiplier", [2, 3])
def test_m2m_node_matches_jax_node_on_demo_crop(multiplier):
    frames = _demo_crop()
    sd = pm2m.init_params(0)
    ref = np.asarray(JaxM2M().vfi("M2M.pth", frames, multiplier=multiplier, params=_m2m_jax_params(), batch_size=2)[0])
    (got,) = PortM2M().vfi("M2M.pth", frames, multiplier=multiplier, params=sd, device="cpu", batch_size=2)
    n_out = 2 * multiplier + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (n_out, 64, 128, 3)
    np.testing.assert_array_equal(got.numpy()[::multiplier], frames)
    p = psnr(got.numpy(), ref)
    print(f"M2M node x{multiplier}: port vs JAX {p:.2f} dB")
    assert p >= 40.0


def test_m2m_node_caches_its_pair_fns_per_params():
    sd = pm2m.init_params(0)
    frames = np.random.default_rng(0).random((2, 32, 64, 3), dtype=np.float32)
    node = PortM2M()
    a = node.vfi("M2M.pth", frames, params=sd, device="cpu")[0]
    b = node.vfi("M2M.pth", frames, params=sd, device="cpu")[0]
    assert len(node._pair_fns) == 1
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    node.vfi("M2M.pth", frames, params=pm2m.init_params(1), device="cpu")
    assert len(node._pair_fns) == 2


def test_film_input_types_equal_jax_node_without_tooltips():
    port, ref = PortFILM.INPUT_TYPES(), JaxFILM.INPUT_TYPES()
    assert _no_tooltips(port) == _no_tooltips(ref)
    assert port["required"]["batch_size"][1]["default"] == 2 and "TPU" not in str(port)
    for attr in ("RETURN_TYPES", "FUNCTION", "CATEGORY"):
        assert getattr(PortFILM, attr) == getattr(JaxFILM, attr)


@functools.lru_cache(maxsize=None)
def _film_jax_params():
    """One JAX tree for both multipliers, so the JAX node compiles once."""
    return to_jax_tree(nest_state_dict(pfilm.init_params(0)))


@contextlib.contextmanager
def _no_persistent_jax_cache():
    """The JAX FILM node jits its 34 M weights in as constants; keep that
    ~190 MB program out of the repository's persistent compile cache (JAX
    reads the write threshold at each write; whether the cache is on at all
    it decides once per process)."""
    before = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    try:
        yield
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", before)


@pytest.mark.parametrize("multiplier", [2, 4])
def test_film_node_matches_jax_node_on_demo_crop(multiplier):
    pair = _demo_pair()[:, 200:328, 400:528]
    frames = np.concatenate([pair, pair[:1]])  # two pairs: 0->1, 1->0
    sd = pfilm.init_params(0)
    with _no_persistent_jax_cache():
        ref = JaxFILM().vfi("film_net_fp32.pt", frames, multiplier=multiplier, params=_film_jax_params(), batch_size=2)[0]
    ref = np.asarray(ref)
    (got,) = PortFILM().vfi("film_net_fp32.pt", frames, multiplier=multiplier, params=sd, device="cpu", batch_size=2)
    n_out = 2 * multiplier + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (n_out, 128, 128, 3)
    np.testing.assert_array_equal(got.numpy()[::multiplier], frames)
    p = psnr(got.numpy(), ref)
    print(f"FILM node x{multiplier}: port vs JAX {p:.2f} dB")
    assert p >= 40.0


def test_film_node_caches_its_model_fn_per_params():
    sd = pfilm.init_params(0)
    frames = np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32)
    node = PortFILM()
    a = node.vfi("film_net_fp32.pt", frames, params=sd, device="cpu")[0]
    b = node.vfi("film_net_fp32.pt", frames, params=sd, device="cpu")[0]
    assert len(node._model_fns) == 1
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    node.vfi("film_net_fp32.pt", frames, params=pfilm.init_params(1), device="cpu")
    assert len(node._model_fns) == 2


def test_gmfss_input_types_equal_jax_node_without_tooltips():
    port, ref = PortGMFSS.INPUT_TYPES(), JaxGMFSS.INPUT_TYPES()
    assert _no_tooltips(port) == _no_tooltips(ref)
    assert port["required"]["ckpt_name"][0] == ["GMFSS_fortuna_union", "GMFSS_fortuna"]
    assert port["required"]["batch_size"][1]["default"] == 2 and "TPU" not in str(port)
    assert PortGMFSS.CKPTS_PATH_CONFIG == JaxGMFSS.CKPTS_PATH_CONFIG
    for attr in ("RETURN_TYPES", "FUNCTION", "CATEGORY"):
        assert getattr(PortGMFSS, attr) == getattr(JaxGMFSS, attr)


@contextlib.contextmanager
def _ckpts_path(tmp_path, monkeypatch):
    monkeypatch.setenv("CFI_TORCH_CONFIG", str(tmp_path / "config.yaml"))
    (tmp_path / "config.yaml").write_text(f"ckpts_path: {tmp_path / 'ckpts'}\n")
    port_config.load_config.cache_clear()
    try:
        yield tmp_path / "ckpts"
    finally:
        port_config.load_config.cache_clear()


@pytest.mark.parametrize("name", ["GMFSS_fortuna", "GMFSS_fortuna_union"])
def test_gmfss_node_runs_from_a_checkpoint_set(tmp_path, monkeypatch, name):
    """Each sub-network's weights in its own file under its model type, the
    feature net's keys saved with a ``module.`` prefix (a DataParallel
    save), which the loader strips."""
    union = name.endswith("union")
    sd = pgmfss.init_params(2, union=union)
    with _ckpts_path(tmp_path, monkeypatch) as ckpts:
        for prefix, (model_type, fname) in PortGMFSS.CKPTS_PATH_CONFIG[name].items():
            part = {k[len(prefix) + 1 :]: v for k, v in sd.items() if k.startswith(prefix + ".")}
            if prefix == "feat_ext":
                part = {f"module.{k}": v for k, v in part.items()}
            (ckpts / model_type).mkdir(parents=True, exist_ok=True)
            torch.save(part, str(ckpts / model_type / fname))
        frames = np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32)
        node = PortGMFSS()
        (from_files,) = node.vfi(name, frames, device="cpu")
        (again,) = node.vfi(name, frames, device="cpu")
        (from_params,) = PortGMFSS().vfi(name, frames, params=sd, device="cpu")
    assert len(node._params) == 1 and len(node._pair_fns) == 1  # loaded once, built once
    loaded = node._params[name]
    assert loaded.keys() == sd.keys() and all(torch.equal(loaded[k], sd[k]) for k in sd)
    assert from_files.dtype == torch.float32 and tuple(from_files.shape) == (3, 64, 64, 3)
    np.testing.assert_array_equal(from_files.numpy()[[0, 2]], frames)
    torch.testing.assert_close(from_files, from_params, rtol=0, atol=0)
    torch.testing.assert_close(from_files, again, rtol=0, atol=0)


@pytest.mark.parametrize("name,first", [("GMFSS_fortuna", "GMFSS_fortuna_flownet.pkl"), ("GMFSS_fortuna_union", "rife46.pth")])
def test_gmfss_node_without_its_checkpoint_set_raises(tmp_path, monkeypatch, name, first):
    with _ckpts_path(tmp_path, monkeypatch):
        with pytest.raises(FileNotFoundError, match=first.replace(".", r"\.")):
            PortGMFSS().vfi(name, np.zeros((2, 8, 8, 3), np.float32), device="cpu")


def test_gmfss_node_caches_its_pair_fns_per_params():
    sd = pgmfss.init_params(0)
    frames = np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32)
    node = PortGMFSS()
    a = node.vfi("GMFSS_fortuna", frames, params=sd, device="cpu")[0]
    b = node.vfi("GMFSS_fortuna", frames, params=sd, device="cpu")[0]
    assert len(node._pair_fns) == 1
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    node.vfi("GMFSS_fortuna", frames, params=pgmfss.init_params(1), device="cpu")
    assert len(node._pair_fns) == 2


def test_eisai_input_types_equal_jax_node_without_tooltips():
    port, ref = PortEISAI.INPUT_TYPES(), JaxEISAI.INPUT_TYPES()
    assert _no_tooltips(port) == _no_tooltips(ref)
    assert port["required"]["ckpt_name"][0] == ["eisai"]
    assert port["required"]["batch_size"][1]["default"] == 2 and "TPU" not in str(port)
    for attr in ("RETURN_TYPES", "FUNCTION", "CATEGORY"):
        assert getattr(PortEISAI, attr) == getattr(JaxEISAI, attr)


@functools.lru_cache(maxsize=None)
def _eisai_jax_params():
    """One JAX tree for both multipliers, so the JAX node compiles once."""
    return to_jax_tree(nest_state_dict(peisai.init_params(0)))


@pytest.mark.parametrize("multiplier", [2, 3])
def test_eisai_node_matches_jax_node_on_demo_crop(multiplier):
    pair = _demo_pair()[:, 200:264, 400:496]
    frames = np.concatenate([pair, pair[:1]])  # two pairs: 0->1, 1->0
    jp = _eisai_jax_params()
    ref = JaxEISAI().vfi("eisai", frames, multiplier=multiplier, batch_size=2, iters=2, params=jp)[0]
    ref = np.asarray(ref)
    sd = peisai.init_params(0)
    (got,) = PortEISAI().vfi("eisai", frames, multiplier=multiplier, batch_size=2, iters=2, params=sd, device="cpu")
    n_out = 2 * multiplier + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (n_out, 64, 96, 3)
    np.testing.assert_array_equal(got.numpy()[::multiplier], frames)
    p = psnr(got.numpy(), ref)
    print(f"EISAI node x{multiplier}: port vs JAX {p:.2f} dB")
    assert p >= 40.0


def test_eisai_node_runs_from_its_checkpoint_files(tmp_path, monkeypatch):
    """``eisai_ssl.pt`` and ``eisai_dtm.pt`` raw, the RFR weights inside
    ``eisai_anime_interp_full.ckpt``'s ``model_state_dict`` under
    ``module.flownet.`` beside another sub-network's, as training saved
    them."""
    sd = peisai.init_params(2)
    part = lambda prefix: {k[len(prefix) + 1 :]: v for k, v in sd.items() if k.startswith(prefix + ".")}
    with _ckpts_path(tmp_path, monkeypatch) as ckpts:
        (ckpts / "eisai").mkdir(parents=True)
        torch.save(part("ssl"), str(ckpts / "eisai" / "eisai_ssl.pt"))
        torch.save(part("dtm"), str(ckpts / "eisai" / "eisai_dtm.pt"))
        full = {f"module.flownet.{k}": v for k, v in part("raft").items()}
        full["module.other.weight"] = torch.zeros(3)
        torch.save({"model_state_dict": full, "epoch": 7}, str(ckpts / "eisai" / "eisai_anime_interp_full.ckpt"))
        frames = np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32)
        node = PortEISAI()
        (from_files,) = node.vfi("eisai", frames, iters=1, device="cpu")
        (again,) = node.vfi("eisai", frames, iters=1, device="cpu")
        (from_params,) = PortEISAI().vfi("eisai", frames, iters=1, params=sd, device="cpu")
    assert len(node._pair_fns) == 1  # loaded once, built once
    assert node._params.keys() == sd.keys() and all(torch.equal(node._params[k], sd[k]) for k in sd)
    assert tuple(from_files.shape) == (3, 64, 64, 3)
    np.testing.assert_array_equal(from_files.numpy()[[0, 2]], frames)
    torch.testing.assert_close(from_files, from_params, rtol=0, atol=0)
    torch.testing.assert_close(from_files, again, rtol=0, atol=0)


def test_eisai_node_without_its_files_raises(tmp_path, monkeypatch):
    with _ckpts_path(tmp_path, monkeypatch):
        with pytest.raises(FileNotFoundError, match=r"eisai_ssl\.pt"):
            PortEISAI().vfi("eisai", np.zeros((2, 8, 8, 3), np.float32), device="cpu")


def test_eisai_full_checkpoint_without_flownet_raises(tmp_path, monkeypatch):
    """A full checkpoint with no ``flownet.`` key fails at load, naming the
    file and the part, not later in the strict load."""
    sd = peisai.init_params(2)
    part = lambda prefix: {k[len(prefix) + 1 :]: v for k, v in sd.items() if k.startswith(prefix + ".")}
    with _ckpts_path(tmp_path, monkeypatch) as ckpts:
        (ckpts / "eisai").mkdir(parents=True)
        torch.save(part("ssl"), str(ckpts / "eisai" / "eisai_ssl.pt"))
        torch.save(part("dtm"), str(ckpts / "eisai" / "eisai_dtm.pt"))
        full = {f"module.raft.{k}": v for k, v in part("raft").items()}
        torch.save({"model_state_dict": full}, str(ckpts / "eisai" / "eisai_anime_interp_full.ckpt"))
        with pytest.raises(KeyError, match=r"eisai_anime_interp_full\.ckpt holds no key under flownet\."):
            PortEISAI().vfi("eisai", np.zeros((2, 8, 8, 3), np.float32), device="cpu")


# ---- STMFNet and FLAVR: the window-4 nodes ------------------------------------------------


_WINDOW4 = {
    "stmfnet": (PortSTMFNet, JaxSTMFNet, pstmfnet, "stmfnet.pth", 1),
    "flavr": (PortFLAVR, JaxFLAVR, pflavr, "FLAVR_2x.pth", 2),
}


@pytest.mark.parametrize("family", list(_WINDOW4))
def test_window4_input_types_equal_jax_node_without_tooltips(family):
    port_cls, jax_cls, model, ckpt, batch = _WINDOW4[family]
    port, ref = port_cls.INPUT_TYPES(), jax_cls.INPUT_TYPES()
    assert _no_tooltips(port) == _no_tooltips(ref)
    assert port["required"]["ckpt_name"][0] == model.CKPT_NAMES and ckpt in model.CKPT_NAMES
    assert port["required"]["multiplier"][1] == {"default": 2, "min": 2, "max": 2}
    assert port["required"]["batch_size"][1]["default"] == batch and "TPU" not in str(port)
    for attr in ("RETURN_TYPES", "FUNCTION", "CATEGORY"):
        assert getattr(port_cls, attr) == getattr(jax_cls, attr)


def _seq_frames():
    """``demo_frames/seq/0-4.png`` every eighth pixel, floats ``[5, 68, 120, 3]``."""
    imgs = [Image.open(os.path.join(DEMO, "seq", f"{i}.png")).convert("RGB") for i in range(5)]
    return np.stack([np.asarray(im, np.float32)[::8, ::8] / 255.0 for im in imgs])


@pytest.mark.parametrize("family", list(_WINDOW4))
@pytest.mark.parametrize("dup", [False, True])
def test_window4_node_runs_end_to_end(family, dup):
    port_cls, _, model, ckpt, _ = _WINDOW4[family]
    frames = _seq_frames()
    sd = model.init_params(0)
    (got,) = port_cls().vfi(ckpt, frames, duplicate_first_last_frames=dup, batch_size=2, params=sd, device="cpu")
    # windows 0 and 1 make the frames between 1 and 2 and between 2 and 3:
    # [0, (0), 1, mid, 2, mid, 3, 4, (4)]
    orig, src, new = ([0, 1, 2, 4, 6, 7, 8], [0, 0, 1, 2, 3, 4, 4], [3, 5]) if dup else ([0, 1, 3, 5, 6], [0, 1, 2, 3, 4], [2, 4])
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(orig) + 2, 68, 120, 3)
    np.testing.assert_array_equal(got.numpy()[orig], frames[src])
    # the new frames are the model function's on each window
    x = torch.from_numpy(frames)
    if family == "flavr":  # padded as the node pads the clip: 68x120 to 80x128, centred
        x = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (4, 4, 6, 6), mode="replicate").permute(0, 2, 3, 1)
    fn = model.make_model_fn(sd, device="cpu")
    mids = torch.cat([fn(*(x[i + k : i + k + 1] for k in range(4))) for i in range(2)])
    if family == "flavr":
        mids = mids[:, 6:74, 4:124]
    torch.testing.assert_close(got[new], mids, atol=1e-5, rtol=0)


@pytest.mark.parametrize("family", list(_WINDOW4))
def test_window4_node_runs_from_its_checkpoint_file(family, tmp_path, monkeypatch):
    """``stmfnet.pth`` under ``state_dict``, ``FLAVR_2x.pth`` under
    ``state_dict`` with ``nn.DataParallel``'s ``module.``, as the reference
    loads them (``stmfnet/__init__.py:52``, ``flavr/__init__.py:15-16``)."""
    port_cls, _, model, ckpt, _ = _WINDOW4[family]
    sd = model.init_params(1)
    inner = {f"module.{k}": v for k, v in sd.items()} if family == "flavr" else sd
    frames = _seq_frames()[:4, :32, :48]
    with _ckpts_path(tmp_path, monkeypatch) as ckpts:
        (ckpts / family).mkdir(parents=True)
        torch.save({"state_dict": inner, "epoch": 3}, str(ckpts / family / ckpt))
        node = port_cls()
        (from_file,) = node.vfi(ckpt, frames, device="cpu")
    (from_params,) = port_cls().vfi(ckpt, frames, params=sd, device="cpu")
    assert tuple(from_file.shape) == (5, 32, 48, 3)
    torch.testing.assert_close(from_file, from_params, rtol=0, atol=0)


@pytest.mark.parametrize("family", list(_WINDOW4))
def test_window4_node_warns_on_other_multipliers_and_needs_four_frames(family):
    port_cls, _, model, ckpt, _ = _WINDOW4[family]
    sd = model.init_params(0)
    node = port_cls()
    frames = _seq_frames()[:4, :16, :16]
    with pytest.warns(UserWarning, match="only supports 2x"):
        (out,) = node.vfi(ckpt, frames, multiplier=3, params=sd, device="cpu")
    assert tuple(out.shape) == (5, 16, 16, 3)
    node.vfi(ckpt, frames, params=sd, device="cpu")
    assert len(node._model_fns) == 1  # cached per params, name, dtype and device
    with pytest.raises(ValueError, match="at least 4 frames"):
        node.vfi(ckpt, frames[:3], params=sd, device="cpu")


# ---- IFRNet, IFUnet and AMT: the timestep nodes of this slice --------------------------------


_TIMESTEP = {  # port node, JAX node, model module, checkpoint, params, default batch
    "ifrnet": (PortIFRNet, JaxIFRNet, pifrnet, "IFRNet_S_Vimeo90K.pth", lambda seed: pifrnet.init_params("S", seed), 4),
    "ifunet": (PortIFUnet, JaxIFUnet, pifunet, "IFUNet.pth", pifunet.init_params, 2),
    "amt": (PortAMT, JaxAMT, pamt, "amt-s.pth", lambda seed: pamt.init_params("S", seed), 2),
}


@pytest.mark.parametrize("family", list(_TIMESTEP))
def test_timestep_input_types_equal_jax_node_without_tooltips(family):
    port_cls, jax_cls, _, ckpt, _, batch = _TIMESTEP[family]
    port, ref = port_cls.INPUT_TYPES(), jax_cls.INPUT_TYPES()
    assert _no_tooltips(port) == _no_tooltips(ref)
    assert ckpt in port["required"]["ckpt_name"][0]
    assert port["required"]["batch_size"][1]["default"] == batch and "TPU" not in str(port)
    for attr in ("RETURN_TYPES", "FUNCTION", "CATEGORY"):
        assert getattr(port_cls, attr) == getattr(jax_cls, attr)
    if family == "ifunet":  # the schema's default and the keyword's differ, as in the JAX node
        assert port["required"]["ensemble"] == ("BOOLEAN", {"default": True})
        assert inspect.signature(port_cls.vfi).parameters["ensemble"].default is False
        assert inspect.signature(jax_cls.vfi).parameters["ensemble"].default is False


def _timestep_model_fn(family, sd):
    _, _, model, ckpt, _, _ = _TIMESTEP[family]
    if family == "ifrnet":
        return model.make_model_fn(sd, "S", device="cpu")
    if family == "ifunet":
        return model.make_model_fn(sd, ensemble=True, device="cpu")
    return model.make_model_fn(sd, ckpt, device="cpu")


@pytest.mark.parametrize("family", list(_TIMESTEP))
@pytest.mark.parametrize("multiplier", [2, 3])
def test_timestep_node_runs_end_to_end(family, multiplier):
    """Three random frames of 36x60 (AMT pads them to 48x64, centred), batch
    3: the x3 run's four new frames take a full batch and a short one."""
    port_cls, _, _, ckpt, init, _ = _TIMESTEP[family]
    frames = np.random.default_rng(1).random((3, 36, 60, 3), dtype=np.float32)
    sd = init(0)
    kw = {"ensemble": True} if family == "ifunet" else {}
    (got,) = port_cls().vfi(ckpt, frames, multiplier=multiplier, batch_size=3, params=sd, device="cpu", **kw)
    plan = plan_timestep(3, multiplier)
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(plan.output), 36, 60, 3)
    x = torch.from_numpy(frames)
    if family == "amt":
        x = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (2, 2, 6, 6), mode="replicate").permute(0, 2, 3, 1)
    fn = _timestep_model_fn(family, sd)
    for k, (kind, i) in enumerate(plan.output):
        if kind == "orig":
            np.testing.assert_array_equal(got[k].numpy(), frames[i])
            continue
        task = plan.tasks[i]
        mid = fn(x[task.pair : task.pair + 1], x[task.pair + 1 : task.pair + 2], torch.tensor([task.t]))[0]
        if family == "amt":
            mid = mid[6:42, 2:62]
        torch.testing.assert_close(got[k], mid, atol=1e-5, rtol=0)


@pytest.mark.parametrize("family", list(_TIMESTEP))
def test_timestep_node_runs_from_its_checkpoint_file(family, tmp_path, monkeypatch):
    port_cls, _, _, ckpt, init, _ = _TIMESTEP[family]
    sd = init(1)
    frames = np.random.default_rng(2).random((2, 32, 48, 3), dtype=np.float32)
    with _ckpts_path(tmp_path, monkeypatch) as ckpts:
        (ckpts / port_cls.MODEL_TYPE).mkdir(parents=True)
        torch.save(sd, str(ckpts / port_cls.MODEL_TYPE / ckpt))
        (from_file,) = port_cls().vfi(ckpt, frames, device="cpu")
        with pytest.raises(FileNotFoundError, match=f"{port_cls.MODEL_TYPE} checkpoint"):
            port_cls().vfi(ckpt.replace(".pth", "_missing.pth"), frames, device="cpu")
    (from_params,) = port_cls().vfi(ckpt, frames, params=sd, device="cpu")
    assert tuple(from_file.shape) == (3, 32, 48, 3)
    torch.testing.assert_close(from_file, from_params, rtol=0, atol=0)


@pytest.mark.parametrize("family", list(_TIMESTEP))
def test_timestep_node_caches_its_model_fn_and_needs_two_frames(family):
    port_cls, _, _, ckpt, init, _ = _TIMESTEP[family]
    sd = init(0)
    frames = np.random.default_rng(3).random((2, 16, 32, 3), dtype=np.float32)
    node = port_cls()
    a = node.vfi(ckpt, frames, params=sd, device="cpu")[0]
    b = node.vfi(ckpt, frames, params=sd, device="cpu")[0]
    assert len(node._model_fns) == 1
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    node.vfi(ckpt, frames, params=init(1), device="cpu")
    assert len(node._model_fns) == 2
    with pytest.raises(ValueError, match="at least 2 frames"):
        node.vfi(ckpt, frames[:1], params=sd, device="cpu")


# ---- ATM and XVFI ------------------------------------------------------------------------------------


@pytest.mark.parametrize("port_cls,jax_cls", [(PortATM, JaxATM), (PortXVFI, JaxXVFI)])
def test_atm_xvfi_input_types_equal_jax_node_without_tooltips(port_cls, jax_cls):
    port, ref = port_cls.INPUT_TYPES(), jax_cls.INPUT_TYPES()
    assert _no_tooltips(port) == _no_tooltips(ref)
    assert list(port["required"]) == list(ref["required"])
    assert port["required"]["batch_size"][1]["default"] == 2 and "TPU" not in str(port)
    for attr in ("RETURN_TYPES", "FUNCTION", "CATEGORY"):
        assert getattr(port_cls, attr) == getattr(jax_cls, attr)


def _three_frames(seed=1):
    return np.random.default_rng(seed).random((3, 36, 60, 3), dtype=np.float32)


@pytest.mark.parametrize("global_motion", list(PortATM.GLOBAL_MOTION_SETTINGS))
def test_atm_node_runs_end_to_end(global_motion):
    """Three frames of 36x60 at x2, batch 2 (the model pads each call to
    64x64, centred): the originals pass bit for bit, each new frame is the
    model function's on its pair."""
    frames = _three_frames()
    sd = patm.init_params("lite", 0)
    (got,) = PortATM().vfi("atm-vfi-lite.pt", frames, global_motion=global_motion, params=sd, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 36, 60, 3)
    fn = patm.make_model_fn(sd, "lite", *PortATM.GLOBAL_MOTION_SETTINGS[global_motion], device="cpu")
    x = torch.from_numpy(frames)
    for k in (0, 2, 4):
        np.testing.assert_array_equal(got[k].numpy(), frames[k // 2])
    for k in (1, 3):
        torch.testing.assert_close(got[k], fn(x[k // 2 : k // 2 + 1], x[k // 2 + 1 : k // 2 + 2])[0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("ckpt,multiplier", [
    ("XVFInet_Vimeo_exp1_latest.pt", 2), ("XVFInet_Vimeo_exp1_latest.pt", 3), ("XVFInet_X4K1000FPS_exp1_latest.pt", 2),
])
def test_xvfi_node_runs_end_to_end(ckpt, multiplier):
    """Three frames of 36x60, batch 3 (Vimeo pads them to 48x64, X4K to
    512x512): the originals pass bit for bit, each new frame is the pair
    functions' at its timestep; ``multiplier`` is taken for ``multipler``."""
    frames = _three_frames()
    sd = pxvfi.init_params(ckpt, 0)
    (got,) = PortXVFI().vfi(ckpt, frames, batch_size=3, multiplier=multiplier, params=sd, device="cpu")
    plan = plan_timestep(3, multiplier, zero_drops_pair=False)
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(plan.output), 36, 60, 3)
    reuse, infer = pxvfi.make_pair_fns(sd, ckpt, device="cpu")
    x = torch.from_numpy(frames)
    caches = {}
    for k, (kind, i) in enumerate(plan.output):
        if kind == "orig":
            np.testing.assert_array_equal(got[k].numpy(), frames[i])
            continue
        task = plan.tasks[i]
        f0, f1 = x[task.pair : task.pair + 1], x[task.pair + 1 : task.pair + 2]
        cache = caches.setdefault(task.pair, reuse(f0, f1))
        torch.testing.assert_close(got[k], infer(f0, f1, cache, torch.tensor([task.t]))[0], atol=1e-5, rtol=0)


def test_atm_node_runs_from_a_checkpoint_with_stale_buffers(tmp_path, monkeypatch):
    """``atm-vfi-lite.pt`` as the reference ships it: the state dict under
    ``model_state_dict`` with ``attn_mask`` buffers and an ``HW`` entry, which
    the node strips."""
    sd = patm.init_params("lite", 1)
    stale = {
        **sd, "local_motion_atmformer.0.attn_mask": torch.zeros(4, 64, 64),
        "feat_enhance_transformer.1.attn_mask": torch.zeros(4, 64, 64), "global_motion_atmformer.1.HW": torch.tensor([8, 8]),
    }
    frames = np.random.default_rng(2).random((2, 32, 48, 3), dtype=np.float32)
    with _ckpts_path(tmp_path, monkeypatch) as ckpts:
        (ckpts / "atm").mkdir(parents=True)
        torch.save({"model_state_dict": stale, "epoch": 3}, str(ckpts / "atm" / "atm-vfi-lite.pt"))
        (from_file,) = PortATM().vfi("atm-vfi-lite.pt", frames, device="cpu")
        with pytest.raises(FileNotFoundError, match="atm checkpoint"):
            PortATM().vfi("atm-vfi-base.pt", frames, device="cpu")
    (from_params,) = PortATM().vfi("atm-vfi-lite.pt", frames, params=sd, device="cpu")
    assert tuple(from_file.shape) == (3, 32, 48, 3)
    torch.testing.assert_close(from_file, from_params, rtol=0, atol=0)


def test_xvfi_node_runs_from_a_state_dict_model_checkpoint(tmp_path, monkeypatch):
    ckpt = "XVFInet_Vimeo_exp1_latest.pt"
    sd = pxvfi.init_params(ckpt, 1)
    frames = np.random.default_rng(2).random((2, 32, 48, 3), dtype=np.float32)
    with _ckpts_path(tmp_path, monkeypatch) as ckpts:
        (ckpts / "xvfi").mkdir(parents=True)
        torch.save({"state_dict_Model": sd, "epoch": 3}, str(ckpts / "xvfi" / ckpt))
        (from_file,) = PortXVFI().vfi(ckpt, frames, device="cpu")
    (from_params,) = PortXVFI().vfi(ckpt, frames, params=sd, device="cpu")
    assert tuple(from_file.shape) == (3, 32, 48, 3)
    torch.testing.assert_close(from_file, from_params, rtol=0, atol=0)


@pytest.mark.parametrize("port_cls,ckpt,init", [
    (PortATM, "atm-vfi-lite.pt", lambda seed: patm.init_params("lite", seed)),
    (PortXVFI, "XVFInet_Vimeo_exp1_latest.pt", lambda seed: pxvfi.init_params("XVFInet_Vimeo_exp1_latest.pt", seed)),
])
def test_atm_xvfi_nodes_cache_their_fns_and_need_two_frames(port_cls, ckpt, init):
    sd = init(0)
    frames = np.random.default_rng(3).random((2, 16, 32, 3), dtype=np.float32)
    node = port_cls()
    cache = node._model_fns if port_cls is PortATM else node._pair_fns
    a = node.vfi(ckpt, frames, params=sd, device="cpu")[0]
    b = node.vfi(ckpt, frames, params=sd, device="cpu")[0]
    assert len(cache) == 1
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    node.vfi(ckpt, frames, params=init(1), device="cpu")
    assert len(cache) == 2
    with pytest.raises(ValueError, match="at least 2 frames"):
        node.vfi(ckpt, frames[:1], params=sd, device="cpu")
