"""The port's checkpoint utilities and profiler hook, on the CPU.

* ``utils.download``: mirrors made ``file://`` URLs in a temporary directory
  (nothing leaves the machine). The first mirror lacks the file and the
  second has it: the download fails over, lands through ``<name>.part``
  renamed once complete, writes ``<name>.npz``, and a second call returns
  the same dict without reading anything; with the file and the memory
  cache gone, the ``.npz`` serves. A file no mirror has raises
  ``FileNotFoundError`` naming the path to put it at, and leaves no
  ``.part``. ``load_file_from_direct_url`` downloads once, and a URL that
  fails raises ``FileNotFoundError`` naming the path; the AMT node, given
  no checkpoint, asks for the JAX node's Hugging Face URL.
* ``.npz`` interchange: a file of the JAX ``save_npz`` loads in the port
  key for key, and the port's in the JAX ``load_npz``.
* The conversion CLI on a ``state_dict`` container with ``module.`` keys,
  to an explicit ``.npz`` and to the default path; any other destination
  is refused.
* ``utils.profiling.maybe_profile``: under ``CFI_PROFILE`` an executor run
  writes one Chrome trace under ``<dir>/run_plan`` (a nested region starts
  no second trace); unset, it never calls the profiler.
* Every node that reads a checkpoint, given none, loads it through the
  downloader's cache and builds its model once over two calls (the model
  builders replaced by counting stubs; the files hold a placeholder
  tensor).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from comfyui_frame_interpolation_tpu.utils import ckpt as jckpt
from comfyui_frame_interpolation_tpu_torch.core import config as port_config
from comfyui_frame_interpolation_tpu_torch.core.loop import run_plan
from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_timestep
from comfyui_frame_interpolation_tpu_torch.models import (
    amt, atm, cain, eisai, film, flavr, gmfss, ifrnet, ifunet, m2m, momo, rife, sepconv, stmfnet, xvfi,
)
from comfyui_frame_interpolation_tpu_torch.nodes import rife_node, vfi_nodes
from comfyui_frame_interpolation_tpu_torch.utils import ckpt, download, profiling
from torch_offline import no_downloads  # noqa: F401  (autouse: no download leaves the machine)
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def ckpts(tmp_path, monkeypatch):
    """A temporary ``ckpts_path`` (through ``CFI_TORCH_CONFIG``), file
    mirrors only, and an empty memory cache."""
    monkeypatch.setenv("CFI_TORCH_CONFIG", str(tmp_path / "config.yaml"))
    (tmp_path / "config.yaml").write_text(f"ckpts_path: {tmp_path / 'ckpts'}\n")
    monkeypatch.setattr(download, "BASE_MODEL_DOWNLOAD_URLS", [(tmp_path / "m1").as_uri() + "/", (tmp_path / "m2").as_uri() + "/"])
    monkeypatch.setattr(download, "CKPT_FALLBACK_URLS", {})
    monkeypatch.setattr(download, "_params_memcache", {})
    port_config.load_config.cache_clear()
    yield tmp_path / "ckpts"
    port_config.load_config.cache_clear()


def _sd(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"block.conv.weight": torch.randn(4, 3, 3, 3, generator=g), "block.conv.bias": torch.randn(4, generator=g)}


def test_download_fails_over_renames_the_part_and_caches(ckpts, tmp_path, monkeypatch):
    (tmp_path / "m2").mkdir()
    torch.save({"state_dict": _sd()}, str(tmp_path / "m2" / "X.pth"))
    fetched, renamed = [], []
    real_retrieve, real_replace = download.urllib.request.urlretrieve, os.replace

    def retrieve(url, dest):
        fetched.append((url, os.path.basename(dest)))
        return real_retrieve(url, dest)

    def replace(src, dst):
        renamed.append((os.path.basename(src), os.path.basename(dst)))
        return real_replace(src, dst)

    monkeypatch.setattr(download.urllib.request, "urlretrieve", retrieve)
    monkeypatch.setattr(download.os, "replace", replace)
    sd = download.get_converted_params("thing", "X.pth")
    assert [os.path.basename(os.path.dirname(u)) for u, _ in fetched] == ["m1", "m2"]
    assert all(dest == "X.pth.part" for _, dest in fetched) and ("X.pth.part", "X.pth") in renamed
    assert sorted(os.listdir(ckpts / "thing")) == ["X.pth", "X.pth.npz"]
    assert sd.keys() == _sd().keys() and all(torch.equal(sd[k], v) for k, v in _sd().items())
    assert download.get_converted_params("thing", "X.pth") is sd and len(fetched) == 2
    # the file and the memory cache gone: the .npz serves
    os.remove(ckpts / "thing" / "X.pth")
    monkeypatch.setattr(download, "_params_memcache", {})
    again = download.get_converted_params("thing", "X.pth")
    assert again is not sd and all(torch.equal(again[k], v) for k, v in sd.items()) and len(fetched) == 2


def test_missing_everywhere_raises_naming_the_path(ckpts, monkeypatch):
    with pytest.raises(FileNotFoundError, match="no mirror had it") as err:
        download.get_converted_params("thing", "Y.pth")
    assert str(ckpts / "thing" / "Y.pth") in str(err.value)
    assert not any(n.endswith(".part") for n in os.listdir(ckpts / "thing"))


def test_direct_url_downloads_once(ckpts, tmp_path, monkeypatch):
    (tmp_path / "m1").mkdir()
    torch.save(_sd(), str(tmp_path / "m1" / "Z.pth"))
    url = (tmp_path / "m1" / "Z.pth").as_uri()
    path = download.load_file_from_direct_url("thing", url)
    assert path == str(ckpts / "thing" / "Z.pth") and os.path.exists(path)
    monkeypatch.setattr(download.urllib.request, "urlretrieve", lambda *a: pytest.fail("downloaded twice"))
    assert download.load_file_from_direct_url("thing", url) == path


def test_direct_url_that_fails_raises_naming_the_path(ckpts, tmp_path):
    url = (tmp_path / "m1" / "W.pth").as_uri()
    with pytest.raises(FileNotFoundError, match="W.pth") as err:
        download.get_converted_params("thing", "W.pth", url=url)
    assert str(ckpts / "thing" / "W.pth") in str(err.value) and url in str(err.value)
    assert not any(n.endswith(".part") for n in os.listdir(ckpts / "thing"))


def test_amt_node_downloads_from_the_jax_nodes_url(ckpts, monkeypatch):
    asked = []

    def retrieve(url, dest):
        asked.append(url)
        torch.save({"w": torch.ones(1)}, dest)

    monkeypatch.setattr(download.urllib.request, "urlretrieve", retrieve)
    monkeypatch.setattr(amt, "make_model_fn", lambda params, *a, **k: lambda f0, f1, t: f0)
    frames = np.random.default_rng(0).random((2, 16, 16, 3), dtype=np.float32)
    vfi_nodes.AMT_VFI().vfi("amt-s.pth", frames, multiplier=2, device="cpu")
    assert asked == ["https://huggingface.co/lalala125/AMT/resolve/main/amt-s.pth"]
    assert sorted(os.listdir(ckpts / "amt")) == ["amt-s.pth", "amt-s.pth.npz"]


def test_npz_interchange_with_jax(tmp_path):
    tree = {"model": {"conv": {"weight": np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2), "bias": np.ones(2, np.float32)}},
            "step": np.int64(7)}
    jckpt.save_npz(tree, str(tmp_path / "jax.npz"))
    got = ckpt.load_npz(str(tmp_path / "jax.npz"))
    want = jckpt.flatten_tree(tree)
    assert sorted(got) == sorted(k.replace("/", ".") for k in want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k.replace("/", ".")].numpy(), v)
    sd = {"a.b.weight": torch.randn(3, 4), "a.c": torch.arange(5), "half": torch.randn(2).bfloat16()}
    ckpt.save_npz(sd, str(tmp_path / "port.npz"))
    back = jckpt.flatten_tree(jckpt.load_npz(str(tmp_path / "port.npz")))
    assert sorted(back) == sorted(k.replace(".", "/") for k in sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k.replace(".", "/")], v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy())


def test_cli_converts_a_module_prefixed_container(tmp_path, capsys):
    sd = _sd(1)
    src = tmp_path / "net.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}, "epoch": 3}, str(src))
    assert ckpt.main([str(src), str(tmp_path / "out.npz")]) == 0
    assert "(2 tensors)" in capsys.readouterr().out
    got = ckpt.load_npz(str(tmp_path / "out.npz"))
    assert got.keys() == sd.keys() and all(torch.equal(got[k], v) for k, v in sd.items())
    jtree = jckpt.load_npz(str(tmp_path / "out.npz"))
    np.testing.assert_array_equal(jtree["block"]["conv"]["weight"], sd["block.conv.weight"].numpy())
    subprocess.run([sys.executable, "-m", "comfyui_frame_interpolation_tpu_torch.utils.ckpt", str(src)], check=True,
                   cwd=ROOT, capture_output=True, timeout=300)
    assert ckpt.load_npz(str(tmp_path / "net.npz")).keys() == sd.keys()
    with pytest.raises(ValueError, match=r"\.npz only"):
        ckpt.main([str(src), str(tmp_path / "orbax_dir")])


def test_maybe_profile_writes_a_trace_under_cfi_profile(tmp_path, monkeypatch):
    monkeypatch.setenv("CFI_PROFILE", str(tmp_path / "prof"))
    assert profiling.profiling_enabled()
    frames = torch.rand(3, 8, 8, 3)
    with profiling.maybe_profile("outer"):  # the executor's own region nests inside: no second trace
        run_plan(frames, plan_timestep(3, 2), lambda f0, f1, t: (f0 + f1) / 2, batch_size=2)
    assert os.listdir(tmp_path / "prof") == ["outer"]
    out = run_plan(frames, plan_timestep(3, 2), lambda f0, f1, t: (f0 + f1) / 2, batch_size=2)
    traces = os.listdir(tmp_path / "prof" / "run_plan")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json") and tuple(out.shape) == (5, 8, 8, 3)
    import json

    with open(tmp_path / "prof" / "run_plan" / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::add" for e in events)


def test_maybe_profile_unset_never_calls_the_profiler(monkeypatch):
    monkeypatch.delenv("CFI_PROFILE", raising=False)
    monkeypatch.setattr(torch.profiler, "profile", lambda *a, **k: pytest.fail("the profiler ran"))
    assert not profiling.profiling_enabled()
    with profiling.maybe_profile("x"):
        pass
    run_plan(torch.rand(2, 4, 4, 3), plan_timestep(2, 2), lambda f0, f1, t: f0, batch_size=1)


# (node class, checkpoint name, model module, builder, files as {(type, name): state dict}, frames, extra kwargs)
_W = {"w": torch.ones(1)}
_NODES = {
    "rife": (rife_node.RIFE_VFI, "rife47.pth", rife, "make_model_fn", {("rife", "rife47.pth"): _W}, 2, {}),
    "film": (vfi_nodes.FILM_VFI, "film_net_fp32.pt", film, "make_model_fn", {("film", "film_net_fp32.pt"): _W}, 2, {}),
    "m2m": (vfi_nodes.M2M_VFI, "M2M.pth", m2m, "make_pair_fns", {("m2m", "M2M.pth"): _W}, 2, {}),
    "gmfss": (vfi_nodes.GMFSS_Fortuna_VFI, "GMFSS_fortuna", gmfss, "make_pair_fns",
              {v: _W for v in vfi_nodes.GMFSS_Fortuna_VFI.CKPTS_PATH_CONFIG["GMFSS_fortuna"].values()}, 2, {}),
    "eisai": (vfi_nodes.EISAI_VFI, "eisai", eisai, "make_pair_fns",
              {("eisai", "eisai_ssl.pt"): _W, ("eisai", "eisai_dtm.pt"): _W,
               ("eisai", "eisai_anime_interp_full.ckpt"): {"model_state_dict": {"module.flownet.w": torch.ones(1)}}}, 2, {}),
    "stmfnet": (vfi_nodes.STMFNet_VFI, "stmfnet.pth", stmfnet, "make_model_fn", {("stmfnet", "stmfnet.pth"): _W}, 4, {}),
    "flavr": (vfi_nodes.FLAVR_VFI, "FLAVR_2x.pth", flavr, "make_model_fn", {("flavr", "FLAVR_2x.pth"): _W}, 4, {}),
    "ifrnet": (vfi_nodes.IFRNet_VFI, "IFRNet_S_Vimeo90K.pth", ifrnet, "make_model_fn", {("ifrnet", "IFRNet_S_Vimeo90K.pth"): _W}, 2, {}),
    "ifunet": (vfi_nodes.IFUnet_VFI, "IFUNet.pth", ifunet, "make_model_fn", {("ifunet", "IFUNet.pth"): _W}, 2, {}),
    "amt": (vfi_nodes.AMT_VFI, "amt-s.pth", amt, "make_model_fn", {("amt", "amt-s.pth"): _W}, 2, {}),
    "atm": (vfi_nodes.ATM_VFI, "atm-vfi-base.pt", atm, "make_model_fn",
            {("atm", "atm-vfi-base.pt"): {"w": torch.ones(1), "blk.attn_mask": torch.zeros(2)}}, 2, {}),
    "xvfi": (vfi_nodes.XVFI_VFI, "XVFInet_Vimeo_exp1_latest.pt", xvfi, "make_pair_fns",
             {("xvfi", "XVFInet_Vimeo_exp1_latest.pt"): {"state_dict_Model": _W}}, 2, {}),
    "cain": (vfi_nodes.CAIN_VFI, "pretrained_cain.pth", cain, "make_model_fn", {("cain", "pretrained_cain.pth"): _W}, 2, {}),
    "sepconv": (vfi_nodes.SepconvVFI, "sepconv.pth", sepconv, "make_model_fn", {("sepconv", "sepconv.pth"): _W}, 2, {}),
    "momo": (vfi_nodes.MOMO_VFI, "momo-lite.pth", momo, "make_model_fn", {("momo", "momo-lite.pth"): _W}, 2, {}),
}


@pytest.mark.parametrize("family", list(_NODES))
def test_node_builds_its_model_once_from_its_checkpoint(family, ckpts, monkeypatch):
    cls, name, module, builder, files, n_frames, kw = _NODES[family]
    for (model_type, fname), content in files.items():
        (ckpts / model_type).mkdir(parents=True, exist_ok=True)
        torch.save(content, str(ckpts / model_type / fname))
    built = []

    def stub(params, *args, **kwargs):
        built.append(params)
        fn = lambda *a, **k: a[0]  # noqa: E731  (the first frame stands in for the model's output)
        return (fn, fn) if builder == "make_pair_fns" else fn

    monkeypatch.setattr(module, builder, stub)
    frames = np.random.default_rng(0).random((n_frames, 16, 16, 3), dtype=np.float32)
    node = cls()
    for _ in range(2):
        (out,) = node.vfi(name, frames, multiplier=2, device="cpu", **kw)
        assert out.shape[1:] == (16, 16, 3)
    assert len(built) == 1
    for model_type, fname in files:
        assert os.path.exists(ckpts / model_type / f"{fname}.npz")
    if family == "atm":
        assert "blk.attn_mask" not in built[0]
    if family == "eisai":
        assert built[0]["raft.w"].item() == 1.0
