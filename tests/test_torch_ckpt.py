"""The port's ``utils/ckpt.py:load_checkpoint_file`` against the JAX loader
(``utils/ckpt.py:load_torch_state_dict``) on containers that ``torch.save``
writes: a raw state dict, one nested under each training key the JAX loader
knows (``state_dict``: STMFNet; ``model_state_dict``: ATM, EISAI; ``model``:
MoMo; ``state_dict_Model``: XVFI), and ``state_dict`` with ``nn.DataParallel``'s
``module.`` prefix (``FLAVR_*.pth``). Both give the same keys and tensors. A
checkpoint that is neither in ``ckpts_path`` nor downloadable raises
``FileNotFoundError`` naming it (``utils.download.get_converted_params``)."""

import numpy as np
import pytest
import torch

from comfyui_frame_interpolation_tpu.utils.ckpt import load_torch_state_dict
from comfyui_frame_interpolation_tpu_torch.core import config as port_config
from comfyui_frame_interpolation_tpu_torch.utils.ckpt import load_checkpoint_file, params_from_jax
from comfyui_frame_interpolation_tpu_torch.utils.download import get_converted_params
from torch_offline import no_downloads  # noqa: F401  (autouse: no download leaves the machine)
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)


@pytest.fixture
def ckpts(tmp_path, monkeypatch):
    monkeypatch.setenv("CFI_TORCH_CONFIG", str(tmp_path / "config.yaml"))
    (tmp_path / "config.yaml").write_text(f"ckpts_path: {tmp_path / 'ckpts'}\n")
    (tmp_path / "ckpts" / "flavr").mkdir(parents=True)
    port_config.load_config.cache_clear()
    yield tmp_path / "ckpts" / "flavr"
    port_config.load_config.cache_clear()


def _state_dict():
    g = torch.Generator().manual_seed(0)
    return {
        "encoder.stem.0.weight": torch.randn(4, 3, 3, 7, 7, generator=g),
        "decoder.0.conv.0.bias": torch.randn(4, generator=g),
        "outconv.1.weight": torch.randn(3, 4, 7, 7, generator=g),
    }


@pytest.mark.parametrize("container", [
    "raw", "state_dict", "state_dict+module", "model_state_dict", "model", "state_dict_Model", "raw+module",
])
def test_load_local_checkpoint_unwraps_as_the_jax_loader(ckpts, container):
    sd = _state_dict()
    inner = {f"module.{k}": v for k, v in sd.items()} if container.endswith("+module") else sd
    key = container.split("+")[0]
    obj = inner if key == "raw" else {key: inner, "epoch": 7, "optimizer": {"lr": 1e-4}}
    torch.save(obj, ckpts / "FLAVR_2x.pth")
    got = load_checkpoint_file(str(ckpts / "FLAVR_2x.pth"))
    ref = params_from_jax(load_torch_state_dict(str(ckpts / "FLAVR_2x.pth")))
    assert set(got) == set(ref) == set(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k]) and np.array_equal(ref[k].numpy(), sd[k].numpy())


def test_the_first_training_key_wins_as_in_the_jax_loader(ckpts):
    sd = _state_dict()
    other = {"other.weight": torch.zeros(2)}
    torch.save({"model": other, "state_dict": sd}, ckpts / "FLAVR_2x.pth")
    got = load_checkpoint_file(str(ckpts / "FLAVR_2x.pth"))
    assert set(got) == set(params_from_jax(load_torch_state_dict(str(ckpts / "FLAVR_2x.pth")))) == set(sd)


def test_missing_checkpoint_raises(ckpts):
    with pytest.raises(FileNotFoundError, match="FLAVR_4x.pth"):
        get_converted_params("flavr", "FLAVR_4x.pth")
