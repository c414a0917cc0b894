"""Parameter trees and local checkpoints into the port's state dicts.

The JAX package keeps parameters as nested dicts in torch layout, keyed by the
torch module names (its ``utils/ckpt.py``), so flattening a tree with ``.``
gives the port's ``state_dict`` keys directly, with no per-model table. The
models load the result with ``strict=True``. Nothing is downloaded here.

Local checkpoints are raw ``torch.save`` containers, or TorchScript archives
(FILM's ``film_net_fp32.pt``, which the reference loads with
``torch.jit.load``), read through ``torch.jit.load`` as the JAX loader does
(its ``utils/ckpt.py:90-132``). Multi-file models (GMFSS Fortuna) load a
checkpoint set: one state dict per sub-network, its keys prefixed by the
sub-network's name (:func:`load_checkpoint_set`), as does EISAI.
"""

from __future__ import annotations

import os
import zipfile
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..core.config import get_ckpt_container_path

__all__ = ["is_torchscript_archive", "load_checkpoint_set", "load_local_checkpoint", "params_from_jax"]

# the training containers a state dict may sit in, in the order the JAX
# loader tries them (its ``utils/ckpt.py:load_torch_state_dict``): AMT, CAIN,
# FLAVR and STMFNet; ATM and EISAI's full checkpoint; MoMo; XVFI
NESTED_KEYS = ("state_dict", "model_state_dict", "model", "state_dict_Model")


def params_from_jax(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested JAX parameter tree (numpy or JAX array leaves) -> flat state dict
    of CPU tensors with ``.``-joined keys (the JAX ``flatten_tree``)."""
    flat: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(params_from_jax(v, key))
        else:
            flat[key] = torch.from_numpy(np.array(v))
    return flat


def is_torchscript_archive(path: str) -> bool:
    """True if ``path`` is a TorchScript zip archive, which holds a
    ``constants.pkl`` member (a plain ``torch.save`` zip holds ``data.pkl``
    only), as the JAX ``is_torchscript_archive`` tells them apart."""
    if not zipfile.is_zipfile(path):
        return False
    try:
        with zipfile.ZipFile(path) as zf:
            return any(name.endswith("constants.pkl") for name in zf.namelist())
    except zipfile.BadZipFile:
        return False


def load_local_checkpoint(model_type: str, ckpt_name: str) -> Dict[str, torch.Tensor]:
    """The state dict in ``ckpts_path/<model_type>/<ckpt_name>``, loaded on
    the CPU, with the keys the JAX loader gives the same file: a TorchScript
    archive through ``torch.jit.load(...).state_dict()``; a raw
    ``torch.save`` container with ``weights_only=True``, taken out of the
    first training container of :data:`NESTED_KEYS` it holds (STMFNet's
    ``state_dict``, EISAI's ``model_state_dict``); a leading ``module.``
    (``nn.DataParallel``'s, as in ``FLAVR_*.pth``) stripped from every key.
    Nothing is downloaded: a missing file raises ``FileNotFoundError``."""
    path = os.path.join(get_ckpt_container_path(model_type), ckpt_name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{model_type} checkpoint {path} not found: place {ckpt_name} there or pass "
            "params= (a state dict, e.g. the model module's init_params(seed))"
        )
    if is_torchscript_archive(path):
        obj = dict(torch.jit.load(path, map_location="cpu").state_dict())
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        inner = next((obj[k] for k in NESTED_KEYS if isinstance(obj.get(k), dict)), None)
        obj = obj if inner is None else inner
    return {k.removeprefix("module."): v for k, v in obj.items()}


def load_checkpoint_set(files: Mapping[str, Tuple[str, ...]]) -> Dict[str, torch.Tensor]:
    """One state dict from a set of local checkpoints: ``files`` maps each
    prefix to its ``(model_type, ckpt_name)``, or ``(model_type, ckpt_name,
    part)`` for a file that holds more than the sub-network, as the nodes'
    ``CKPTS_PATH_CONFIG`` entries do. Each file is read by
    :func:`load_local_checkpoint` (so a missing file raises
    ``FileNotFoundError`` naming it, nothing is downloaded, and a leading
    ``module.`` is stripped from its keys, as the JAX loader does); with a
    ``part``, only the keys under ``part.`` are kept, without it, as EISAI's
    node takes ``flownet`` from its full checkpoint (a file with no key under
    ``part.`` raises ``KeyError`` naming both); and the prefix is put before
    them (``flownet.backbone.conv1.weight``)."""
    out: Dict[str, torch.Tensor] = {}
    for prefix, (model_type, ckpt_name, *part) in files.items():
        sd = load_local_checkpoint(model_type, ckpt_name)
        if part:
            sd = {k[len(part[0]) + 1 :]: v for k, v in sd.items() if k.startswith(f"{part[0]}.")}
            if not sd:
                raise KeyError(f"{model_type} checkpoint {ckpt_name} holds no key under {part[0]}.")
        for key, value in sd.items():
            out[f"{prefix}.{key}"] = value
    return out
