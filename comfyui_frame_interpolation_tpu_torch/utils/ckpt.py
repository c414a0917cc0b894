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
sub-network's name (:func:`load_checkpoint_set`).
"""

from __future__ import annotations

import os
import zipfile
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..core.config import get_ckpt_container_path

__all__ = ["is_torchscript_archive", "load_checkpoint_set", "load_local_checkpoint", "params_from_jax"]


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
    the CPU: a TorchScript archive through ``torch.jit.load(...).state_dict()``,
    a raw ``torch.save`` container with ``weights_only=True``. Nothing is
    downloaded: a missing file raises ``FileNotFoundError``."""
    path = os.path.join(get_ckpt_container_path(model_type), ckpt_name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{model_type} checkpoint {path} not found: place {ckpt_name} there or pass "
            "params= (a state dict, e.g. the model module's init_params(seed))"
        )
    if is_torchscript_archive(path):
        return dict(torch.jit.load(path, map_location="cpu").state_dict())
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint_set(files: Mapping[str, Tuple[str, str]]) -> Dict[str, torch.Tensor]:
    """One state dict from a set of local checkpoints: ``files`` maps each
    prefix to its ``(model_type, ckpt_name)``, as the nodes'
    ``CKPTS_PATH_CONFIG`` entries do. Each file is read by
    :func:`load_local_checkpoint` (so a missing file raises
    ``FileNotFoundError`` naming it, and nothing is downloaded); a leading
    ``module.`` is stripped from its keys, as the JAX loader does, and the
    prefix is put before them (``flownet.backbone.conv1.weight``)."""
    out: Dict[str, torch.Tensor] = {}
    for prefix, (model_type, ckpt_name) in files.items():
        for key, value in load_local_checkpoint(model_type, ckpt_name).items():
            out[f"{prefix}.{key.removeprefix('module.')}"] = value
    return out
