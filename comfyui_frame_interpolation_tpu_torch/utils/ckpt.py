"""Parameter trees and local checkpoints into the port's state dicts.

The JAX package keeps parameters as nested dicts in torch layout, keyed by the
torch module names (its ``utils/ckpt.py``), so flattening a tree with ``.``
gives the port's ``state_dict`` keys directly, with no per-model table. The
models load the result with ``strict=True``. Nothing is downloaded here.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..core.config import get_ckpt_container_path

__all__ = ["load_local_checkpoint", "params_from_jax"]


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


def load_local_checkpoint(model_type: str, ckpt_name: str) -> Dict[str, torch.Tensor]:
    """The state dict in ``ckpts_path/<model_type>/<ckpt_name>`` (a raw
    ``torch.save`` container, loaded on the CPU with ``weights_only=True``).
    Nothing is downloaded: a missing file raises ``FileNotFoundError``."""
    path = os.path.join(get_ckpt_container_path(model_type), ckpt_name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{model_type} checkpoint {path} not found: place {ckpt_name} there or pass "
            "params= (a state dict, e.g. the model module's init_params(seed))"
        )
    return torch.load(path, map_location="cpu", weights_only=True)
