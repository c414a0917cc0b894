"""Parameter trees into the port's state dicts.

The JAX package keeps parameters as nested dicts in torch layout, keyed by the
torch module names (its ``utils/ckpt.py``), so flattening a tree with ``.``
gives the port's ``state_dict`` keys directly, with no per-model table. The
models load the result with ``strict=True``. Nothing is downloaded here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_jax"]


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

