"""Configuration (reference: the two-key ``config.yaml`` read at
``vfi_utils.py:42-47``), with the JAX package's keys minus ``ops_backend``:
kernels are chosen by the tensor's device, so no knob is needed.

Keys:
  ckpts_path — where model weights live (default ``./ckpts``)
  device     — torch device the nodes run on (default ``"cuda"``)

``config.yaml`` beside the package, or the file ``CFI_TORCH_CONFIG`` names,
overrides the defaults; ``yaml`` is imported only when that file exists.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_DEFAULTS: Dict[str, Any] = {
    "ckpts_path": "./ckpts",
    "device": "cuda",
}


@functools.lru_cache(maxsize=None)
def load_config() -> Dict[str, Any]:
    cfg = dict(_DEFAULTS)
    path = os.environ.get("CFI_TORCH_CONFIG", os.path.join(_ROOT, "config.yaml"))
    if os.path.exists(path):
        import yaml

        with open(path) as f:
            cfg.update(yaml.safe_load(f) or {})
    return cfg


def get_ckpt_container_path(model_type: str) -> str:
    base = load_config()["ckpts_path"]
    if not os.path.isabs(base):
        base = os.path.abspath(os.path.join(_ROOT, base))
    return os.path.join(base, model_type)
