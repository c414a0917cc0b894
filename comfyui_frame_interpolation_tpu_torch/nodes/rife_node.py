"""RIFE VFI node (reference ``vfi_models/rife/__init__.py:34-239``), port of
the JAX package's ``nodes/rife_node.py``.

Same public schema and loop semantics: the flat (pair, timestep) task list
becomes a :func:`plan_timestep` plan run by the batched executor with a true
batch dimension and a ``[B]`` timestep vector. Frames and results are NHWC
torch tensors on the node's device.
"""

from __future__ import annotations

import typing

import torch

from ..core.config import load_config
from ..core.frames import assert_batch_size, postprocess_frames, preprocess_frames
from ..core.loop import run_plan
from ..core.schedule import InterpolationStateList, plan_timestep
from ..models import rife
from ..utils.download import get_converted_params

MODEL_TYPE = "rife"

DTYPE_OPTIONS = ["float32", "float16", "bfloat16"]
DTYPE_MAP = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}


class RIFE_VFI:
    def __init__(self):
        # (params, key) -> model_fn; the params object itself is kept and
        # compared, so a freed params dict can never alias a new one by id
        self._model_fns: typing.Dict[tuple, typing.Tuple[dict, typing.Callable]] = {}

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "ckpt_name": (
                    sorted(rife.CKPT_NAME_VER_DICT.keys()),
                    {"default": "rife49.pth"},
                ),
                "frames": ("IMAGE",),
                "clear_cache_after_n_frames": ("INT", {"default": 10, "min": 1, "max": 1000}),
                "multiplier": ("INT", {"default": 2, "min": 1}),
                "fast_mode": ("BOOLEAN", {"default": True}),
                "ensemble": ("BOOLEAN", {"default": True}),
                "scale_factor": ([0.25, 0.5, 1.0, 2.0, 4.0], {"default": 1.0}),
                "dtype": (DTYPE_OPTIONS, {"default": "float32"}),
                # reference input (rife/__init__.py:53-58) kept for graph
                # parity; accepted and ignored
                "torch_compile": ("BOOLEAN", {"default": False}),
                "batch_size": ("INT", {"default": 1, "min": 1, "max": 64}),
            },
            "optional": {
                "optional_interpolation_states": ("INTERPOLATION_STATES",)
            },
        }

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "vfi"
    CATEGORY = "ComfyUI-Frame-Interpolation/VFI"

    def vfi(
        self,
        ckpt_name: str,
        frames,
        clear_cache_after_n_frames: int = 10,
        multiplier: typing.Union[int, typing.List[int]] = 2,
        fast_mode: bool = False,
        ensemble: bool = False,
        scale_factor: float = 1.0,
        dtype: str = "float32",
        batch_size: int = 1,
        optional_interpolation_states: InterpolationStateList = None,
        params: dict = None,  # extension: inject a state dict
        device=None,  # extension: torch device (default: config "device")
        **kwargs,
    ):
        arch_ver = rife.CKPT_NAME_VER_DICT[ckpt_name]
        device = torch.device(device or load_config()["device"])
        frames = preprocess_frames(frames, device)
        assert_batch_size(frames, 2, "RIFE")
        if params is None:
            params = get_converted_params(MODEL_TYPE, ckpt_name)

        key = (id(params), ckpt_name, dtype, fast_mode, ensemble, scale_factor, str(device))
        cached = self._model_fns.get(key)
        if cached is None or cached[0] is not params:
            cached = (
                params,
                rife.make_model_fn(
                    params,
                    arch_ver,
                    scale_factor=scale_factor,
                    fastmode=fast_mode,
                    ensemble=ensemble,
                    dtype=DTYPE_MAP[dtype],
                    device=device,
                ),
            )
            self._model_fns[key] = cached
        model_fn = cached[1]

        plan = plan_timestep(
            frames.shape[0],
            multiplier,
            optional_interpolation_states,
            zero_drops_pair=False,  # RIFE loop keeps m==0 pairs' frames
        )
        out = run_plan(frames, plan, model_fn, batch_size=batch_size)
        return (postprocess_frames(out),)
