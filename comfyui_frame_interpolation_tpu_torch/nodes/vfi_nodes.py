"""VFI nodes of the generic-loop model families, port of the JAX package's
``nodes/vfi_nodes.py`` (reference node files under ``vfi_models/*/__init__.py``).

Ported: FILM, M2M, GMFSS Fortuna, EISAI, STMFNet, FLAVR, IFRNet, IFUnet, AMT,
ATM, XVFI, CAIN, Sepconv and MoMo. Same public schema as the JAX nodes (the
tooltips speak of the card); frames and results are NHWC torch tensors on the node's device.

Without ``params=`` a node reads its checkpoint through
``utils.download.get_converted_params`` (the in-memory cache, the ``.npz``
cache, the file, or a download), which hands every call the same dict, so
the node builds its model once per checkpoint.
"""

from __future__ import annotations

import typing
import warnings

import torch
import torch.nn.functional as F

from ..core.config import load_config
from ..core.frames import assert_batch_size, postprocess_frames, preprocess_frames
from ..core.loop import run_plan, run_plan_pair_cached, run_plan_window4
from ..core.schedule import InterpolationStateList, plan_bisection, plan_midpoint, plan_timestep, plan_window4
from ..models import amt as amt_model
from ..models import atm as atm_model
from ..models import cain as cain_model
from ..models import eisai as eisai_model
from ..models import film as film_model
from ..models import flavr as flavr_model
from ..models import gmfss as gmfss_model
from ..models import ifrnet as ifrnet_model
from ..models import ifunet as ifunet_model
from ..models import m2m as m2m_model
from ..models import momo as momo_model
from ..models import sepconv as sepconv_model
from ..models import stmfnet as stmfnet_model
from ..models import xvfi as xvfi_model
from ..utils.ckpt import load_checkpoint_set
from ..utils.download import get_converted_params
from .rife_node import DTYPE_MAP, DTYPE_OPTIONS

_OPTIONAL = {"optional": {"optional_interpolation_states": ("INTERPOLATION_STATES",)}}

_BATCH_TOOLTIP = (
    "Frames interpolated per model call. The executor stacks tasks into one "
    "batch; raising this keeps the GPU busier until device memory runs out "
    "(rule of thumb: 4-8 for light flow models at 1080p, 1-2 for heavy "
    "synthesis models)."
)
_DTYPE_TOOLTIP = (
    "bfloat16 halves the memory of activations and runs the convolutions on "
    "the GPU's bf16 tensor cores (>=40 dB vs float32); float32 is the "
    "reference precision."
)


def _batch_dtype_inputs(batch_default):
    return {
        "batch_size": (
            "INT",
            {"default": batch_default, "min": 1, "max": 64, "tooltip": _BATCH_TOOLTIP},
        ),
        "dtype": (DTYPE_OPTIONS, {"default": "float32", "tooltip": _DTYPE_TOOLTIP}),
    }


def _cached(cache: dict, params: dict, key: tuple, make: typing.Callable):
    """``make()``, built once per ``params`` object and ``key``. The params
    object itself is kept and compared, so a freed params dict can never
    alias a new one by id."""
    full_key = (id(params), *key)
    entry = cache.get(full_key)
    if entry is None or entry[0] is not params:
        entry = (params, make())
        cache[full_key] = entry
    return entry[1]


def _base_inputs(ckpts, multiplier_min=2, multiplier_max=1000, batch_default=4, **extra):
    req = {
        "ckpt_name": (ckpts,),
        "frames": ("IMAGE",),
        "clear_cache_after_n_frames": ("INT", {"default": 10, "min": 1, "max": 1000}),
        "multiplier": ("INT", {"default": 2, "min": multiplier_min, "max": multiplier_max}),
    }
    req.update(extra)
    req.update(_batch_dtype_inputs(batch_default))
    return {"required": req, **_OPTIONAL}


class FILM_VFI:
    """reference ``film/__init__.py:44-113``; timeline-bisection schedule
    (every call interpolates the midpoint of its endpoints), run by the
    batched executor."""

    MODEL_TYPE = "film"

    def __init__(self):
        self._model_fns: typing.Dict[tuple, typing.Tuple[dict, typing.Callable]] = {}  # see _cached

    @classmethod
    def INPUT_TYPES(cls):
        return _base_inputs(film_model.CKPT_NAMES, batch_default=2)

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "vfi"
    CATEGORY = "ComfyUI-Frame-Interpolation/VFI"

    def vfi(
        self,
        ckpt_name: str,
        frames,
        clear_cache_after_n_frames: int = 10,
        multiplier=2,
        optional_interpolation_states: InterpolationStateList = None,
        params: dict = None,  # extension: inject a state dict
        batch_size: int = 2,
        dtype: str = "float32",
        device=None,  # extension: torch device (default: config "device")
        **kwargs,
    ):
        device = torch.device(device or load_config()["device"])
        frames = preprocess_frames(frames, device)
        assert_batch_size(frames, 2, "FILM")
        if params is None:
            params = get_converted_params(self.MODEL_TYPE, ckpt_name)
        model_fn = _cached(
            self._model_fns, params, (ckpt_name, dtype, str(device)),
            lambda: film_model.make_model_fn(params, dtype=DTYPE_MAP[dtype], device=device),
        )
        plan = plan_bisection(frames.shape[0], multiplier, optional_interpolation_states)
        out = run_plan(frames, plan, model_fn, batch_size=batch_size)
        return (postprocess_frames(out),)


class M2M_VFI:
    """reference ``m2m/__init__.py:14-60``; generic timestep schedule, run by
    the pair-cached executor: the flow pyramid, MotionRefineNet and metrics
    once per pair, the splat once per timestep (the reference recomputes all
    of it per timestep)."""

    MODEL_TYPE = "m2m"

    def __init__(self):
        self._pair_fns: typing.Dict[tuple, typing.Tuple[dict, tuple]] = {}  # see _cached

    @classmethod
    def INPUT_TYPES(cls):
        return _base_inputs(m2m_model.CKPT_NAMES, batch_default=2)

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "vfi"
    CATEGORY = "ComfyUI-Frame-Interpolation/VFI"

    def vfi(
        self,
        ckpt_name: str,
        frames,
        clear_cache_after_n_frames: int = 10,
        multiplier=2,
        optional_interpolation_states: InterpolationStateList = None,
        params: dict = None,  # extension: inject a state dict
        batch_size: int = 2,
        dtype: str = "float32",
        device=None,  # extension: torch device (default: config "device")
        **kwargs,
    ):
        device = torch.device(device or load_config()["device"])
        frames = preprocess_frames(frames, device)
        assert_batch_size(frames, 2, "M2M")
        if params is None:
            params = get_converted_params(self.MODEL_TYPE, ckpt_name)
        reuse_fn, infer_fn = _cached(
            self._pair_fns, params, (ckpt_name, dtype, str(device)),
            lambda: m2m_model.make_pair_fns(params, dtype=DTYPE_MAP[dtype], device=device),
        )
        plan = plan_timestep(frames.shape[0], multiplier, optional_interpolation_states)
        out = run_plan_pair_cached(frames, plan, reuse_fn, infer_fn, batch_size=batch_size)
        return (postprocess_frames(out),)


class GMFSS_Fortuna_VFI:
    """reference ``gmfss_fortuna/__init__.py:79-143``; generic timestep
    schedule, run by the pair-cached executor: GMFlow, the metric net and the
    feature pyramid once per pair, the splat and fusion once per timestep.

    The weights are a set of files per checkpoint name (``rife46.pth`` as
    well for the union variant), loaded into one state dict whose keys are
    prefixed by sub-network (``utils.ckpt.load_checkpoint_set``)."""

    CKPTS_PATH_CONFIG = {
        "GMFSS_fortuna_union": {
            "ifnet": ("rife", "rife46.pth"),
            "flownet": ("gmfss_fortuna", "GMFSS_fortuna_flownet.pkl"),
            "metricnet": ("gmfss_fortuna", "GMFSS_fortuna_union_metric.pkl"),
            "feat_ext": ("gmfss_fortuna", "GMFSS_fortuna_union_feat.pkl"),
            "fusionnet": ("gmfss_fortuna", "GMFSS_fortuna_union_fusionnet.pkl"),
        },
        "GMFSS_fortuna": {
            "flownet": ("gmfss_fortuna", "GMFSS_fortuna_flownet.pkl"),
            "metricnet": ("gmfss_fortuna", "GMFSS_fortuna_metric.pkl"),
            "feat_ext": ("gmfss_fortuna", "GMFSS_fortuna_feat.pkl"),
            "fusionnet": ("gmfss_fortuna", "GMFSS_fortuna_fusionnet.pkl"),
        },
    }

    def __init__(self):
        self._pair_fns: typing.Dict[tuple, typing.Tuple[dict, tuple]] = {}  # see _cached
        self._params: typing.Dict[str, dict] = {}  # per ckpt_name, loaded once

    @classmethod
    def INPUT_TYPES(cls):
        return _base_inputs(list(cls.CKPTS_PATH_CONFIG.keys()), batch_default=2)

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "vfi"
    CATEGORY = "ComfyUI-Frame-Interpolation/VFI"

    def vfi(
        self,
        ckpt_name: str,
        frames,
        clear_cache_after_n_frames: int = 10,
        multiplier=2,
        optional_interpolation_states: InterpolationStateList = None,
        params: dict = None,  # extension: inject a state dict
        batch_size: int = 2,
        dtype: str = "float32",
        device=None,  # extension: torch device (default: config "device")
        **kwargs,
    ):
        device = torch.device(device or load_config()["device"])
        frames = preprocess_frames(frames, device)
        assert_batch_size(frames, 2, "GMFSS Fortuna")
        union = "union" in ckpt_name
        if params is None:
            # one dict per name, so the pair-fn cache below hits on later calls
            if ckpt_name not in self._params:
                self._params[ckpt_name] = load_checkpoint_set(self.CKPTS_PATH_CONFIG[ckpt_name])
            params = self._params[ckpt_name]
        reuse_fn, infer_fn = _cached(
            self._pair_fns, params, (ckpt_name, dtype, str(device)),
            lambda: gmfss_model.make_pair_fns(params, union=union, dtype=DTYPE_MAP[dtype], device=device),
        )
        plan = plan_timestep(frames.shape[0], multiplier, optional_interpolation_states)
        out = run_plan_pair_cached(frames, plan, reuse_fn, infer_fn, batch_size=batch_size)
        return (postprocess_frames(out),)


class EISAI_VFI:
    """reference ``eisai/__init__.py:42-84``; generic timestep schedule, run
    by the pair-cached executor: the two 12-iteration RAFT passes once per
    pair, SoftsplatLite and DTM once per timestep (the reference recomputes
    the flows per timestep).

    The weights are three files (``CKPTS_PATH_CONFIG``: ``eisai_ssl.pt``,
    ``eisai_dtm.pt`` and the RFR weights under ``module.flownet.`` of
    ``eisai_anime_interp_full.ckpt``), loaded into one state dict whose keys
    are prefixed ``ssl.``, ``dtm.`` and ``raft.``
    (``utils.ckpt.load_checkpoint_set``)."""

    CKPTS_PATH_CONFIG = {
        "ssl": ("eisai", "eisai_ssl.pt"),
        "dtm": ("eisai", "eisai_dtm.pt"),
        "raft": ("eisai", "eisai_anime_interp_full.ckpt", "flownet"),
    }

    def __init__(self):
        self._pair_fns: typing.Dict[tuple, typing.Tuple[dict, tuple]] = {}  # see _cached
        self._params: typing.Optional[dict] = None  # loaded once

    @classmethod
    def INPUT_TYPES(cls):
        return _base_inputs(eisai_model.CKPT_NAMES, batch_default=2)

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "vfi"
    CATEGORY = "ComfyUI-Frame-Interpolation/VFI"

    def vfi(
        self,
        ckpt_name: str,
        frames,
        clear_cache_after_n_frames: int = 10,
        multiplier=2,
        optional_interpolation_states: InterpolationStateList = None,
        params: dict = None,  # extension: inject a state dict
        batch_size: int = 2,
        dtype: str = "float32",
        iters: int = 12,  # extension: RAFT iterations (the reference's 12)
        device=None,  # extension: torch device (default: config "device")
        **kwargs,
    ):
        device = torch.device(device or load_config()["device"])
        frames = preprocess_frames(frames, device)
        assert_batch_size(frames, 2, "EISAI")
        if params is None:
            if self._params is None:
                self._params = load_checkpoint_set(self.CKPTS_PATH_CONFIG)
            params = self._params
        reuse_fn, infer_fn = _cached(
            self._pair_fns, params, (dtype, iters, str(device)),
            lambda: eisai_model.make_pair_fns(params, dtype=DTYPE_MAP[dtype], device=device, iters=iters),
        )
        plan = plan_timestep(frames.shape[0], multiplier, optional_interpolation_states)
        out = run_plan_pair_cached(frames, plan, reuse_fn, infer_fn, batch_size=batch_size)
        return (postprocess_frames(out),)


def _pad16(frames: torch.Tensor) -> typing.Tuple[torch.Tensor, tuple]:
    """NHWC ``frames`` edge-padded to multiples of 16, centred (the
    reference ``InputPadder(divisor=16)``), and the index that crops a
    result back."""
    n, h, w, _ = frames.shape
    ph, pw = (-h) % 16, (-w) % 16
    top, left = ph // 2, pw // 2
    if ph or pw:
        frames = F.pad(frames.permute(0, 3, 1, 2), (left, pw - left, top, ph - top), mode="replicate").permute(0, 2, 3, 1)
    return frames, (slice(None), slice(top, top + h), slice(left, left + w))


def _window4_inputs(ckpts, batch_default):
    """The schema of the 4-frame window nodes (JAX ``vfi_nodes.py``: FLAVR,
    STMFNet): 2x only, with ``duplicate_first_last_frames``."""
    return {
        "required": {
            "ckpt_name": (ckpts,),
            "frames": ("IMAGE",),
            "clear_cache_after_n_frames": ("INT", {"default": 10, "min": 1, "max": 1000}),
            "multiplier": ("INT", {"default": 2, "min": 2, "max": 2}),
            "duplicate_first_last_frames": ("BOOLEAN", {"default": False}),
            **_batch_dtype_inputs(batch_default),
        },
        **_OPTIONAL,
    }


def _only_2x(multiplier: int, name: str) -> None:
    if multiplier != 2:
        warnings.warn(
            f"Currently, {name} only supports 2x interpolation. The process will continue but please set "
            "multiplier=2 afterward"
        )


class STMFNet_VFI:
    """reference ``stmfnet/__init__.py:13-100``; the 4-frame sliding-window
    2x schedule, run by the window executor (``run_plan_window4``)."""

    MODEL_TYPE = "stmfnet"

    def __init__(self):
        self._model_fns: typing.Dict[tuple, typing.Tuple[dict, typing.Callable]] = {}  # see _cached

    @classmethod
    def INPUT_TYPES(cls):
        return _window4_inputs(stmfnet_model.CKPT_NAMES, batch_default=1)

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "vfi"
    CATEGORY = "ComfyUI-Frame-Interpolation/VFI"

    def vfi(
        self,
        ckpt_name: str,
        frames,
        clear_cache_after_n_frames: int = 10,
        multiplier=2,
        duplicate_first_last_frames: bool = False,
        optional_interpolation_states: InterpolationStateList = None,
        params: dict = None,  # extension: inject a state dict
        batch_size: int = 1,
        dtype: str = "float32",
        device=None,  # extension: torch device (default: config "device")
        **kwargs,
    ):
        _only_2x(multiplier, "ST-MFNet")
        device = torch.device(device or load_config()["device"])
        frames = preprocess_frames(frames, device)
        assert_batch_size(frames, 4, "ST-MFNet")
        if params is None:
            params = get_converted_params(self.MODEL_TYPE, ckpt_name)
        model_fn = _cached(
            self._model_fns, params, (ckpt_name, dtype, str(device)),
            lambda: stmfnet_model.make_model_fn(params, dtype=DTYPE_MAP[dtype], device=device),
        )
        plan = plan_window4(frames.shape[0], duplicate_first_last_frames, optional_interpolation_states)
        out = run_plan_window4(frames, plan, model_fn, batch_size=batch_size)
        return (postprocess_frames(out),)


class FLAVR_VFI:
    """reference ``flavr/__init__.py:28-115``; the 4-frame sliding-window 2x
    schedule with one edge pad of the whole clip to multiples of 16,
    centred, cropped after."""

    MODEL_TYPE = "flavr"

    def __init__(self):
        self._model_fns: typing.Dict[tuple, typing.Tuple[dict, typing.Callable]] = {}  # see _cached

    @classmethod
    def INPUT_TYPES(cls):
        return _window4_inputs(flavr_model.CKPT_NAMES, batch_default=2)

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "vfi"
    CATEGORY = "ComfyUI-Frame-Interpolation/VFI"

    def vfi(
        self,
        ckpt_name: str,
        frames,
        clear_cache_after_n_frames: int = 10,
        multiplier=2,
        duplicate_first_last_frames: bool = False,
        optional_interpolation_states: InterpolationStateList = None,
        params: dict = None,  # extension: inject a state dict
        batch_size: int = 2,
        dtype: str = "float32",
        device=None,  # extension: torch device (default: config "device")
        **kwargs,
    ):
        _only_2x(multiplier, "FLAVR")
        device = torch.device(device or load_config()["device"])
        frames = preprocess_frames(frames, device)
        assert_batch_size(frames, 4, "FLAVR")
        if params is None:
            params = get_converted_params(self.MODEL_TYPE, ckpt_name)
        model_fn = _cached(
            self._model_fns, params, (ckpt_name, dtype, str(device)),
            lambda: flavr_model.make_model_fn(params, dtype=DTYPE_MAP[dtype], device=device),
        )
        frames, crop = _pad16(frames)
        plan = plan_window4(frames.shape[0], duplicate_first_last_frames, optional_interpolation_states)
        out = run_plan_window4(frames, plan, model_fn, batch_size=batch_size)
        return (postprocess_frames(out[crop]),)


class IFRNet_VFI:
    """reference ``ifrnet/__init__.py:11-57``; generic timestep schedule.
    The timestep drives ``embt`` and ``scale_factor`` the resize, as in the
    JAX node (the reference node passes them swapped)."""

    MODEL_TYPE = "ifrnet"

    def __init__(self):
        self._model_fns: typing.Dict[tuple, typing.Tuple[dict, typing.Callable]] = {}  # see _cached

    @classmethod
    def INPUT_TYPES(cls):
        return _base_inputs(ifrnet_model.CKPT_NAMES, scale_factor=([0.25, 0.5, 1.0, 2.0, 4.0], {"default": 1.0}))

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "vfi"
    CATEGORY = "ComfyUI-Frame-Interpolation/VFI"

    def vfi(
        self,
        ckpt_name: str,
        frames,
        clear_cache_after_n_frames: int = 10,
        multiplier=2,
        scale_factor: float = 1.0,
        optional_interpolation_states: InterpolationStateList = None,
        params: dict = None,  # extension: inject a state dict
        batch_size: int = 4,
        dtype: str = "float32",
        device=None,  # extension: torch device (default: config "device")
        **kwargs,
    ):
        device = torch.device(device or load_config()["device"])
        frames = preprocess_frames(frames, device)
        assert_batch_size(frames, 2, "IFRNet")
        variant = ifrnet_model.variant_for_ckpt(ckpt_name)
        if params is None:
            params = get_converted_params(self.MODEL_TYPE, ckpt_name)
        model_fn = _cached(
            self._model_fns, params, (variant, scale_factor, dtype, str(device)),
            lambda: ifrnet_model.make_model_fn(params, variant, scale_factor, dtype=DTYPE_MAP[dtype], device=device),
        )
        plan = plan_timestep(frames.shape[0], multiplier, optional_interpolation_states)
        out = run_plan(frames, plan, model_fn, batch_size=batch_size)
        return (postprocess_frames(out),)


class IFUnet_VFI:
    """reference ``ifunet/__init__.py:11-58``; generic timestep schedule. The
    schema's ``ensemble`` defaults to True and ``vfi``'s keyword to False, as
    in the JAX node."""

    MODEL_TYPE = "ifunet"

    def __init__(self):
        self._model_fns: typing.Dict[tuple, typing.Tuple[dict, typing.Callable]] = {}  # see _cached

    @classmethod
    def INPUT_TYPES(cls):
        return _base_inputs(
            ifunet_model.CKPT_NAMES,
            scale_factor=("FLOAT", {"default": 1.0, "min": 0.1, "max": 100, "step": 0.1}),
            ensemble=("BOOLEAN", {"default": True}),
            batch_default=2,
        )

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "vfi"
    CATEGORY = "ComfyUI-Frame-Interpolation/VFI"

    def vfi(
        self,
        ckpt_name: str,
        frames,
        clear_cache_after_n_frames: int = 10,
        multiplier=2,
        scale_factor: float = 1.0,
        ensemble: bool = False,
        optional_interpolation_states: InterpolationStateList = None,
        params: dict = None,  # extension: inject a state dict
        batch_size: int = 2,
        dtype: str = "float32",
        device=None,  # extension: torch device (default: config "device")
        **kwargs,
    ):
        device = torch.device(device or load_config()["device"])
        frames = preprocess_frames(frames, device)
        assert_batch_size(frames, 2, "IFUnet")
        if params is None:
            params = get_converted_params(self.MODEL_TYPE, ckpt_name)
        model_fn = _cached(
            self._model_fns, params, (scale_factor, ensemble, dtype, str(device)),
            lambda: ifunet_model.make_model_fn(
                params, scale=scale_factor, ensemble=ensemble, dtype=DTYPE_MAP[dtype], device=device
            ),
        )
        plan = plan_timestep(frames.shape[0], multiplier, optional_interpolation_states)
        out = run_plan(frames, plan, model_fn, batch_size=batch_size)
        return (postprocess_frames(out),)


class AMT_VFI:
    """reference ``amt/__init__.py:33-87``; generic timestep schedule, with
    the whole clip edge-padded once to multiples of 16, centred
    (``InputPadder``, ``amt/__init__.py:71-72``), and cropped after."""

    MODEL_TYPE = "amt"

    def __init__(self):
        self._model_fns: typing.Dict[tuple, typing.Tuple[dict, typing.Callable]] = {}  # see _cached

    @classmethod
    def INPUT_TYPES(cls):
        return _base_inputs(list(amt_model.CKPT_CONFIGS.keys()), batch_default=2)

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "vfi"
    CATEGORY = "ComfyUI-Frame-Interpolation/VFI"

    def vfi(
        self,
        ckpt_name: str,
        frames,
        clear_cache_after_n_frames: int = 10,
        multiplier=2,
        optional_interpolation_states: InterpolationStateList = None,
        params: dict = None,  # extension: inject a state dict
        batch_size: int = 2,
        dtype: str = "float32",
        device=None,  # extension: torch device (default: config "device")
        **kwargs,
    ):
        device = torch.device(device or load_config()["device"])
        frames = preprocess_frames(frames, device)
        assert_batch_size(frames, 2, "AMT")
        if params is None:
            params = get_converted_params(
                self.MODEL_TYPE, ckpt_name, url=f"https://huggingface.co/lalala125/AMT/resolve/main/{ckpt_name}"
            )
        model_fn = _cached(
            self._model_fns, params, (ckpt_name, dtype, str(device)),
            lambda: amt_model.make_model_fn(params, ckpt_name, dtype=DTYPE_MAP[dtype], device=device),
        )
        frames, crop = _pad16(frames)
        plan = plan_timestep(frames.shape[0], multiplier, optional_interpolation_states)
        out = run_plan(frames, plan, model_fn, batch_size=batch_size)
        return (postprocess_frames(out[crop]),)


def _strip_keys(sd: dict, names) -> dict:
    """``sd`` without every key that has one of ``names`` as a component of
    its dotted path, as the JAX node's ``_strip_keys`` drops them from the
    nested tree at any depth."""
    return {k: v for k, v in sd.items() if not set(k.split(".")) & set(names)}


class ATM_VFI:
    """reference ``atm/__init__.py:83-182``; bisection schedule, 2x only; each
    model call edge-pads to multiples of 64, centred (inside the model
    callable)."""

    MODEL_TYPE = "atm"
    GLOBAL_MOTION_SETTINGS = {
        "On": [True, False],
        "On with Ensemble (slowest)": [True, True],
        "Off (fastest)": [False, False],
    }

    def __init__(self):
        self._model_fns: typing.Dict[tuple, typing.Tuple[dict, typing.Callable]] = {}  # see _cached

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "ckpt_name": (atm_model.CKPT_NAMES,),
                "frames": ("IMAGE",),
                "clear_cache_after_n_frames": ("INT", {"default": 10, "min": 1, "max": 1000}),
                "multiplier": ("INT", {"default": 2, "min": 2, "max": 2}),
                "global_motion": (list(cls.GLOBAL_MOTION_SETTINGS.keys()),),
                **_batch_dtype_inputs(2),
            },
            **_OPTIONAL,
        }

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "vfi"
    CATEGORY = "ComfyUI-Frame-Interpolation/VFI"

    def vfi(
        self,
        ckpt_name: str,
        frames,
        clear_cache_after_n_frames: int = 10,
        multiplier=2,
        global_motion: str = "On",
        optional_interpolation_states: InterpolationStateList = None,
        params: dict = None,  # extension: inject a state dict
        batch_size: int = 2,
        dtype: str = "float32",
        device=None,  # extension: torch device (default: config "device")
        **kwargs,
    ):
        device = torch.device(device or load_config()["device"])
        frames = preprocess_frames(frames, device)
        assert_batch_size(frames, 2, "ATM")
        variant = atm_model.variant_for_ckpt(ckpt_name)
        gm, gm_ens = self.GLOBAL_MOTION_SETTINGS[global_motion]
        if params is None:
            # the reference deletes the stale attn_mask/HW buffers before
            # loading (atm/__init__.py:133-141); the masks are built per shape
            params = get_converted_params(
                self.MODEL_TYPE, ckpt_name, convert=lambda sd: _strip_keys(sd, ("attn_mask", "HW"))
            )
        model_fn = _cached(
            self._model_fns, params, (variant, gm, gm_ens, dtype, str(device)),
            lambda: atm_model.make_model_fn(params, variant, gm, gm_ens, dtype=DTYPE_MAP[dtype], device=device),
        )
        plan = plan_bisection(frames.shape[0], multiplier, optional_interpolation_states)
        out = run_plan(frames, plan, model_fn, batch_size=batch_size)
        return (postprocess_frames(out),)


class XVFI_VFI:
    """reference ``xvfi/__init__.py:49-115``; generic timestep schedule (a
    timestep of 0 keeps its pair), run by the pair-cached executor: the
    feature pyramid and every flow level once per pair, level 0's synthesis
    once per timestep (the reference recomputes all of it per timestep).

    As in the JAX node, the schema keeps the reference's spelling
    ``multipler`` and ``vfi`` accepts ``multiplier`` too; interpolation
    states take the standard skip semantics and frames come out in temporal
    order (the reference fails on states and sorts frame keys as strings)."""

    MODEL_TYPE = "xvfi"

    def __init__(self):
        self._pair_fns: typing.Dict[tuple, typing.Tuple[dict, tuple]] = {}  # see _cached

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "ckpt_name": (list(xvfi_model.CKPT_CONFIGS.keys()),),
                "frames": ("IMAGE",),
                "batch_size": ("INT", {"default": 2, "min": 1, "max": 100, "tooltip": _BATCH_TOOLTIP}),
                "multipler": ("INT", {"default": 2, "min": 2, "max": 1000}),
                "dtype": (DTYPE_OPTIONS, {"default": "float32", "tooltip": _DTYPE_TOOLTIP}),
            },
            **_OPTIONAL,
        }

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "vfi"
    CATEGORY = "ComfyUI-Frame-Interpolation/VFI"

    def vfi(
        self,
        ckpt_name: str,
        frames,
        batch_size: int = 2,
        multipler: int = 2,
        multiplier: int = None,
        optional_interpolation_states: InterpolationStateList = None,
        params: dict = None,  # extension: inject a state dict
        dtype: str = "float32",
        device=None,  # extension: torch device (default: config "device")
        **kwargs,
    ):
        mult = multiplier if multiplier is not None else multipler
        device = torch.device(device or load_config()["device"])
        frames = preprocess_frames(frames, device)
        assert_batch_size(frames, 2, "XVFI")
        if params is None:  # the loader takes the weights out of state_dict_Model
            params = get_converted_params(self.MODEL_TYPE, ckpt_name)
        reuse_fn, infer_fn = _cached(
            self._pair_fns, params, (ckpt_name, dtype, str(device)),
            lambda: xvfi_model.make_pair_fns(params, ckpt_name, dtype=DTYPE_MAP[dtype], device=device),
        )
        plan = plan_timestep(frames.shape[0], mult, optional_interpolation_states, zero_drops_pair=False)
        out = run_plan_pair_cached(frames, plan, reuse_fn, infer_fn, batch_size=batch_size)
        return (postprocess_frames(out),)


def _midpoint_vfi(node, model, name, ckpt_name, frames, multiplier, states, params, batch_size, dtype, device):
    """A midpoint-mode node's run (CAIN, Sepconv): the model function built
    once per params, the recursive-midpoint schedule on the resident
    executor."""
    device = torch.device(device or load_config()["device"])
    frames = preprocess_frames(frames, device)
    assert_batch_size(frames, 2, name)
    if params is None:
        params = get_converted_params(node.MODEL_TYPE, ckpt_name)
    model_fn = _cached(
        node._model_fns, params, (dtype, str(device)),
        lambda: model.make_model_fn(params, dtype=DTYPE_MAP[dtype], device=device),
    )
    plan = plan_midpoint(frames.shape[0], multiplier, states)
    out = run_plan(frames, plan, model_fn, batch_size=batch_size)
    return (postprocess_frames(out),)


class CAIN_VFI:
    """reference ``cain/__init__.py:12-63``; recursive-midpoint schedule (the
    model takes no timestep)."""

    MODEL_TYPE = "cain"

    def __init__(self):
        self._model_fns: typing.Dict[tuple, typing.Tuple[dict, typing.Callable]] = {}  # see _cached

    @classmethod
    def INPUT_TYPES(cls):
        return _base_inputs(cain_model.CKPT_NAMES)

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "vfi"
    CATEGORY = "ComfyUI-Frame-Interpolation/VFI"

    def vfi(
        self,
        ckpt_name: str,
        frames,
        clear_cache_after_n_frames: int = 10,
        multiplier=2,
        optional_interpolation_states: InterpolationStateList = None,
        params: dict = None,  # extension: inject a state dict
        batch_size: int = 4,
        dtype: str = "float32",
        device=None,  # extension: torch device (default: config "device")
        **kwargs,
    ):
        return _midpoint_vfi(
            self, cain_model, "CAIN", ckpt_name, frames, multiplier, optional_interpolation_states, params, batch_size,
            dtype, device,
        )


class SepconvVFI:
    """reference ``sepconv/__init__.py:13-57``; recursive-midpoint schedule
    (the model takes no timestep). Upstream asserts frames of at most
    1280x720; the JAX node does not, and neither does this one."""

    MODEL_TYPE = "sepconv"

    def __init__(self):
        self._model_fns: typing.Dict[tuple, typing.Tuple[dict, typing.Callable]] = {}  # see _cached

    @classmethod
    def INPUT_TYPES(cls):
        return _base_inputs(sepconv_model.CKPT_NAMES, batch_default=2)

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "vfi"
    CATEGORY = "ComfyUI-Frame-Interpolation/VFI"

    def vfi(
        self,
        ckpt_name: str,
        frames,
        clear_cache_after_n_frames: int = 10,
        multiplier=2,
        optional_interpolation_states: InterpolationStateList = None,
        params: dict = None,  # extension: inject a state dict
        batch_size: int = 2,
        dtype: str = "float32",
        device=None,  # extension: torch device (default: config "device")
        **kwargs,
    ):
        return _midpoint_vfi(
            self, sepconv_model, "Sepconv", ckpt_name, frames, multiplier, optional_interpolation_states, params,
            batch_size, dtype, device,
        )


class MOMO_VFI:
    """reference ``momo/__init__.py:77-165``; bisection schedule, 2x only;
    each model call edge-pads to multiples of 64, centred (inside the model
    callable).

    The DDPM loop's noise comes from ``torch.Generator(device)`` seeded with
    ``seed`` at every call (the reference draws from torch's global generator
    and is not run-to-run deterministic); torch cannot draw JAX's bits, so for
    one seed the frames differ from the JAX node's."""

    MODEL_TYPE = "momo"

    def __init__(self):
        self._model_fns: typing.Dict[tuple, typing.Tuple[dict, typing.Callable]] = {}  # see _cached

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "ckpt_name": (momo_model.CKPT_NAMES,),
                "frames": ("IMAGE",),
                "clear_cache_after_n_frames": ("INT", {"default": 10, "min": 1, "max": 1000}),
                "multiplier": ("INT", {"default": 2, "min": 2, "max": 2}),
                "num_inference_steps": ("INT", {"default": 8, "min": 2, "max": 20}),
                **_batch_dtype_inputs(1),
            },
            **_OPTIONAL,
        }

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "vfi"
    CATEGORY = "ComfyUI-Frame-Interpolation/VFI"

    def vfi(
        self,
        ckpt_name: str,
        frames,
        clear_cache_after_n_frames: int = 10,
        multiplier=2,
        num_inference_steps: int = 8,
        optional_interpolation_states: InterpolationStateList = None,
        params: dict = None,  # extension: inject a state dict
        batch_size: int = 1,
        dtype: str = "float32",
        seed: int = 0,
        device=None,  # extension: torch device (default: config "device")
        **kwargs,
    ):
        device = torch.device(device or load_config()["device"])
        frames = preprocess_frames(frames, device)
        assert_batch_size(frames, 2, "MoMo")
        if params is None:
            params = get_converted_params(self.MODEL_TYPE, ckpt_name)
        model_fn = _cached(
            self._model_fns, params, (ckpt_name, num_inference_steps, seed, dtype, str(device)),
            lambda: momo_model.make_model_fn(
                params, ckpt_name, num_inference_steps=num_inference_steps, seed=seed, dtype=DTYPE_MAP[dtype],
                device=device,
            ),
        )
        plan = plan_bisection(frames.shape[0], multiplier, optional_interpolation_states)
        out = run_plan(frames, plan, model_fn, batch_size=batch_size)
        return (postprocess_frames(out),)
