"""Node layer: ComfyUI-compatible node classes (reference L5), port of the
JAX package's ``nodes/``. Every VFI node follows the reference protocol:
classmethod ``INPUT_TYPES()``, ``RETURN_TYPES = ("IMAGE",)``, ``FUNCTION =
"vfi"`` and ``CATEGORY = "ComfyUI-Frame-Interpolation/VFI"``; ``vfi``
consumes and returns NHWC torch tensors. Besides them: the interpolation
state list and float-to-int utilities and the gradual-denoise KSampler,
which orchestrates a sampler the ComfyUI host binds. Every node of the JAX
package is ported, under the JAX display names and in its order."""

from .other_nodes import Gradually_More_Denoise_KSampler
from .rife_node import RIFE_VFI
from .util_nodes import FloatToInt, MakeInterpolationStateList
from .vfi_nodes import (
    AMT_VFI, ATM_VFI, CAIN_VFI, EISAI_VFI, FILM_VFI, FLAVR_VFI, GMFSS_Fortuna_VFI, IFRNet_VFI, IFUnet_VFI, M2M_VFI,
    MOMO_VFI, STMFNet_VFI, SepconvVFI, XVFI_VFI,
)

NODE_CLASS_MAPPINGS = {
    "RIFE VFI": RIFE_VFI,
    "FILM VFI": FILM_VFI,
    "IFRNet VFI": IFRNet_VFI,
    "CAIN VFI": CAIN_VFI,
    "M2M VFI": M2M_VFI,
    "Sepconv VFI": SepconvVFI,
    "AMT VFI": AMT_VFI,
    "FLAVR VFI": FLAVR_VFI,
    "IFUnet VFI": IFUnet_VFI,
    "STMFNet VFI": STMFNet_VFI,
    "GMFSS Fortuna VFI": GMFSS_Fortuna_VFI,
    "ATM VFI": ATM_VFI,
    "MOMO VFI": MOMO_VFI,
    "EISAI VFI": EISAI_VFI,
    "XVFI VFI": XVFI_VFI,
    "Make Interpolation State List": MakeInterpolationStateList,
    "VFI FloatToInt": FloatToInt,
    "KSampler Gradually Adding More Denoise (efficient)": Gradually_More_Denoise_KSampler,
}
NODE_DISPLAY_NAME_MAPPINGS = {
    "RIFE VFI": "RIFE VFI (recommend rife47 and rife49)",
    "FILM VFI": "FILM VFI",
    "IFRNet VFI": "IFRNet VFI",
    "CAIN VFI": "CAIN VFI",
    "M2M VFI": "M2M VFI",
    "Sepconv VFI": "Sepconv VFI",
    "AMT VFI": "AMT VFI",
    "FLAVR VFI": "FLAVR VFI",
    "IFUnet VFI": "IFUnet VFI",
    "STMFNet VFI": "STMFNet VFI",
    "GMFSS Fortuna VFI": "GMFSS Fortuna VFI",
    "ATM VFI": "ATM VFI",
    "MOMO VFI": "MOMO VFI",
    "EISAI VFI": "EISAI VFI",
    "XVFI VFI": "XVFI VFI",
    "Make Interpolation State List": "Make Interpolation State List",
    "VFI FloatToInt": "VFI FloatToInt",
    "KSampler Gradually Adding More Denoise (efficient)": "KSampler Gradually Adding More Denoise (efficient)",
}


def register(name: str, cls, display_name: str = None) -> None:
    """Add a node class under ``name`` (and ``display_name``, default the name)."""
    NODE_CLASS_MAPPINGS[name] = cls
    NODE_DISPLAY_NAME_MAPPINGS[name] = display_name or name
