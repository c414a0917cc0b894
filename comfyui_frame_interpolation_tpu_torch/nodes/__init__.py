"""Node layer: ComfyUI-compatible node classes (reference L5), ported one
family at a time. Each follows the reference protocol: classmethod
``INPUT_TYPES()``, ``RETURN_TYPES = ("IMAGE",)``, ``FUNCTION = "vfi"`` and
``CATEGORY = "ComfyUI-Frame-Interpolation/VFI"``; ``vfi`` consumes and returns
NHWC torch tensors."""

from .rife_node import RIFE_VFI
from .vfi_nodes import (
    AMT_VFI, ATM_VFI, EISAI_VFI, FILM_VFI, FLAVR_VFI, GMFSS_Fortuna_VFI, IFRNet_VFI, IFUnet_VFI, M2M_VFI, STMFNet_VFI,
    XVFI_VFI,
)

NODE_CLASS_MAPPINGS = {
    "RIFE VFI": RIFE_VFI,
    "M2M VFI": M2M_VFI,
    "FILM VFI": FILM_VFI,
    "GMFSS Fortuna VFI": GMFSS_Fortuna_VFI,
    "EISAI VFI": EISAI_VFI,
    "STMFNet VFI": STMFNet_VFI,
    "FLAVR VFI": FLAVR_VFI,
    "IFRNet VFI": IFRNet_VFI,
    "IFUnet VFI": IFUnet_VFI,
    "AMT VFI": AMT_VFI,
    "ATM VFI": ATM_VFI,
    "XVFI VFI": XVFI_VFI,
}
NODE_DISPLAY_NAME_MAPPINGS = {
    "RIFE VFI": "RIFE VFI (recommend rife47 and rife49)",
    "M2M VFI": "M2M VFI",
    "FILM VFI": "FILM VFI",
    "GMFSS Fortuna VFI": "GMFSS Fortuna VFI",
    "EISAI VFI": "EISAI VFI",
    "STMFNet VFI": "STMFNet VFI",
    "FLAVR VFI": "FLAVR VFI",
    "IFRNet VFI": "IFRNet VFI",
    "IFUnet VFI": "IFUnet VFI",
    "AMT VFI": "AMT VFI",
    "ATM VFI": "ATM VFI",
    "XVFI VFI": "XVFI VFI",
}
