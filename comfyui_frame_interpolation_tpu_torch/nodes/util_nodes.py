"""Utility nodes, port of the JAX package's ``nodes/util_nodes.py``
(reference ``vfi_utils.py:60-81,391-407``)."""

from ..core.schedule import InterpolationStateList


class MakeInterpolationStateList:
    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "frame_indices": ("STRING", {"multiline": True, "default": "1,2,3"}),
                "is_skip_list": ("BOOLEAN", {"default": True}),
            },
        }

    RETURN_TYPES = ("INTERPOLATION_STATES",)
    FUNCTION = "create_options"
    CATEGORY = "ComfyUI-Frame-Interpolation/VFI"

    def create_options(self, frame_indices: str, is_skip_list: bool):
        return (InterpolationStateList.from_string(frame_indices, is_skip_list),)


class FloatToInt:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"float": ("FLOAT", {"default": 0, "min": 0, "step": 0.01})}}

    RETURN_TYPES = ("INT",)
    FUNCTION = "convert"
    CATEGORY = "ComfyUI-Frame-Interpolation"

    def convert(self, float):
        if hasattr(float, "__iter__"):
            return (list(map(int, float)),)
        return (int(float),)
