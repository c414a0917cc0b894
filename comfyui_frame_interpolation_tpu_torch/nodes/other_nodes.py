"""Non-VFI node, port of the JAX package's ``nodes/other_nodes.py``
(reference ``other_nodes.py``).

``Gradually_More_Denoise_KSampler`` (reference ``other_nodes.py:40-88``) is
orchestration around the ComfyUI host's KSampler: over a batch of latents,
each latent is sampled ``denoise_increment_steps`` times with a denoise
strength rising linearly. The sampling is the host's diffusion pipeline
(``comfy.sample.sample``), which is not part of this package: the node keeps
the reference's validation, per-latent expansion, denoise schedule and output
packing (``torch.cat`` of the sampled latents) around a sampler bound with
``set_sampler``; without one it raises.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

# comfy.samplers.KSampler.SAMPLERS/SCHEDULERS at the reference's pin; a live
# ComfyUI host overrides these lists through set_sampler(..., samplers=...)
DEFAULT_SAMPLERS = [
    "euler", "euler_ancestral", "heun", "heunpp2", "dpm_2", "dpm_2_ancestral",
    "lms", "dpm_fast", "dpm_adaptive", "dpmpp_2s_ancestral", "dpmpp_sde",
    "dpmpp_sde_gpu", "dpmpp_2m", "dpmpp_2m_sde", "dpmpp_2m_sde_gpu",
    "dpmpp_3m_sde", "dpmpp_3m_sde_gpu", "ddpm", "lcm", "ddim", "uni_pc",
    "uni_pc_bh2",
]
DEFAULT_SCHEDULERS = [
    "normal", "karras", "exponential", "sgm_uniform", "simple", "ddim_uniform",
]


class Gradually_More_Denoise_KSampler:
    """reference ``other_nodes.py:40-88``."""

    _sampler_fn: Optional[Callable] = None
    _samplers = DEFAULT_SAMPLERS
    _schedulers = DEFAULT_SCHEDULERS

    @classmethod
    def set_sampler(cls, sampler_fn: Callable, samplers=None, schedulers=None):
        """Bind the host's ksampler: ``sampler_fn(model, seed, steps, cfg,
        sampler_name, scheduler, positive, negative, latent_dict, denoise) ->
        latent_dict``, the contract of the reference's ``common_ksampler``
        (``other_nodes.py:6-38``)."""
        cls._sampler_fn = staticmethod(sampler_fn)
        if samplers is not None:
            cls._samplers = list(samplers)
        if schedulers is not None:
            cls._schedulers = list(schedulers)

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "positive": ("CONDITIONING",),
                "negative": ("CONDITIONING",),
                "latent_image": ("LATENT",),
                "seed": ("INT", {"default": 0, "min": 0, "max": 0xFFFFFFFFFFFFFFFF}),
                "steps": ("INT", {"default": 20, "min": 1, "max": 10000}),
                "cfg": ("FLOAT", {"default": 8.0, "min": 0.0, "max": 100.0}),
                "sampler_name": (cls._samplers,),
                "scheduler": (cls._schedulers,),
                "start_denoise": ("FLOAT", {"default": 0.0, "min": 0.0, "max": 1.0, "step": 0.01}),
                "denoise_increment": ("FLOAT", {"default": 0.1, "min": 0.0, "max": 1.0, "step": 0.1}),
                "denoise_increment_steps": ("INT", {"default": 20, "min": 1, "max": 10000}),
            },
            "optional": {"optional_vae": ("VAE",)},
        }

    RETURN_TYPES = ("MODEL", "CONDITIONING", "CONDITIONING", "LATENT", "VAE")
    RETURN_NAMES = ("MODEL", "CONDITIONING+", "CONDITIONING-", "LATENT", "VAE")
    OUTPUT_NODE = True
    FUNCTION = "sample"
    CATEGORY = "ComfyUI-Frame-Interpolation/others"

    def sample(
        self, model, positive, negative, latent_image, optional_vae=None,
        seed=0, steps=20, cfg=8.0, sampler_name="euler", scheduler="normal",
        start_denoise=0.0, denoise_increment=0.1, denoise_increment_steps=20,
    ):
        if start_denoise + denoise_increment * denoise_increment_steps > 1.0:
            raise Exception(
                "Max denoise strength can't over 1.0 "
                f"(start_denoise={start_denoise}, "
                f"denoise_increment={denoise_increment}, "
                f"denoise_increment_steps={denoise_increment_steps}"
            )
        if self._sampler_fn is None:
            raise RuntimeError(
                "Gradually_More_Denoise_KSampler needs a host diffusion "
                "sampler: call Gradually_More_Denoise_KSampler.set_sampler() "
                "with the host's ksampler (see reference other_nodes.py:6-38)."
            )

        copied = dict(latent_image)
        out_samples = []
        for latent_sample in copied["samples"]:
            latent = {"samples": latent_sample[None]}  # NCHW, one sample
            for i in range(denoise_increment_steps):
                out = self._sampler_fn(
                    model, seed, steps, cfg, sampler_name, scheduler,
                    positive, negative, latent,
                    denoise=start_denoise + denoise_increment * i,
                )
                out_samples.append(out["samples"])
        copied["samples"] = torch.cat([torch.as_tensor(s) for s in out_samples], 0)
        return (model, positive, negative, copied, optional_vae)
