from .ckpt import params_from_jax
