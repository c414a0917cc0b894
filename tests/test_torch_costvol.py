"""The port's cost volume against the JAX package's ``costvol_func`` and the
loop oracle of ``tests/test_ops_custom.py``, on the CPU (fp32, atol 1e-6: the
same 81 shifted means, summed over C in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.ops.costvol import costvol_func as jax_costvol
from comfyui_frame_interpolation_tpu_torch.ops.costvol import costvol_func
from test_ops_custom import costvol_oracle
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

ATOL = 1e-6


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("shape", [(2, 17, 30, 32), (1, 4, 8, 3), (2, 1, 2, 32)])
def test_costvol_matches_jax(shape):
    rng = np.random.default_rng(0)
    one = rng.random(shape, dtype=np.float32)
    two = rng.random(shape, dtype=np.float32)
    got = costvol_func(_nchw(one), _nchw(two))
    assert tuple(got.shape) == (shape[0], 81, shape[1], shape[2])
    assert got.is_contiguous(memory_format=torch.channels_last)
    ref = np.asarray(jax_costvol(jnp.asarray(one), jnp.asarray(two)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=ATOL, rtol=0)


def test_costvol_matches_loop_oracle():
    rng = np.random.default_rng(42)
    one = rng.standard_normal((1, 6, 7, 4)).astype(np.float32)
    two = rng.standard_normal((1, 6, 7, 4)).astype(np.float32)
    got = costvol_func(_nchw(one), _nchw(two)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, costvol_oracle(one, two), atol=1e-5, rtol=0)
