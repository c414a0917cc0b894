"""The port's frame conventions against the JAX package's ``core/frames.py``."""

import numpy as np
import pytest
import torch

from comfyui_frame_interpolation_tpu.core import frames as jframes
from comfyui_frame_interpolation_tpu_torch.core import frames as pframes
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)


@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate"])
@pytest.mark.parametrize("shape,multiple", [((2, 37, 50, 3), 16), ((1, 64, 64, 4), 32), ((1, 20, 33, 3), 8)])
def test_pad_to_multiple_and_unpad(mode, shape, multiple):
    x = np.random.default_rng(0).random(shape, dtype=np.float32)
    ref, ref_hw = jframes.pad_to_multiple(x, multiple, mode)
    got, got_hw = pframes.pad_to_multiple(torch.from_numpy(x), multiple, mode)
    assert got_hw == ref_hw
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(pframes.unpad(got, got_hw).numpy(), x)


def test_pad_size_and_bad_mode():
    for h, w, m in ((540, 960, 64), (64, 64, 64), (1, 1, 8)):
        assert pframes.pad_size(h, w, m) == jframes.pad_size(h, w, m)
    with pytest.raises(ValueError):
        pframes.pad_to_multiple(torch.zeros(1, 5, 5, 3), 4, "wrap")


def test_pre_post_process_and_batch_check():
    x = np.random.default_rng(1).random((3, 8, 12, 4), dtype=np.float32)
    got = pframes.preprocess_frames(x, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jframes.preprocess_frames(x)))
    assert pframes.postprocess_frames(got.to(torch.bfloat16)).dtype == torch.float32
    with pytest.raises(ValueError):
        pframes.preprocess_frames(x[0], "cpu")
    with pytest.raises(ValueError, match="at least 2 frames"):
        pframes.assert_batch_size(got[:1], 2, "RIFE")
    pframes.assert_batch_size(got, 2, "RIFE")
