"""PyTorch/CUDA port of ``comfyui_frame_interpolation_tpu`` for NVIDIA Hopper.

The same nodes, schedules and models as the JAX package, written in PyTorch,
with the JAX package's hand-written TPU kernels replaced by hand-written CUDA
kernels for ``sm_90a`` (``csrc/``, built with ``nvcc`` at first use). Public
functions keep the JAX package's NHWC layout; CPU tensors take each kernel's
plain PyTorch twin, so the package imports and runs on a machine with no GPU.

Ported: all 18 of the JAX package's nodes (the RIFE VFI node at every
arch of the JAX package, 4.0 to 4.26; the M2M, FILM, GMFSS Fortuna (base
and union), EISAI, STMFNet, FLAVR, IFRNet, IFUnet, AMT, ATM, XVFI, CAIN,
Sepconv and MoMo VFI nodes; the three non-VFI nodes) end to end, with the
backward-warp (narrow-channel K1 and wide-channel) and forward-splat
kernels and their backward kernels; the resident and streaming executors;
training of all 15 model families through ``parallel/``, whose ``(data,
space)`` mesh splits the batch over ``data`` and, on the ``space`` axis,
the rows of RIFE (every arch, inference; 4.7's training step), M2M's and
XVFI Vimeo's pair-cached inference, FILM, IFRNet, AMT and IFUnet.
``ROADMAP.md`` lists what is still to be ported (the ``space`` axis of the
other families).
"""

from . import core, ops
from .nodes import NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS

__version__ = "0.1.0"
