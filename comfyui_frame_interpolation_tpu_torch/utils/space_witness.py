"""The ``space`` axis's training step in f64: a witness that the gap
between a RIFE 4.7 step on a ``(1, 2)`` mesh and on ``(1, 1)`` is rounding,
not a fault of the row split.

One ``parallel.make_train_step`` step (Adam 1e-4) of RIFE 4.7
(``init_params(0)``) on ``chip_smoke.py``'s phase-74 batch (b16 x 224x224,
numpy seed 74: two bands of 128 rows after RIFE's pad to 256, the pad in
the last), on a ``(1, 1)`` mesh and on a ``(1, 2)`` mesh of logical
replicas of one device:

* on the CPU in f64 (the warp's twins sum in f64 for an f64 image): a
  fault of the split would show here as it does in f32, rounding would not;
* on the CPU in f32;
* with a card, in f32 on replicas of ``cuda:0`` through the kernels, TF32
  off and cuDNN's deterministic algorithms (phase 74's setting).

For each f32 step, each gradient's distance from the f64 ``(1, 1)``
step's, over that tensor's largest magnitude; for each dtype and device,
the ``(1, 2)`` step's gap from the ``(1, 1)`` step's in the same measure.
Prints one JSON line (with the process's peak host memory), and writes
it to ``--out`` if given::

    python -m comfyui_frame_interpolation_tpu_torch.utils.space_witness --out chiprun_out/space_witness.json

``--batch`` and ``--hw`` shrink the batch (the tests run it at 2 x
136x64, where RIFE's pad lands in the last band too); ``--no-card`` skips
the card.
"""

from __future__ import annotations

import argparse
import json
import resource
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import parallel
from ..models import rife
from ..models.common import cast_params

__all__ = ["main", "train_step_grads", "witness"]

FOCUS = "block3.convblock.4.beta"  # the tensor whose f32 gap is largest on the card at b16 x 224^2


def _batch(b: int, hw: Tuple[int, int], seed: int, device, dtype):
    """``chip_smoke.py:train_batch``'s ``(f0, f1, t, target)``."""
    rng = np.random.default_rng(seed)
    f0, f1, target = (torch.from_numpy(rng.random((b, *hw, 3), dtype=np.float32)).to(device, dtype) for _ in range(3))
    t = torch.from_numpy(rng.uniform(0.1, 0.9, b).astype(np.float32)).to(device, dtype)
    return f0, f1, t, target


def train_step_grads(
    device: torch.device, dtype: torch.dtype, replicas: int, b: int, hw: Tuple[int, int], seed: int = 74
) -> Tuple[float, Dict[str, torch.Tensor]]:
    """One step on ``make_mesh(replicas)`` of logical replicas of
    ``device``: ``(loss, {name: gradient on the CPU})``."""
    net = rife.IFNet("4.7")
    net.load_state_dict(cast_params(rife.init_params(0, "4.7"), dtype), strict=True)
    net = net.to(device=device, dtype=dtype, memory_format=torch.channels_last)
    scale_list = rife.default_scale_list("4.7")
    mesh = parallel.make_mesh(replicas, devices=[device] * replicas)
    step = parallel.make_train_step(
        lambda n, f0, f1, t: rife.apply(n, f0, f1, t, scale_list), torch.optim.Adam(net.parameters(), lr=1e-4), mesh, net
    )
    loss = float(step(*_batch(b, hw, seed, device, dtype)))
    return loss, {k: v.grad.detach().to("cpu", torch.float64) for k, v in net.named_parameters()}


def _rel(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Per tensor, the largest error over the tensor's largest magnitude."""
    return {k: float((got[k] - r).abs().max() / max(float(r.abs().max()), 1e-300)) for k, r in ref.items()}


def _summary(rel: Dict[str, float]) -> dict:
    worst = max(rel, key=rel.get)
    return {"max": rel[worst], "worst": worst, FOCUS: rel.get(FOCUS)}


def witness(b: int = 16, hw: Tuple[int, int] = (224, 224), card: bool = True) -> dict:
    """The steps of the module docstring: their losses and seconds, the
    ``split_gap`` of each dtype and device, each f32 step's distance
    ``from_f64``, and the peak host memory."""
    cpu = torch.device("cpu")
    runs = [("cpu f64", cpu, torch.float64), ("cpu f32", cpu, torch.float32)]
    if card and torch.cuda.is_available():
        runs.append(("cuda f32", torch.device("cuda", 0), torch.float32))
    grads, losses, seconds = {}, {}, {}
    for name, device, dtype in runs:
        on_card = device.type == "cuda"
        if on_card:
            saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.deterministic
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.deterministic = True
        try:
            for replicas in (1, 2):
                t0 = time.perf_counter()
                key = f"{name} {'(1, 1)' if replicas == 1 else '(1, 2)'}"
                losses[key], grads[key] = train_step_grads(device, dtype, replicas, b, hw)
                seconds[key] = time.perf_counter() - t0
        finally:
            if on_card:
                (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.deterministic) = saved
    ref = grads["cpu f64 (1, 1)"]
    return {
        "batch": [b, *hw],
        "losses": losses,
        "seconds": seconds,
        "split_gap": {name: _summary(_rel(grads[f"{name} (1, 2)"], grads[f"{name} (1, 1)"])) for name, _, _ in runs},
        "from_f64": {k: _summary(_rel(g, ref)) for k, g in grads.items() if not k.startswith("cpu f64")},
        "host_peak_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--hw", type=int, nargs=2, default=(224, 224))
    ap.add_argument("--no-card", action="store_true", help="CPU runs only")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args(argv)
    result = witness(args.batch, tuple(args.hw), card=not args.no_card)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
