"""Frames per second of the three ported models on one CUDA card, for the
port found under ``--root``, so that two checkouts can be compared in turns
in one session on one card.

Run on the machine with the card, as a script (it imports the package from
``--root``, not from its own checkout)::

    python comfyui_frame_interpolation_tpu_torch/utils/e2e_fps.py --root build/parent

It prints one JSON line: the card and its power limit, and frames/s of RIFE
4.7 1080p 2x bf16 batch 8 (fast mode, no ensemble), M2M 1080p 2x bf16 batch 2
and FILM 1080p 2x bf16 batch 2, random frames and random weights from seed 0
(the configurations of ``chip_smoke.py`` phases 6, 10 and 14), each through
``make_model_fn`` and timed by ``utils.benchmark.measure``.
"""

import argparse
import json
import os
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the checkout whose port is timed")
    ap.add_argument("--label", default="", help="a name for this run in the output")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from comfyui_frame_interpolation_tpu_torch.models import film, m2m, rife
    from comfyui_frame_interpolation_tpu_torch.utils.benchmark import measure

    if not torch.cuda.is_available():
        print("e2e_fps: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    def frames(n):
        f0 = torch.from_numpy(np.random.default_rng(0).random((n, 1080, 1920, 3), dtype=np.float32)).to(dev)
        f1 = torch.from_numpy(np.random.default_rng(1).random((n, 1080, 1920, 3), dtype=np.float32)).to(dev)
        return f0, f1, torch.full((n,), 0.5, device=dev)

    fns = {
        "rife_1080p_b8": (8, lambda: rife.make_model_fn(
            rife.init_params(0, "4.7"), "4.7", fastmode=True, ensemble=False, dtype=torch.bfloat16, device=dev), 10),
        "m2m_1080p_b2": (2, lambda: m2m.make_model_fn(m2m.init_params(0), dtype=torch.bfloat16, device=dev), 5),
        "film_1080p_b2": (2, lambda: film.make_model_fn(film.init_params(0), dtype=torch.bfloat16, device=dev), 5),
    }
    fps = {}
    for name, (n, make, iters) in fns.items():
        fn = make()
        fps[name] = n / measure(fn, *frames(n), iters=iters, rounds=3)
        del fn
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "root": args.root, "card": smi, "frames_per_s": fps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
