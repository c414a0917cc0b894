"""Frames per second of the ported models on one CUDA card, for the
port found under ``--root``, so that two checkouts can be compared in turns
in one session on one card.

Run on the machine with the card, as a script (it imports the package from
``--root``, not from its own checkout)::

    python comfyui_frame_interpolation_tpu_torch/utils/e2e_fps.py --root build/parent

It prints one JSON line: the card and its power limit, and frames/s of RIFE
4.7 1080p 2x bf16 batch 8 (fast mode, no ensemble), M2M 1080p 2x bf16 batch 2,
FILM 1080p 2x bf16 batch 2, GMFSS Fortuna 1080p 2x bf16 batch 1, base and
union, EISAI 540p (its native 540x960) 2x bf16 batch 1 with 12 RAFT
iterations, STMFNet 1080p 2x bf16 batch 1 and FLAVR 1080p 2x bf16 batch 2
(a window of four frames per interpolated frame), IFRNet S 1080p 2x bf16
batch 4, IFUnet 1080p 2x bf16 batch 2 without the ensemble, AMT-S 1080p
(padded to 1088x1920, as its node pads) 2x bf16 batch 2, ATM base 1080p 2x
bf16 batch 1 with global motion, XVFI Vimeo 1080p 2x bf16 batch 2 (a
reuse and an infer of ``make_pair_fns`` per pair batch), CAIN 1080p 2x bf16
batch 4, Sepconv 720p 2x bf16 batch 2 and MoMo base 1080p (padded to
1088x1920) 2x bf16 batch 1 with 8 steps, random frames and random weights
from seed 0 (the configurations of ``chip_smoke.py`` phases 6, 10, 14, 18,
22, 26, 27, 30, 32, 34, 37, 39, 41, 43 and 46), each through
``make_model_fn`` (XVFI's pair functions) and timed by
``utils.benchmark.measure``. A model missing from the checkout timed (an
older port) is left out of the line.
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

    import importlib

    from comfyui_frame_interpolation_tpu_torch.models import eisai, film, gmfss, m2m, rife
    from comfyui_frame_interpolation_tpu_torch.utils.benchmark import measure

    found = {}
    for name in ("stmfnet", "flavr", "ifrnet", "ifunet", "amt", "atm", "xvfi", "cain", "sepconv", "momo"):
        try:
            found[name] = importlib.import_module(f"comfyui_frame_interpolation_tpu_torch.models.{name}")
        except ImportError:
            pass
    window4 = {k: v for k, v in found.items() if k in ("stmfnet", "flavr")}

    if not torch.cuda.is_available():
        print("e2e_fps: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    def frames(n, hw=(1080, 1920), window=False):
        """A pair and its timesteps, or the four frames of a window."""
        fs = [torch.from_numpy(np.random.default_rng(i).random((n, *hw, 3), dtype=np.float32)).to(dev) for i in range(4 if window else 2)]
        return fs if window else (*fs, torch.full((n,), 0.5, device=dev))

    fns = {
        "rife_1080p_b8": (8, lambda: rife.make_model_fn(
            rife.init_params(0, "4.7"), "4.7", fastmode=True, ensemble=False, dtype=torch.bfloat16, device=dev), 10),
        "m2m_1080p_b2": (2, lambda: m2m.make_model_fn(m2m.init_params(0), dtype=torch.bfloat16, device=dev), 5),
        "film_1080p_b2": (2, lambda: film.make_model_fn(film.init_params(0), dtype=torch.bfloat16, device=dev), 5),
        "gmfss_1080p_b1": (1, lambda: gmfss.make_model_fn(gmfss.init_params(0), dtype=torch.bfloat16, device=dev), 5),
        "gmfss_union_1080p_b1": (1, lambda: gmfss.make_model_fn(
            gmfss.init_params(0, union=True), union=True, dtype=torch.bfloat16, device=dev), 5),
        "eisai_540p_b1": (1, lambda: eisai.make_model_fn(eisai.init_params(0), dtype=torch.bfloat16, device=dev), 5),
    }
    batch = {"stmfnet": 1, "flavr": 2}
    for name, mod in window4.items():
        fns[f"{name}_1080p_b{batch[name]}"] = (
            batch[name], lambda mod=mod: mod.make_model_fn(mod.init_params(0), dtype=torch.bfloat16, device=dev), 3,
        )
    bf16 = torch.bfloat16
    if "ifrnet" in found:
        ifrnet = found["ifrnet"]
        fns["ifrnet_1080p_b4"] = (4, lambda: ifrnet.make_model_fn(ifrnet.init_params("S", 0), "S", dtype=bf16, device=dev), 5)
    if "ifunet" in found:
        ifunet = found["ifunet"]
        fns["ifunet_1080p_b2"] = (2, lambda: ifunet.make_model_fn(ifunet.init_params(0), dtype=bf16, device=dev), 3)
    if "amt" in found:
        amt = found["amt"]
        fns["amt_s_1080p_b2"] = (2, lambda: amt.make_model_fn(amt.init_params("S", 0), "amt-s.pth", dtype=bf16, device=dev), 5)
    if "atm" in found:
        atm = found["atm"]
        fns["atm_base_1080p_b1"] = (1, lambda: atm.make_model_fn(atm.init_params("base", 0), "base", dtype=bf16, device=dev), 5)
    if "xvfi" in found:
        xvfi = found["xvfi"]

        def xvfi_fn(ckpt="XVFInet_Vimeo_exp1_latest.pt"):
            reuse, infer = xvfi.make_pair_fns(xvfi.init_params(ckpt, 0), ckpt, dtype=bf16, device=dev)
            return lambda f0, f1, t: infer(f0, f1, reuse(f0, f1), t)

        fns["xvfi_vimeo_1080p_b2"] = (2, xvfi_fn, 5)
    if "cain" in found:
        cain = found["cain"]
        fns["cain_1080p_b4"] = (4, lambda: cain.make_model_fn(cain.init_params(0), dtype=bf16, device=dev), 3)
    if "sepconv" in found:
        sepconv = found["sepconv"]
        fns["sepconv_720p_b2"] = (2, lambda: sepconv.make_model_fn(sepconv.init_params(0), dtype=bf16, device=dev), 3)
    if "momo" in found:
        momo = found["momo"]
        fns["momo_base_1080p_b1"] = (1, lambda: momo.make_model_fn(
            momo.init_params(0, "momo-base.pth"), "momo-base.pth", 8, 0, dtype=bf16, device=dev), 3)
    fps = {}
    for name, (n, make, iters) in fns.items():
        fn = make()
        hw = {"eisai": (540, 960), "amt": (1088, 1920), "sepconv": (720, 1280)}.get(name.split("_")[0], (1080, 1920))
        fps[name] = n / measure(fn, *frames(n, hw, window=name.split("_")[0] in window4), iters=iters, rounds=3)
        del fn
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "root": args.root, "card": smi, "frames_per_s": fps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
