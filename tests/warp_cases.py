"""Flow cases for the warp kernel and its plain twin, in numpy only (no jax,
no torch), so the CPU tests, the GPU tests and ``chip_smoke.py`` share them.

They re-create the flow generators of ``tests/test_pallas_kernels.py:63-197``
at any frame size: smooth and moderate flows, a +-120/+-30 discontinuity,
extreme x400 random flows, a large constant offset, an odd shape, a wide
channel count and non-finite flow in zeros mode. Images are uniform in
[0, 1], the range the stated tolerances refer to.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

BORDER_ZEROS = ("border", "zeros")


def smooth_flow(b: int, h: int, w: int, amp: float, scale: float = 200.0) -> np.ndarray:
    gy, gx = np.mgrid[0:h, 0:w]
    base = np.stack(
        [
            amp * np.sin(gx / scale) + 0.5 * amp * np.cos(gy / scale),
            -amp * np.cos(gx / scale) + 0.4 * amp * np.sin(gy / scale),
        ],
        axis=-1,
    ).astype(np.float32)
    return np.broadcast_to(base, (b, h, w, 2)).copy()


def warp_cases(seed: int, h: int, w: int) -> List[Dict]:
    """``[{"name", "img" [B,H,W,C] f32, "flow" [B,H,W,2] f32, "modes"}]``;
    the odd-shape case keeps its own 137x261 frame."""
    rng = np.random.default_rng(seed)

    def img(b, hh, ww, c):
        return rng.random((b, hh, ww, c), dtype=np.float32)

    disc = np.zeros((2, h, w, 2), np.float32)
    disc[:, :, : w // 2] = [120.0, 30.0]
    disc[:, :, w // 2 :] = [-120.0, -30.0]
    nonfinite = smooth_flow(1, h, w, amp=2.0)
    nonfinite[0, h // 4, w // 4] = np.nan
    nonfinite[0, h // 2, (3 * w) // 4, 0] = np.inf
    return [
        dict(name="smooth_amp0.4", img=img(2, h, w, 7), flow=smooth_flow(2, h, w, 0.4), modes=BORDER_ZEROS),
        dict(name="moderate_amp20", img=img(2, h, w, 7), flow=smooth_flow(2, h, w, 20.0, 60.0), modes=BORDER_ZEROS),
        dict(name="discontinuity", img=img(2, h, w, 3), flow=disc, modes=BORDER_ZEROS),
        dict(
            name="extreme_x400",
            img=img(2, h, w, 3),
            flow=(rng.standard_normal((2, h, w, 2)) * 400.0).astype(np.float32),
            modes=BORDER_ZEROS,
        ),
        dict(
            name="constant_offset",
            img=img(1, h, w, 3),
            flow=smooth_flow(1, h, w, 0.3) + np.array([300.0, -150.0], np.float32),
            modes=BORDER_ZEROS,
        ),
        dict(
            name="odd_137x261_c5",
            img=img(1, 137, 261, 5),
            flow=(rng.standard_normal((1, 137, 261, 2)) * 3.0).astype(np.float32),
            modes=BORDER_ZEROS,
        ),
        dict(
            name="wide_c40",
            img=img(1, h, w, 40),
            flow=(rng.standard_normal((1, h, w, 2)) * 4.0).astype(np.float32),
            modes=BORDER_ZEROS,
        ),
        dict(name="nonfinite", img=img(1, h, w, 3), flow=nonfinite, modes=("zeros",)),
    ]
