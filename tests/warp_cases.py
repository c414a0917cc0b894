"""Flow cases for the warp and splat kernels and their plain twins, in numpy
only (no jax, no torch), so the CPU tests, the GPU tests and ``chip_smoke.py``
share them.

:func:`warp_cases` re-creates the flow generators of
``tests/test_pallas_kernels.py:63-197`` at any frame size: smooth and moderate
flows, a +-120/+-30 discontinuity, extreme x400 random flows, a large constant
offset, an odd shape, a wide channel count and non-finite flow in zeros mode.

:func:`wide_cases` are the feature warps of FILM for the wide-channel kernel:
C = 32 to 960 (FILM's levels have 64, 192, 448 and 960), a C that is no
multiple of 8, a channel slice whose taps start off 16 bytes, extreme and
non-finite flow.

:func:`splat_cases` re-creates the splat cases of
``tests/test_pallas_kernels.py:215-319``: smooth flow, the constant
displacements that took the extra bands and the corners of the single-band
window, the diagonal motion beyond every band, non-finite flow, and the
narrow odd frames; plus huge finite flow (+-1e30), which must drop.

Values are uniform in [0, 1], the range the stated tolerances refer to.
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


WIDE_CHANNELS = (32, 40, 64, 192, 448, 960)


def wide_cases(seed: int, h: int, w: int, channels=WIDE_CHANNELS) -> List[Dict]:
    """``[{"name", "img" [B,H,W,offset+C] f32, "offset", "flow" [B,H,W,2] f32,
    "modes"}]`` at ``h x w``. The warped image is ``img[..., offset:]``, taken
    after the array is on its device: with ``offset`` 1 no tap starts on a
    16-byte boundary."""
    rng = np.random.default_rng(seed)

    def img(b, c):
        return rng.random((b, h, w, c), dtype=np.float32)

    def flow(b, amp=6.0):
        noise = rng.standard_normal((b, h, w, 2)).astype(np.float32) * 1.5
        return smooth_flow(b, h, w, amp, scale=max(8.0, w / 6.0)) + noise

    cases = [dict(name=f"wide_c{c}", img=img(2, c), offset=0, flow=flow(2), modes=BORDER_ZEROS) for c in channels]
    # 46 channels: a tail past the last whole vector (bf16 and f32), and
    # pixel starts that alternate on and off 16 bytes
    cases.append(dict(name="wide_c46", img=img(1, 46), offset=0, flow=flow(1), modes=BORDER_ZEROS))
    cases.append(dict(name="wide_c64_unaligned", img=img(1, 65), offset=1, flow=flow(1), modes=BORDER_ZEROS))
    extreme = (rng.standard_normal((1, h, w, 2)) * 400.0).astype(np.float32)
    cases.append(dict(name="wide_c64_extreme", img=img(1, 64), offset=0, flow=extreme, modes=BORDER_ZEROS))
    nonfinite = flow(1, amp=2.0)
    nonfinite[0, h // 4, w // 4] = np.nan
    nonfinite[0, h // 2, (3 * w) // 4, 0] = np.inf
    nonfinite[0, (3 * h) // 4, w // 2, 1] = -np.inf
    cases.append(dict(name="wide_c64_nonfinite", img=img(1, 64), offset=0, flow=nonfinite, modes=("zeros",)))
    return cases


# the single-band kernel's window (softsplat_kernel.py:47-50: DEF_WIN_H 64,
# DEF_WIN_W 384, DEF_OFF_Y 24, DEF_OFF_X 128): its inclusive displacement
# corners, as test_pallas_kernels.py:233-234 computes them
_WIN_LO = (-(384 - 128 - 128 - 1), -(64 - 24 - 8 - 1))
_WIN_HI = (128 - 1, 24 - 1)


def splat_cases(seed: int, h: int, w: int) -> List[Dict]:
    """``[{"name", "vals" [B,H,W,C] f32, "flow" [B,H,W,2] f32}]`` at
    ``h x w``; the narrow-frame cases keep their own 64x114 and 34x128
    frames, and regions of the hand-placed flows scale with the frame."""
    rng = np.random.default_rng(seed)

    def vals(b, hh, ww, c):
        return rng.random((b, hh, ww, c), dtype=np.float32)

    def const(fx, fy, mixed=False):
        f = np.zeros((1, h, w, 2), np.float32)
        f[..., 0], f[..., 1] = fx, fy
        if mixed:  # plus in-base-band content, test_pallas_kernels.py:270
            f[:, : h // 4] = 2.0
        return f

    cases = [
        dict(name=f"smooth_amp8_c{c}", vals=vals(2, h, w, c), flow=smooth_flow(2, h, w, 8.0))
        for c in (1, 2, 4)
    ]
    for fx, fy in ((0.0, 50.0), (0.0, -60.0), (200.0, 0.0), (-200.0, 0.0)):
        cases.append(dict(name=f"const_{fx:+.0f}_{fy:+.0f}", vals=vals(1, h, w, 2), flow=const(fx, fy, True)))
    for fx, fy in ((_WIN_LO[0], _WIN_LO[1]), (_WIN_HI[0], _WIN_HI[1]), (_WIN_LO[0], _WIN_HI[1])):
        cases.append(dict(name=f"window_corner_{fx:+d}_{fy:+d}", vals=vals(1, h, w, 2), flow=const(fx, fy)))
    diag = np.zeros((1, h, w, 2), np.float32)
    diag[:, h * 100 // 256 : h * 120 // 256, w * 200 // 512 : w * 220 // 512] = [200.0, -150.0]
    diag[:, h * 50 // 256 : h * 60 // 256, w * 50 // 512 : w * 60 // 512] = [1.5, -2.0]
    cases.append(dict(name="diagonal_beyond_bands", vals=vals(1, h, w, 2), flow=diag))
    nonfinite = smooth_flow(1, h, w, 3.0)
    nonfinite[0, h * 50 // 256, w * 50 // 512, 0] = np.inf
    nonfinite[0, h * 60 // 256, w * 60 // 512, 1] = np.nan
    nonfinite[0, h // 2, w // 2] = [-np.inf, np.nan]
    cases.append(dict(name="nonfinite", vals=vals(1, h, w, 2), flow=nonfinite))
    huge = smooth_flow(1, h, w, 3.0)
    huge[0, h // 4, :: max(1, w // 16), 0] = 1e30
    huge[0, h // 3, :: max(1, w // 16), 1] = -1e30
    huge[0, (2 * h) // 3, w // 3] = [-1e30, 1e30]
    cases.append(dict(name="huge_finite", vals=vals(1, h, w, 2), flow=huge))
    for hh, ww, c in ((64, 114, 66), (34, 128, 8)):
        f = ((rng.random((1, hh, ww, 2)) - 0.5) * 8.0).astype(np.float32)
        f[:, :4] = [ww + 50.0, 0.0]  # beyond the clamped window
        cases.append(dict(name=f"narrow_{hh}x{ww}_c{c}", vals=vals(1, hh, ww, c), flow=f))
    return cases
