"""Flow cases for the warp and splat kernels and their plain twins, in numpy
only (no jax, no torch), so the CPU tests, the GPU tests and ``chip_smoke.py``
share them.

:func:`warp_cases` re-creates the flow generators of
``tests/test_pallas_kernels.py:63-197`` at any frame size: smooth and moderate
flows, a +-120/+-30 discontinuity, extreme x400 random flows, a large constant
offset, an odd shape, a wide channel count and non-finite flow in zeros mode.

Added for K1's tiled body and its routing: a frame whose top half has
smooth flow (a tile's taps stay close together) and whose bottom half sends
the pixels of each tile across most of the frame (``box_overflow_half``: the
taps' bounding box of a tile spans the frame), a 68x92 frame that the 4x32
tiles do not divide, and M2M's feature widths (C = 32, 48, 96, 192, 384) in
zeros mode, which the routing rule sends to the wide kernel.

:func:`wide_cases` are the feature warps for the wide-channel kernel: C = 32
to 960 (FILM's levels have 64, 192, 448 and 960), the narrow feature widths
of RIFE 4.0's Contextnet, IFRNet and AMT (C = 16, 20, 24, 36, 44, 54), a
width for each vector the kernel picks in bf16 where those lack one (C = 18:
36-byte pixels, 4-byte vectors; C = 21: 42-byte pixels, read an element at a
time), a C that is no multiple of 8, a channel slice whose taps start off 16
bytes, extreme and non-finite flow.

:func:`bound_flow` puts samples exactly on each bound of the frame, where
the border clamp's derivative is JAX's 0.5, for the warp's gradient.

:func:`backward_cases` are the cases of the warp's backward kernel, which
merges the taps that neighbouring pixels share before its atomics and adds
them into a buffer whose channels are padded to a multiple of 4: every
width the padding and the channel groups meet (C = 1, 2, 3, 4, 5, 7, 8, 9,
16, 40), ragged frames that end in the middle of its 32x8 tiles (68x92,
137x261), integer and half-pixel constant offsets (every pair of
neighbours merges; the integer one leaves three taps of weight 0), rough
(+-40 px) and discontinuous flow (few merge), and a pile whose 16x16
blocks of pixels all sample one point (256 samples on each of its four
taps).

:func:`splat_cases` re-creates the splat cases of
``tests/test_pallas_kernels.py:215-319``: smooth flow, the constant
displacements that took the extra bands and the corners of the single-band
window, the diagonal motion beyond every band, non-finite flow, and the
narrow odd frames; plus huge finite flow (+-1e30), which must drop; plus,
for the splat kernel's merges of the corners that neighbouring sources
share, flows that pile 16 sources onto each target and a rough flow (+-40
px) whose neighbours seldom share a corner.

:func:`splat_backward_cases` add, for the splat's backward kernel, the
widths of its lane groups and channel tails (C = 3, 5, 8, 65), integer and
half-pixel constant offsets, and targets exactly on and just off each bound
(:func:`splat_bound_flow`).

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
    # top half smooth (a tile's taps stay close), bottom half +-0.3 of the
    # frame in a checkerboard of 4x4 blocks (a tile's taps span most of it)
    overflow = smooth_flow(1, h, w, amp=3.0)
    gy, gx = np.mgrid[h // 2 : h, 0:w]
    sign = np.where((gx // 4 + gy // 4) % 2 == 0, 1.0, -1.0).astype(np.float32)
    overflow[0, h // 2 :, :, 0] = sign * 0.3 * w
    overflow[0, h // 2 :, :, 1] = -sign * 0.3 * h
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
        dict(name="box_overflow_half", img=img(1, h, w, 7), flow=overflow, modes=BORDER_ZEROS),
        dict(
            name="ragged_68x92_c7",
            img=img(2, 68, 92, 7),
            flow=(rng.standard_normal((2, 68, 92, 2)) * 3.0).astype(np.float32),
            modes=BORDER_ZEROS,
        ),
    ] + [
        dict(
            name=f"m2m_c{c}_zeros",
            img=img(1, h, w, c),
            flow=smooth_flow(1, h, w, 6.0, 60.0) + (rng.standard_normal((1, h, w, 2)) * 1.5).astype(np.float32),
            modes=("zeros",),
        )
        for c in M2M_CHANNELS
    ]


def bound_flow(b: int, h: int, w: int) -> np.ndarray:
    """``[b, h, w, 2]`` flow whose samples lie exactly on a bound of the
    frame: zero flow in the first fifth of the rows (the frame's own first
    and last columns, and row 0), then bands of rows sent to x = 0, x = w - 1,
    y = 0 (with x off the pixel grid) and y = h - 1."""
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    flow = np.zeros((h, w, 2), np.float32)
    q = h // 5
    flow[q : 2 * q, :, 0] = -gx[q : 2 * q]
    flow[2 * q : 3 * q, :, 0] = (w - 1) - gx[2 * q : 3 * q]
    flow[3 * q : 4 * q, :, 1] = -gy[3 * q : 4 * q]
    flow[3 * q : 4 * q, :, 0] = 0.25
    flow[4 * q :, :, 1] = (h - 1) - gy[4 * q :]
    return np.broadcast_to(flow, (b, h, w, 2)).copy()


BACKWARD_CHANNELS = (1, 2, 3, 4, 5, 7, 8, 9, 16, 40)
# the training steps' widest warps (the wide kernel's forward): AMT S's 44,
# IFRNet S's 54, XVFI's 64
BACKWARD_WIDE_CHANNELS = (44, 54, 64)


def pile_flow(b: int, h: int, w: int, block: int = 16) -> np.ndarray:
    """``[b, h, w, 2]`` flow that sends every pixel of each ``block`` x
    ``block`` block to one point near the block's centre, a quarter pixel
    right and half a pixel down of a pixel: all four taps of weight > 0."""
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    half = block // 2
    flow = np.stack([(gx // block) * block + half + 0.25 - gx, (gy // block) * block + half + 0.5 - gy], -1)
    return np.broadcast_to(flow, (b, h, w, 2)).astype(np.float32)


def backward_cases(seed: int, h: int, w: int) -> List[Dict]:
    """``[{"name", "img" [B,H,W,C] f32, "flow" [B,H,W,2] f32, "modes"}]``
    for the warp's backward kernel at ``h x w``; the ragged cases keep their
    own 68x92 and 137x261 frames. The training steps' widest warps
    (``BACKWARD_WIDE_CHANNELS``) come last, drawn after the others, so that
    those keep their values."""
    rng = np.random.default_rng(seed)

    def img(b, hh, ww, c):
        return rng.random((b, hh, ww, c), dtype=np.float32)

    def smooth(b, hh, ww):
        return smooth_flow(b, hh, ww, 4.0, max(8.0, ww / 6.0)) + (rng.standard_normal((b, hh, ww, 2)) * 0.5).astype(np.float32)

    def const(fx, fy):
        return np.broadcast_to(np.array([fx, fy], np.float32), (1, h, w, 2)).copy()

    disc = np.zeros((1, h, w, 2), np.float32)
    disc[:, :, : w // 2] = [12.5, 3.25]
    disc[:, :, w // 2 :] = [-12.5, -3.25]
    cases = [dict(name=f"bwd_c{c}", img=img(2, h, w, c), flow=smooth(2, h, w), modes=BORDER_ZEROS) for c in BACKWARD_CHANNELS]
    cases += [
        dict(name="bwd_ragged_68x92_c7", img=img(2, 68, 92, 7), flow=smooth(2, 68, 92), modes=BORDER_ZEROS),
        dict(name="bwd_ragged_137x261_c9", img=img(1, 137, 261, 9), flow=smooth(1, 137, 261), modes=BORDER_ZEROS),
        dict(name="bwd_integer_offset_c7", img=img(1, h, w, 7), flow=const(3.0, -2.0), modes=BORDER_ZEROS),
        dict(name="bwd_half_offset_c7", img=img(1, h, w, 7), flow=const(2.5, -1.5), modes=BORDER_ZEROS),
        dict(
            name="bwd_rough_c7",
            img=img(1, h, w, 7),
            flow=(rng.standard_normal((1, h, w, 2)) * 40.0).astype(np.float32),
            modes=BORDER_ZEROS,
        ),
        dict(name="bwd_discontinuity_c3", img=img(1, h, w, 3), flow=disc, modes=BORDER_ZEROS),
        dict(name="bwd_pile_c7", img=img(1, h, w, 7), flow=pile_flow(1, h, w), modes=BORDER_ZEROS),
    ]
    cases += [dict(name=f"bwd_c{c}", img=img(2, h, w, c), flow=smooth(2, h, w), modes=BORDER_ZEROS) for c in BACKWARD_WIDE_CHANNELS]
    return cases


# bf16 vectors: 16 bytes at C = 16, 24, 32, 64, 192, 448, 960; 8 at 20, 36,
# 40, 44; 4 at 18, 54; an element at 21
WIDE_CHANNELS = (16, 18, 20, 21, 24, 32, 36, 40, 44, 54, 64, 192, 448, 960)
M2M_CHANNELS = (32, 48, 96, 192, 384)  # M2M's feature warps (models/m2m.py)


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
    # each 4x4 block of sources lands on its block's centre (+0.5, +0.5): 16
    # sources on each of four targets, a quarter weight each
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    pile = np.stack([(gx // 4) * 4 + 1.5 - gx, (gy // 4) * 4 + 1.5 - gy], -1)[None]
    for c in (1, 4):
        cases.append(dict(name=f"pile_4x4_c{c}", vals=vals(1, h, w, c), flow=pile.astype(np.float32)))
    rough = (rng.standard_normal((1, h, w, 2)) * 40.0).astype(np.float32)
    cases.append(dict(name="rough_x40_c4", vals=vals(1, h, w, 4), flow=rough))
    return cases


def splat_bound_flow(b: int, h: int, w: int) -> np.ndarray:
    """``[b, h, w, 2]`` flow that sends each source exactly onto x = -1, 0,
    w - 1 or w (by bands of rows) and y = -1, 0, h - 1 or h (by bands of
    columns): integer targets on and just off each bound of the frame,
    where a corner of weight 0 is kept or dropped and the flow's gradient
    is one-sided."""
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    tx = np.asarray([-1.0, 0.0, w - 1.0, float(w)], np.float32)[np.minimum(4 * np.arange(h) // h, 3)][:, None]
    ty = np.asarray([-1.0, 0.0, h - 1.0, float(h)], np.float32)[np.minimum(4 * np.arange(w) // w, 3)][None, :]
    flow = np.stack([tx - gx, ty - gy], -1)
    return np.broadcast_to(flow, (b, h, w, 2)).copy()


SPLAT_BACKWARD_CHANNELS = (3, 5, 8, 65)
SPLAT_BACKWARD_WIDE_CHANNELS = (193, 514)  # GMFSS's and EISAI's widest splats
# EISAI's splat widths whose f32 pixels start on 8 bytes but not 16 (the
# backward kernel reads them as 2-channel vectors), and C = 2, one such
# vector a source
SPLAT_BACKWARD_ALIGNED_CHANNELS = (6, 66, 258)


def splat_backward_cases(seed: int, h: int, w: int) -> List[Dict]:
    """``[{"name", "vals" [B,H,W,C] f32, "flow" [B,H,W,2] f32}]``: the cases
    of the splat's backward kernel that :func:`splat_cases` lacks. Widths
    C = 3, 5, 8 and 65 on smooth flow with noise (one lane or a group of
    lanes a source, a tail of 1-3 channels); integer and half-pixel
    constant offsets (every source on a pixel or between two, at C = 4);
    targets exactly on and just off each bound (:func:`splat_bound_flow`);
    then GMFSS's and EISAI's widest, C = 193 and 514, as the first widths;
    then EISAI's 8-byte-aligned f32 widths, C = 6, 66 and 258, and C = 2
    (each drawn after the ones before, so that the earlier cases keep their
    values)."""
    rng = np.random.default_rng(seed)

    def vals(b, c):
        return rng.random((b, h, w, c), dtype=np.float32)

    def noisy(b):
        return smooth_flow(b, h, w, 6.0, scale=max(8.0, w / 6.0)) + rng.standard_normal((b, h, w, 2)).astype(np.float32)

    cases = [dict(name=f"splat_bwd_c{c}", vals=vals(2, c), flow=noisy(2)) for c in SPLAT_BACKWARD_CHANNELS]
    for name, (fx, fy) in (("integer", (3.0, -2.0)), ("half_pixel", (0.5, -1.5))):
        f = np.zeros((1, h, w, 2), np.float32)
        f[..., 0], f[..., 1] = fx, fy
        cases.append(dict(name=f"splat_bwd_{name}_offset_c4", vals=vals(1, 4), flow=f))
    cases.append(dict(name="splat_bwd_exact_bounds_c4", vals=vals(1, 4), flow=splat_bound_flow(1, h, w)))
    cases += [dict(name=f"splat_bwd_c{c}", vals=vals(2, c), flow=noisy(2)) for c in SPLAT_BACKWARD_WIDE_CHANNELS]
    cases += [dict(name=f"splat_bwd_c{c}", vals=vals(2, c), flow=noisy(2)) for c in SPLAT_BACKWARD_ALIGNED_CHANNELS + (2,)]
    return cases
