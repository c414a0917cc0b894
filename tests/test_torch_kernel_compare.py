"""``utils/kernel_compare.py`` binds another checkout's kernel entries by
that checkout's own parameter lists, on the CPU (no library is loaded: a
recording function stands in for each ctypes entry).

* every ``extern "C"`` entry of this tree's ``csrc/warp.cu`` and
  ``csrc/softsplat.cu`` parses, and the ctypes argument types bound for it
  are those of its parameter list, parameter by parameter;
* the same for the five entries as they were before the row band (no
  ``hs``/``ho``/``row0``: 16, 14, 16, 23 and 24 ``int64``), for the splat's
  backward before it took the band (24 ``int64``; this tree's has 26,
  ``ho`` and ``row0`` after ``w`` as K2's) and for the first backward
  design's entry (the image gradient's four strides, no ``cp``), fixtures
  below;
* each ``call_*`` puts every value in the slot its parameter names: the
  strides of each tensor, the shape, ``hs``/``ho`` the whole height and
  ``row0`` 0 where the entry takes them, nothing where it does not.
"""

import ctypes
import os

import pytest
import torch

from comfyui_frame_interpolation_tpu_torch.ops.cuda import build
from comfyui_frame_interpolation_tpu_torch.utils import kernel_compare as kc
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

# the entries as csrc/ declared them before the row band
BEFORE_BAND_WARP = """
extern "C" int cfi_warp_bilinear(
    const void* img, const void* flow, void* out, int img_dtype,
    int flow_dtype, int zeros, int64_t n, int64_t c, int64_t h, int64_t w,
    int64_t si_n, int64_t si_c, int64_t si_h, int64_t si_w, int64_t sf_n,
    int64_t sf_c, int64_t sf_h, int64_t sf_w, int64_t so_n, int64_t so_c,
    int64_t so_h, int64_t so_w, void* stream) {
  return 0;
}
extern "C" int cfi_warp_bilinear_wide(
    const void* img, const void* flow, void* out, int img_dtype,
    int flow_dtype, int zeros, int64_t n, int64_t c, int64_t h, int64_t w,
    int64_t si_n, int64_t si_h, int64_t si_w, int64_t sf_n, int64_t sf_c,
    int64_t sf_h, int64_t sf_w, int64_t so_n, int64_t so_h, int64_t so_w,
    void* stream) {
  return 0;
}
extern "C" int cfi_warp_bilinear_backward(
    const void* img, const void* flow, const void* grad_out, void* grad_img,
    void* grad_flow, int img_dtype, int flow_dtype, int zeros, int64_t n,
    int64_t c, int64_t h, int64_t w, int64_t si_n, int64_t si_c, int64_t si_h,
    int64_t si_w, int64_t sf_n, int64_t sf_c, int64_t sf_h, int64_t sf_w,
    int64_t sg_n, int64_t sg_c, int64_t sg_h, int64_t sg_w, int64_t sgf_n,
    int64_t sgf_c, int64_t sgf_h, int64_t sgf_w, int64_t cp, int64_t vec_img,
    int64_t vec_grad, void* stream) {
  return 0;
}
"""
BEFORE_BAND_SPLAT = """
extern "C" int cfi_softsplat(const void* in, const void* flow, void* out,
                             int in_dtype, int flow_dtype, int64_t n,
                             int64_t c, int64_t h, int64_t w, int64_t si_n,
                             int64_t si_c, int64_t si_h, int64_t si_w,
                             int64_t sf_n, int64_t sf_c, int64_t sf_h,
                             int64_t sf_w, int64_t so_n, int64_t so_c,
                             int64_t so_h, int64_t so_w, void* stream) {
  return 0;
}
extern "C" int cfi_softsplat_backward(
    const void* in, const void* flow, const void* grad_out, void* grad_in,
    void* grad_flow, int in_dtype, int flow_dtype, int64_t n, int64_t c,
    int64_t h, int64_t w, int64_t si_n, int64_t si_c, int64_t si_h,
    int64_t si_w, int64_t sf_n, int64_t sf_c, int64_t sf_h, int64_t sf_w,
    int64_t sg_n, int64_t sg_c, int64_t sg_h, int64_t sg_w, int64_t sgi_n,
    int64_t sgi_c, int64_t sgi_h, int64_t sgi_w, int64_t sgf_n, int64_t sgf_c,
    int64_t sgf_h, int64_t sgf_w, void* stream) {
  return 0;
}
"""
# the splat's entries as csrc/ declared them when K2 took a band and its
# backward did not
BEFORE_BACKWARD_BAND_SPLAT = """
extern "C" int cfi_softsplat(const void* in, const void* flow, void* out,
                             int in_dtype, int flow_dtype, int64_t n,
                             int64_t c, int64_t h, int64_t w, int64_t ho,
                             int64_t row0, int64_t si_n, int64_t si_c,
                             int64_t si_h, int64_t si_w, int64_t sf_n,
                             int64_t sf_c, int64_t sf_h, int64_t sf_w,
                             int64_t so_n, int64_t so_c, int64_t so_h,
                             int64_t so_w, void* stream) {
  return 0;
}
""" + BEFORE_BAND_SPLAT[BEFORE_BAND_SPLAT.index('extern "C" int cfi_softsplat_backward'):]
# the first backward design's entry: a zeroed NCHW f32 buffer with its own strides
NCHW_BUFFER_BACKWARD = """
extern "C" int cfi_warp_bilinear_backward(
    const void* img, const void* flow, const void* grad_out, void* grad_img,
    void* grad_flow, int img_dtype, int flow_dtype, int zeros, int64_t n,
    int64_t c, int64_t h, int64_t w, int64_t si_n, int64_t si_c, int64_t si_h,
    int64_t si_w, int64_t sf_n, int64_t sf_c, int64_t sf_h, int64_t sf_w,
    int64_t sg_n, int64_t sg_c, int64_t sg_h, int64_t sg_w, int64_t sgi_n,
    int64_t sgi_c, int64_t sgi_h, int64_t sgi_w, int64_t sgf_n, int64_t sgf_c,
    int64_t sgf_h, int64_t sgf_w, void* stream) {
  return 0;
}
"""


def _read(name):
    with open(os.path.join(build._CSRC, name)) as f:
        return f.read()


TREES = {
    "this tree": {"warp.cu": _read("warp.cu"), "softsplat.cu": _read("softsplat.cu")},
    "before the row band": {"warp.cu": BEFORE_BAND_WARP, "softsplat.cu": BEFORE_BAND_SPLAT},
    "NCHW-buffer backward": {"warp.cu": NCHW_BUFFER_BACKWARD},
    "before the backward's band": {"softsplat.cu": BEFORE_BACKWARD_BAND_SPLAT},
}
# int64 parameters of each entry: (this tree, before the row band; the
# splat's before its backward's band: this tree's K2 and the backward before)
INT64S = {
    "cfi_warp_bilinear": (18, 16),
    "cfi_warp_bilinear_wide": (16, 14),
    "cfi_warp_bilinear_backward": (25, 23),
    "cfi_softsplat": (18, 16),
    "cfi_softsplat_backward": (26, 24),
}
CASES = [(tree, name) for tree in TREES for name, src in kc.ENTRY_SOURCES.items() if f" {name}(" in TREES[tree].get(src, "")]


class Recorder:
    """Stands in for a ctypes entry: records the positional arguments."""

    def __init__(self):
        self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


def _entry(tree, name):
    return kc.Entry(name, kc.entry_params(TREES[tree][kc.ENTRY_SOURCES[name]], name), Recorder())


@pytest.mark.parametrize("tree, name", CASES)
def test_bound_argument_types_follow_the_parameter_list(tree, name):
    entry = _entry(tree, name)
    ctypes_of = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int, "int64_t": ctypes.c_int64}
    assert entry.argtypes == [ctypes_of[t] for t, _ in entry.params]
    assert entry.params[-1] == ("void*", "stream")
    banded = tree == "this tree" or (tree == "before the backward's band" and name == "cfi_softsplat")
    if tree != "NCHW-buffer backward":
        assert sum(t == "int64_t" for t, _ in entry.params) == INT64S[name][not banded]
    band = ("hs" if name.startswith("cfi_warp") else "ho")
    if banded:
        names = [n for _, n in entry.params]
        assert names[names.index("w") + 1 : names.index("w") + 3] == [band, "row0"]
    else:
        assert not entry.takes("row0")


def _slots(entry):
    return dict(zip((n for _, n in entry.params), entry.fn.args))


@pytest.fixture
def no_stream(monkeypatch):
    monkeypatch.setattr(kc, "_stream", lambda: 0)


def _check_strides(slots, prefix, t, dims="nchw"):
    for d in dims:
        assert slots[f"{prefix}_{d}"] == t.stride("nchw".index(d)), (prefix, d)


def _check_band(slots, entry, h):
    for band in ("hs", "ho"):
        if entry.takes(band):
            assert slots[band] == h
    if entry.takes("row0"):
        assert slots["row0"] == 0


@pytest.mark.parametrize("tree", ["this tree", "before the row band"])
def test_warp_and_splat_values_land_in_their_slots(tree, no_stream):
    img = torch.rand(2, 5, 7, 3)  # NHWC
    flow = torch.rand(2, 5, 7, 2)
    warp = _entry(tree, "cfi_warp_bilinear")
    kc.call_warp(warp, img, flow, zeros=True)
    slots = _slots(warp)
    assert (slots["n"], slots["c"], slots["h"], slots["w"], slots["zeros"]) == (2, 3, 5, 7, 1)
    assert slots["img"] == img.data_ptr() and slots["flow"] == flow.data_ptr() and slots["stream"] == 0
    _check_strides(slots, "si", img.permute(0, 3, 1, 2))
    _check_strides(slots, "sf", flow.permute(0, 3, 1, 2))
    _check_band(slots, warp, 5)

    splat = _entry(tree, "cfi_softsplat")
    kc.call_splat(splat, img, flow)
    slots = _slots(splat)
    assert (slots["n"], slots["c"], slots["h"], slots["w"]) == (2, 3, 5, 7)
    assert slots["in"] == img.data_ptr()
    _check_strides(slots, "si", img.permute(0, 3, 1, 2))
    _check_strides(slots, "sf", flow.permute(0, 3, 1, 2))
    _check_band(slots, splat, 5)

    wide = _entry(tree, "cfi_warp_bilinear_wide")
    planes = torch.rand(2, 40, 5, 7).contiguous(memory_format=torch.channels_last)
    fplanes = flow.permute(0, 3, 1, 2)
    out = kc.call_wide(wide, planes, fplanes, zeros=False)
    slots = _slots(wide)
    assert (slots["c"], slots["h"], slots["zeros"]) == (40, 5, 0) and slots["out"] == out.data_ptr()
    _check_strides(slots, "si", planes, "nhw")
    _check_strides(slots, "so", out, "nhw")
    _check_strides(slots, "sf", fplanes)
    _check_band(slots, wide, 5)


@pytest.mark.parametrize("tree", ["this tree", "before the row band", "NCHW-buffer backward"])
@pytest.mark.parametrize("img_grad", [True, False])
def test_backward_values_land_in_their_slots(tree, img_grad, no_stream):
    planes = torch.rand(2, 7, 5, 6).contiguous(memory_format=torch.channels_last)
    fplanes = torch.rand(2, 2, 5, 6)
    gplanes = torch.rand(2, 7, 5, 6).contiguous(memory_format=torch.channels_last)
    entry = _entry(tree, "cfi_warp_bilinear_backward")
    gi, gf = kc.call_backward_old(entry, planes, fplanes, gplanes, zeros=False, img_grad=img_grad)
    slots = _slots(entry)
    assert (slots["n"], slots["c"], slots["h"], slots["w"]) == (2, 7, 5, 6) and slots["grad_flow"] == gf.data_ptr()
    for prefix, t in (("si", planes), ("sf", fplanes), ("sg", gplanes), ("sgf", gf)):
        _check_strides(slots, prefix, t)
    _check_band(slots, entry, 5)
    assert (gi is not None) == img_grad and (slots["grad_img"] != 0) == img_grad
    if entry.takes("cp"):  # the f32 buffer [N, H, W, Cp] and the vector widths
        assert slots["cp"] == 8 and slots["vec_img"] in (4, 8, 16) and slots["vec_grad"] in (4, 8, 16)
    elif img_grad:  # the NCHW buffer's strides
        assert (slots["sgi_n"], slots["sgi_c"], slots["sgi_h"], slots["sgi_w"]) == (7 * 5 * 6, 5 * 6, 6, 1)


@pytest.mark.parametrize("tree", ["this tree", "before the row band", "before the backward's band"])
def test_splat_backward_values_land_in_their_slots(tree, no_stream):
    planes = torch.rand(2, 6, 5, 4)
    fplanes = torch.rand(2, 2, 5, 4)
    gplanes = torch.rand(2, 6, 5, 4)
    entry = _entry(tree, "cfi_softsplat_backward")
    gi, gf = kc.call_splat_backward(entry, planes, fplanes, gplanes)
    slots = _slots(entry)
    assert slots["in"] == planes.data_ptr() and slots["grad_in"] == gi.data_ptr() and slots["grad_flow"] == gf.data_ptr()
    for prefix, t in (("si", planes), ("sf", fplanes), ("sg", gplanes), ("sgi", gi), ("sgf", gf)):
        _check_strides(slots, prefix, t)
    assert entry.takes("row0") == (tree == "this tree")
    _check_band(slots, entry, 5)


def test_an_entry_that_is_missing_or_takes_an_unknown_value_raises():
    with pytest.raises(ValueError, match="no extern"):
        kc.entry_params(BEFORE_BAND_SPLAT, "cfi_warp_bilinear")
    entry = kc.Entry("cfi_x", kc.entry_params('extern "C" int cfi_x(const void* a, int64_t k, void* stream) {', "cfi_x"), Recorder())
    with pytest.raises(TypeError, match="no value for its parameter k"):
        entry(a=0, stream=0)
