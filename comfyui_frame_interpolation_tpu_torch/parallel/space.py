"""Rows split over devices: the ``space`` axis of the ``(data, space)`` mesh,
the port's stand-in for the JAX package's GSPMD row split.

JAX shards a frame batch's rows over ``space`` and lets XLA insert each
convolution's halo exchange. Torch has no such pass, so here a frame is a
:class:`RowBands` value: one logical tensor held as row bands, band ``j`` on
the ``j``-th device of one data shard's row of the mesh
(``mesh.devices[i]``), each band knowing its global first row and the value
knowing the global height. The bands split at multiples of
:data:`~.mesh.MIN_ROWS_PER_SHARD` rows, as evenly as possible, earlier bands
taking the extra unit (:func:`band_rows`: 1080 rows become 576 + 504, and
RIFE's pad to a multiple of 64 lands in the last band).

The model runs unchanged on such values: :class:`RowBands` defines
``__torch_function__`` (torch calls it for every torch function, ``nn``
module and tensor method that meets one) and ``ops.warp.warp`` hands it over
the same way. Each call goes to the rule of an allow-list; a function
without one raises ``NotImplementedError`` naming itself and the
``ROADMAP.md`` item that would port it. Nothing is gathered or run band by
band unless a rule says so. The rules are those that every family's
inference needs: RIFE (every arch, with and without fast mode), the pair
functions of M2M, XVFI (Vimeo and X4K), GMFSS Fortuna (base and union) and
EISAI, FILM, IFRNet (S and L), AMT (S, L and G), IFUnet (with and without
the ensemble), CAIN, Sepconv, ATM (base and lite; global motion off, on and
with the ensemble), MoMo (base and lite) and the window-4 models, FLAVR
and STMFNet; and, with a gradient, the training step of every family that
``parallel.make_train_step`` carries (each rule's ops are differentiable:
``cat``, ``narrow`` and ``to`` carry the halos' and gathers' gradients back
into the bands that hold their rows):

* the re-banding rule (:meth:`RowBands.reband`): a value's band edges move
  to new starts, each band taking only the rows between its old edge and
  its new one from the neighbours that hold them (a differentiable ``cat``
  on its own device), bit for bit the same value; never a gather. Two
  values of one height and row dimension in other bands (X4K's strided
  pyramid against the flows upsampled from coarser levels, Sepconv's odd
  levels' crops on other edges) meet in an op: the second is re-banded
  onto the first's edges (:func:`_onto`). An op that needs every band to
  start on a multiple of ``s`` (``pixel_unshuffle(s)``, ``avg_pool2d(s)``,
  nearest and bilinear downscales by ``s``, FILM's 2x2 pooling pyramid)
  re-bands its input to the nearest such edges that leave every band an
  output row (:meth:`RowBands.on_multiples`); where none do, it raises.
  :data:`rebands` and :data:`rows_moved` count them. A strided convolution
  whose output has fewer rows than there are bands (X4K's coarsest flow net
  at 1/256 of a 512-row frame: one row) leaves a band without rows; the
  rules that meet one (elementwise ops, the convolutions, nearest
  resizes) pass it on, and a result with rows enough for every band is
  re-banded at once;

* row-local ops, band by band: elementwise arithmetic, ``clamp`` (``min=``
  too), ``sigmoid``, ``tanh``, ``relu`` (``nn.ReLU``), ``gelu``, ``silu``,
  ``leaky_relu``, ``prelu`` (``nn.PReLU``), ``exp``, ``log``, ``pow``,
  ``abs``, ``square``, ``sqrt``, ``floor``, comparisons (``==`` too: the
  splat's zeroeps test), casts, ``flip`` and ``torch.linalg.vector_norm``
  of other dimensions than the rows (EISAI's flows and Lab metric),
  channel and batch ``cat``, ``stack``
  along a new dimension, slices of the channel and batch dimensions (an
  ``...`` and ``None`` too) and writes into them (``__setitem__``, IFRNet's
  ``ResBlock``: a value in the same bands or a plain tensor without rows;
  an index that cuts the rows raises), ``permute``, the ``expand_as`` of a
  tensor without rows (the timestep map), ``repeat``, ``reshape``,
  ``view``, ``expand`` and ``unflatten`` of the dimensions before the rows,
  ``reshape`` and ``view`` of the dimensions after them (FLAVR's and
  STMFNet's merge of time and channels; each refuses a shape that moves or
  merges the rows), M2M's
  ``_repeat_branches``, ``index_select`` of another dimension,
  ``batch_norm`` on stored statistics (``training=True`` raises),
  ``layer_norm`` over trailing dimensions after the rows and ``linear``
  over the last (ATM's tokens),
  ``softmax`` over a dimension other than the rows, and ``pixel_shuffle``
  and nearest ``interpolate`` by an integer factor, which multiply each
  band's rows and first row (a nearest downscale by ``s`` divides them, on
  bands that start on a multiple of ``s``);
* a plain tensor whose rows are the value's height, in ``cat`` and the
  elementwise ops: a constant map built whole from a value's shape
  (IFRNet's and AMT's timestep map, AMT's coordinate grid, IFUnet's
  ``tmap``), narrowed to each band's rows on its device; any other plain
  tensor with rows raises;
* ``torch.cat`` along the rows (IFRNet's joint mean of both frames): the
  operands' bands in order, each on its own device;
* reductions (``sum``, ``mean``, ``var``, ``var_mean``, ``std_mean``): over other
  dimensions band by band; over the rows from each band's partial sum
  (in f32 for half-precision bands, rounded once, as torch sums them),
  added in band order on the value's device into a plain tensor (``var``
  from that mean first: AMT's ``common.instance_norm``); ``amax`` and
  ``amin`` the same way, exact (RIFE 4.0's restart flag);
* ``torch.einsum`` with one banded operand whose row subscript no other
  operand has and the result keeps (M2M's attention cube);
* ``conv2d``, and ``conv3d`` on NCDHW clips whose rows are dimension 3
  (FLAVR's and STMFNet's stacks of frames; the time and column dimensions
  keep their own padding): each band takes the ``dilation * (k - 1)`` rows around it
  that its outputs read (the halo) from its neighbours, zeros beyond the
  global top and bottom only, and owns the outputs whose middle input row
  is its own (so a VALID convolution after ``F.pad`` lines up as one that
  pads itself); ``padding="same"`` as the explicit pad torch applies
  (``floor`` of half the reach above, the rest below: an even kernel
  reads one row below and none above); FILM's ``common.conv2x2_up2x``
  (which hands a band over) with the one row below that its 2x2 taps
  read, interleaved into a band of twice the rows;
* ``avg_pool2d`` with windows of their own rows (kernel = stride, every
  band starting on a multiple of it); ``max_pool2d`` (EISAI's opening and
  its ResNet's 3x3 stride-2 pool) as the convolutions: the rows its
  windows read, -inf beyond the global top and bottom only (the pool's
  padding), the outputs owned by their middle input row;
* ``ops.costvol.costvol_func``: each band compares against the ``+-4``
  rows around it of the second tensor, zeros beyond the frame's edges;
* ``conv_transpose2d`` (grouped too), and ``conv_transpose3d`` on NCDHW
  clips: the input rows its outputs read (one from each neighbour for
  ``(4, 2, 1)``), the result cropped to its own rows;
* bilinear ``interpolate`` (``align_corners=False``, ``size=``) by an
  integer factor: the global ratio, not the band's; a downscale by ``s``
  is band-local when every band starts on a multiple of ``s``; an upscale
  reads one coarse row from each neighbour and is cropped, so the edge
  clamp applies at the global edges only; by a ratio that is not an
  integer (FILM's pyramid at 1080 rows: 67 -> 135), the rows' two taps as
  torch maps them on the rows each band's outputs read, then the columns;
  each band's outputs start at ``floor(start * out / in)``, where a
  pyramid of 2x2 poolings starts the next level's band; ``index_select``
  of the rows (FILM's nearest resize) takes the same outputs and gathers
  the rows they name; with ``align_corners=True`` (STMFNet's kernel maps,
  upscaled by 2 and 4), by any ratio, the rows' two taps at ``dst * (height
  - 1) / (out - 1)``, the global ratio, then the columns;
* ``F.pad`` (constant, replicate and reflect): the top pad goes to the
  first band, the bottom pad to the last (whose last row is the frame's); a
  reflect pad's rows come from whichever bands hold them, so a pad longer
  than the band that takes it reads its neighbours (CAIN's centred pad,
  numpy's periodic reflection through ``common.reflect_pad``); a slice of
  the rows crops each band;
* CAIN's ``_reflect_pad1`` and MoMo's ``_replicate_pad1`` (which hand a
  band over): each band with one halo row from each neighbour, a padded
  row only at the global top and bottom; ``pixel_unshuffle(r)`` divides the
  rows and first row;
* Sepconv's ``ops.sepconv.sepconv_func`` (which hands bands over): each
  band's output rows read the ``K - 1 = 50`` input rows below them in the
  padded input (25 above and 25 below in the frame), the replicate pad of
  25 in the first and last bands only; ``ones_like`` and ``where`` band by
  band; ``std_mean`` of the stacked frames over the rows from partial
  sums;
* the warp: the source is gathered whole onto each band's device (a
  differentiable ``cat``, so autograd adds each band's image gradient back
  into the producing bands; a plain source, XVFI's f32 ones plane, only
  moves there), the flow stays local and the kernel (K1 or the wide
  kernel) warps the band from its first row (``row0``);
* the splat (``ops.softsplat.softsplat_func``): band ``j``'s sources splat
  from their first row into a whole-frame f32 partial on band ``j``'s
  device (K2 with a band, ``softsplat_partial``); band ``k`` of the result
  is the sum of every partial's rows of band ``k``, moved to band ``k``'s
  device and added in band order, cast once. It is the forward
  counterpart of the warp's gathered source, whose image gradient autograd
  adds back into bands. With a gradient, each partial's gradient is the
  result's bands joined whole on its band's device, and the splat's
  backward kernel reads it on the band (the training steps of M2M, XVFI,
  GMFSS and EISAI);
* IFUnet's ``convex_upsample`` (which hands a band over): each band's flow
  with a row from each neighbour for the 3x3 taps, its own mask, its result
  ``level`` times its rows from ``level`` times its first row;
* AMT's correlation (``ops.bidir_corr.BidirCorr``, which hands bands
  over): each target's pyramid built on each band's device from the
  target gathered whole (the warp's source rule), each band's queries
  looked up at its own rows of the coordinates; with a gradient the
  target's gathered ``cat`` carries each pyramid's gradient back into the
  producing bands, and each band's lookup takes ``BidirCorr.windowed``'s
  out-of-place form;
* STMFNet's hand-overs: ``models.stmfnet._upsampler_8tap`` (each band's
  column pass with the 3 rows above and 4 below it, reflected only at the
  global top and bottom; twice its rows out from twice its first row),
  ``ops.adacof.adacof_func`` (the replicate-padded input gathered whole
  onto each band's device, as the warp's source: the offsets are learned
  and unbounded; each band's output rows from its ``row0``) and
  ``ops.correlation.correlation_func`` (each band against the ``+-4`` rows
  around it of the second tensor, zeros beyond the frame's edges: the
  cost volume's rule for the PWC decoders);
* GMFSS's GMFlow, whose global ops hand their bands over: the transformer
  (``models.gmfss._transformer``; each layer's linear maps, norms and MLP
  band by band, its window attention taking each band's queries against
  every band's keys and values gathered whole onto its device, in the
  windows of the global rows, so a shifted layer's roll wraps the frame's
  last rows onto its first whatever the bands), the global correlation
  softmax and the global flow attention (each band's queries against the
  keys gathered whole; the softmax over the keys, which are whole), the
  local correlation (``r`` halo rows of the second frame) and the local
  flow attention and convex upsampling (a halo row for the 3x3
  neighbourhoods, zeros beyond the frame's edges only);
* EISAI's: RAFT's all-pairs correlation (``models.eisai._corr_pyramid``
  returns a :class:`_BandPyramid`, each band's query rows against the
  target gathered whole, which ``_corr_lookup`` reads at each band's own
  rows of the coordinates), its convex upsampling (a halo row, 8 times
  the rows) and ``ops.edt.batch_edt`` (the x pass band by band, the y
  pass of each band's rows on the x pass gathered whole, bit for bit);
* ATM's Swin blocks (``models.atm._windowed``, which hands a band over):
  each band computes the windows of the padded, rolled map that hold its
  own rows, their rows read from its neighbours and, under the half-window
  shift, from the frame's other end (the roll's wrap), with those windows'
  masks, and keeps its own rows; a window across a band edge is computed by
  both bands. The ensemble's pick of a scale per sample is a ``where``;
* MoMo's: the GroupNorm (``_group_norm_silu``: each group's mean, then its
  variance about it, in f32 from the bands' partial sums in band order,
  then the affine and SiLU band by band), the x8 convex upsampling (a halo
  row, 8 times the rows), the frames' mean and std (``std_mean`` from
  partial sums), the bicubic backwarp (the source gathered whole, each
  band's grid of its global rows: bit for bit), the noise (drawn whole on
  the first band's device, cut into the frame's bands: ``_as_frame``), and
  ``common.resize_bicubic`` to any size, antialiased or plain: each band's
  outputs from ``floor(start * out / in)``, their rows as the taps of the
  global ratio weighted as torch's own kernel weighs them (read off its
  ``F.interpolate`` of one-hot rows, once per resize), then the columns.

Every rule computes what the op computes on the whole tensor: the
convolutions and resizes the same sums, possibly by other algorithms
(cuDNN picks one per shape), the reductions, the splat and the
correlation's dots (AMT's and the PWC's) and AdaCoF's taps in another
order, the warp, the distance transform, MoMo's backwarp and pads and
ATM's windows bit for bit (on the same values), the attention's
and correlations' dots over each band's queries in f32 (or the model's
dtype) apart from one device's by rounding. Bands on logical replicas of
one device split the work as separate devices would.
"""

from __future__ import annotations

import inspect
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models import atm, cain, common, eisai, gmfss, ifunet, m2m, momo, stmfnet
from ..ops import correlation, costvol, edt
from ..ops.adacof import adacof_func
from ..ops.bidir_corr import BidirCorr, _Pyramid
from ..ops.sepconv import sepconv_func
from ..ops.softsplat import softsplat_func, softsplat_partial
from ..ops.warp import warp
from .mesh import MIN_ROWS_PER_SHARD, SPACE_TODO

__all__ = ["RowBands", "band_rows", "split_rows"]

# re-bands made (RowBands.reband) and the rows they moved between bands,
# since the caller last set them to 0
rebands = 0
rows_moved = 0


def band_rows(height: int, n: int, unit: int = MIN_ROWS_PER_SHARD) -> List[Tuple[int, int]]:
    """``(first row, rows)`` of each of ``n`` bands of ``height`` rows:
    split at multiples of ``unit`` rows, as evenly as possible, the earlier
    bands taking the extra unit; the last band ends at ``height``."""
    units = -(-height // unit)
    if units < n:
        raise ValueError(f"{height} rows make {units} units of {unit}: too few for {n} bands")
    per, extra = divmod(units, n)
    starts, row = [], 0
    for j in range(n):
        starts.append(row)
        row += (per + (j < extra)) * unit
    stops = starts[1:] + [height]
    return [(a, b - a) for a, b in zip(starts, stops)]


def split_rows(x: torch.Tensor, devices: Sequence[torch.device], dim: int = 1) -> "RowBands":
    """``x`` as row bands along ``dim`` (1 for NHWC frames), band ``j`` on
    ``devices[j]``, split by :func:`band_rows`."""
    spans = band_rows(x.shape[dim], len(devices))
    bands = [x.narrow(dim, a, n).to(d) for (a, n), d in zip(spans, devices)]
    return RowBands(bands, [a for a, _ in spans], x.shape[dim], dim)


def _no_rule(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} has no row-band rule: {SPACE_TODO}")


def _name(func: Callable) -> str:
    return getattr(func, "__qualname__", None) or getattr(func, "__name__", None) or repr(func)


def _same_device(a, b: torch.device) -> bool:
    a = torch.device(a)
    if a.type == "cuda" and a.index is None:
        a = torch.device("cuda", torch.cuda.current_device())
    return a == b


def _memory_format(t: torch.Tensor) -> torch.memory_format:
    return torch.channels_last if t.dim() == 4 and t.shape[1] > 1 and t.stride(1) == 1 else torch.contiguous_format


class RowBands:
    """One logical tensor held as row bands along dimension ``axis``:
    ``bands[j]`` holds global rows ``starts[j]`` to ``starts[j] +
    bands[j].shape[axis]`` of ``height``, on its own device; every other
    dimension is whole in each band. The value's device is band 0's (the
    first device of the mesh's row)."""

    def __init__(self, bands: Sequence[torch.Tensor], starts: Sequence[int], height: int, axis: int):
        self.bands = tuple(bands)
        self.starts = tuple(int(s) for s in starts)
        self.height = int(height)
        self.axis = axis

    def like(self, bands: Sequence[torch.Tensor], axis: Optional[int] = None) -> "RowBands":
        """New bands on this value's rows (along ``axis``, this value's by
        default)."""
        return RowBands(bands, self.starts, self.height, self.axis if axis is None else axis)

    # ---- the tensor attributes the models read ------------------------------
    @property
    def shape(self) -> torch.Size:
        s = list(self.bands[0].shape)
        s[self.axis] = self.height
        return torch.Size(s)

    def size(self, d: Optional[int] = None):
        return self.shape if d is None else self.shape[d]

    @property
    def ndim(self) -> int:
        return self.bands[0].dim()

    def dim(self) -> int:
        return self.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.bands[0].dtype

    @property
    def device(self) -> torch.device:
        return self.bands[0].device

    @property
    def requires_grad(self) -> bool:
        return any(b.requires_grad for b in self.bands)

    def __repr__(self) -> str:
        return (f"RowBands(shape={tuple(self.shape)}, dtype={self.dtype}, rows along {self.axis}, "
                f"bands {[(s, b.shape[self.axis], str(b.device)) for s, b in zip(self.starts, self.bands)]})")

    # ---- moving rows ----------------------------------------------------------
    def rows(self, lo: int, hi: int, j: int, fill: float = 0.0) -> torch.Tensor:
        """Global rows ``lo`` to ``hi`` on band ``j``'s device, taken from
        every band they lie in, ``fill`` outside ``[0, height)`` (zeros; a
        max pool's padding: -inf): band ``j`` itself (no copy) when they are
        exactly its rows."""
        d, dev = self.axis, self.bands[j].device
        ref = self.bands[j]
        pieces = []

        def zeros(k):
            shape = list(ref.shape)
            shape[d] = k
            return torch.empty(shape, dtype=ref.dtype, device=dev, memory_format=_memory_format(ref)).fill_(fill)

        if lo < 0:
            pieces.append(zeros(min(hi, 0) - lo))
        for b, s in zip(self.bands, self.starts):
            a, e = max(lo, s), min(hi, s + b.shape[d])
            if a < e:
                pieces.append(b.narrow(d, a - s, e - a).to(dev))
        if hi > self.height:
            pieces.append(zeros(hi - max(lo, self.height)))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, d)

    def gather(self, device: torch.device) -> torch.Tensor:
        """The whole value on ``device`` (a differentiable ``cat``)."""
        return torch.cat([b.to(device) for b in self.bands], self.axis)

    def reband(self, starts: Sequence[int], what: str = "a re-band") -> "RowBands":
        """This value with its band edges moved to ``starts`` (0 first, each
        band keeping at least one row): band ``j`` keeps its own rows that
        lie in its new span and takes the rows between its old edge and its
        new one from the bands that hold them (:meth:`rows`: a
        differentiable ``cat`` on its own device), so only those rows move
        and the value is bit for bit the same. ``what`` names the op that
        needs it in the refusal of edges that would empty a band.
        Counted in :data:`rebands` and :data:`rows_moved`."""
        global rebands, rows_moved
        starts = tuple(int(s) for s in starts)
        if starts == self.starts:
            return self
        stops = starts[1:] + (self.height,)
        if len(starts) != len(self.bands) or starts[0] != 0 or any(e <= a for a, e in zip(starts, stops)):
            raise _no_rule(f"{what}: band edges {list(self.starts)} -> {list(starts)} of {self.height} rows (a band would empty)")
        old = list(zip(self.starts, self.starts[1:] + (self.height,)))
        bands = [self.rows(a, e, j) for j, (a, e) in enumerate(zip(starts, stops))]
        rebands += 1
        rows_moved += sum((e - a) - max(0, min(e, oe) - max(a, oa)) for (a, e), (oa, oe) in zip(zip(starts, stops), old))
        return RowBands(bands, starts, self.height, self.axis)

    def on_multiples(self, s: int, out_rows: int, what: str) -> "RowBands":
        """This value re-banded (:meth:`reband`) so that every band starts on
        a multiple of ``s`` rows and makes at least one of the ``out_rows``
        output rows of an op that makes one of each ``s`` input rows
        (``what``): each edge moves to the nearest multiple (the lower one
        at a tie), or as little further as leaves every band an output row;
        where no edge does, the op raises. ``s = 1`` only fills bands left
        without rows."""
        n = len(self.bands)
        if all(a % s == 0 for a in self.starts) and all(
            e // s > a // s for a, e in zip(self.starts, self.starts[1:] + (out_rows * s,))
        ):
            return self
        starts = [0]
        for j, a in enumerate(self.starts[1:], 1):
            # an output row for the band before, and one for this band and each after it
            lo, hi = starts[-1] // s + 1, out_rows - (n - j)
            if lo > hi:
                raise _no_rule(f"{what} on bands from rows {list(self.starts)} of {self.height}: no edge on a multiple of "
                               f"{s} leaves each of {n} bands one of {out_rows} output rows")
            starts.append(min(max(a // s + (2 * (a % s) > s), lo), hi) * s)
        return self.reband(starts, what)

    # ---- dispatch ---------------------------------------------------------------
    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        rule = _RULES.get(func)
        if rule is None:
            raise _no_rule(_name(func))
        out = rule(func, args, kwargs or {})
        if isinstance(out, RowBands) and out.height >= len(out.bands) and any(b.shape[out.axis] == 0 for b in out.bands):
            # a band left without rows by a value of fewer rows than bands (a
            # strided convolution's): given rows again as soon as there are enough
            out = out.on_multiples(1, out.height, _name(func))
        return out

    def _call(self, func, *args, **kwargs):
        return RowBands.__torch_function__(func, (RowBands,), (self, *args), kwargs)

    def __getattr__(self, name: str):
        # a tensor attribute or method that the rules do not name
        if name.startswith("_"):
            raise AttributeError(name)
        raise _no_rule(f"Tensor.{name}")

    def permute(self, *dims):
        return self._call(torch.Tensor.permute, *dims)

    def clamp(self, *args, **kwargs):
        return self._call(torch.Tensor.clamp, *args, **kwargs)

    def float(self):
        return self._call(torch.Tensor.float)

    def to(self, *args, **kwargs):
        return self._call(torch.Tensor.to, *args, **kwargs)

    def contiguous(self, *args, **kwargs):
        return self._call(torch.Tensor.contiguous, *args, **kwargs)

    def __getitem__(self, index):
        return self._call(torch.Tensor.__getitem__, index)

    def __setitem__(self, index, value):
        self._call(torch.Tensor.__setitem__, index, value)

    def __add__(self, other):
        return self._call(torch.Tensor.add, other)

    def __radd__(self, other):
        return self._call(torch.Tensor.__radd__, other)

    def __sub__(self, other):
        return self._call(torch.Tensor.sub, other)

    def __rsub__(self, other):
        return self._call(torch.Tensor.__rsub__, other)

    def __mul__(self, other):
        return self._call(torch.Tensor.mul, other)

    def __rmul__(self, other):
        return self._call(torch.Tensor.__rmul__, other)

    def __truediv__(self, other):
        return self._call(torch.Tensor.div, other)

    def __rtruediv__(self, other):
        return self._call(torch.Tensor.__rtruediv__, other)

    def __neg__(self):
        return self._call(torch.Tensor.neg)

    def __eq__(self, other):  # softsplat's zeroeps test of the splatted weights
        return self._call(torch.Tensor.eq, other)

    __hash__ = object.__hash__

    def __lt__(self, other):
        return self._call(torch.Tensor.lt, other)

    def __le__(self, other):
        return self._call(torch.Tensor.le, other)

    def __gt__(self, other):
        return self._call(torch.Tensor.gt, other)

    def __ge__(self, other):
        return self._call(torch.Tensor.ge, other)

    def abs(self):
        return self._call(torch.Tensor.abs)

    def square(self):
        return self._call(torch.Tensor.square)

    def exp(self):
        return self._call(torch.Tensor.exp)

    def sqrt(self):
        return self._call(torch.Tensor.sqrt)

    def floor(self):
        return self._call(torch.Tensor.floor)

    def relu(self):
        return self._call(torch.Tensor.relu)

    def flip(self, *dims):
        return self._call(torch.Tensor.flip, *dims)

    def tanh(self):
        return self._call(torch.Tensor.tanh)

    def softmax(self, *args, **kwargs):
        return self._call(torch.Tensor.softmax, *args, **kwargs)

    def amax(self, *args, **kwargs):
        return self._call(torch.Tensor.amax, *args, **kwargs)

    def amin(self, *args, **kwargs):
        return self._call(torch.Tensor.amin, *args, **kwargs)

    def index_select(self, dim, index):
        return self._call(torch.Tensor.index_select, dim, index)

    def mean(self, *args, **kwargs):
        return self._call(torch.Tensor.mean, *args, **kwargs)

    def sum(self, *args, **kwargs):
        return self._call(torch.Tensor.sum, *args, **kwargs)

    def var(self, *args, **kwargs):
        return self._call(torch.Tensor.var, *args, **kwargs)

    def repeat(self, *sizes):
        return self._call(torch.Tensor.repeat, *sizes)

    def reshape(self, *shape):
        return self._call(torch.Tensor.reshape, *shape)

    def view(self, *shape):
        return self._call(torch.Tensor.view, *shape)

    def expand(self, *sizes):
        return self._call(torch.Tensor.expand, *sizes)

    def unflatten(self, dim, sizes):
        return self._call(torch.Tensor.unflatten, dim, sizes)


# ---- the rules -----------------------------------------------------------------


def _bind(func: Callable, names: Sequence[str], defaults: Sequence[Any], args, kwargs) -> List[Any]:
    """``args`` and ``kwargs`` of a call of ``func`` as the values of
    ``names`` (a prefix of its parameters), filled from ``defaults``."""
    if len(args) > len(names):
        raise TypeError(f"{_name(func)}: {len(args)} positional arguments, the row-band rule knows {len(names)}")
    values = dict(zip(names, defaults))
    values.update(zip(names, args))
    for k, v in kwargs.items():
        if k not in values:
            raise _no_rule(f"{_name(func)} with {k}=")
        values[k] = v
    return [values[n] for n in names]


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _first_bands(values) -> RowBands:
    for v in values:
        if isinstance(v, RowBands):
            return v
        if isinstance(v, (list, tuple)):
            for u in v:
                if isinstance(u, RowBands):
                    return u
    raise TypeError("no row-band value among the arguments")


def _alike(ref: RowBands, other: RowBands) -> bool:
    return (other.starts, other.height, other.axis) == (ref.starts, ref.height, ref.axis) and [
        b.shape[ref.axis] for b in other.bands
    ] == [b.shape[ref.axis] for b in ref.bands]


def _check_alike(func, ref: RowBands, other: RowBands) -> None:
    if not _alike(ref, other):
        raise _no_rule(f"{_name(func)} of two values split into other row bands ({other!r} and {ref!r})")


def _onto(func, ref: RowBands, other):
    """``other`` on ``ref``'s band edges: itself where they match, re-banded
    (:meth:`RowBands.reband`) where only the edges differ; a value of
    another height or row dimension raises. Anything but a row-band value
    passes as it is."""
    if not isinstance(other, RowBands) or _alike(ref, other):
        return other
    if (other.height, other.axis, len(other.bands)) != (ref.height, ref.axis, len(ref.bands)):
        raise _no_rule(f"{_name(func)} of two values split into other row bands ({other!r} and {ref!r})")
    return other.reband(ref.starts, _name(func))


def _local(func, v, j: int, ref: RowBands):
    """Argument ``v`` as band ``j`` of ``ref`` sees it: its own band, a plain
    tensor without rows on the band's device, a plain tensor whose rows (as
    it broadcasts against ``ref``) are ``ref``'s height narrowed to the
    band's rows there (a constant map built whole from a value's shape:
    IFRNet's and AMT's ``embt_map``, AMT's ``coord``, IFUnet's ``tmap``), or
    ``v`` as it is."""
    if isinstance(v, RowBands):
        _check_alike(func, ref, v)
        return v.bands[j]
    if isinstance(v, torch.Tensor):
        k = ref.axis - (ref.ndim - v.dim())
        dev = ref.bands[j].device
        if k >= 0 and v.shape[k] == ref.height:
            return v.narrow(k, ref.starts[j], ref.bands[j].shape[ref.axis]).to(dev)
        if k >= 0 and v.shape[k] != 1:
            raise _no_rule(f"{_name(func)} of a plain tensor {tuple(v.shape)} that spans the rows of {ref!r}")
        return v.to(dev)
    return v


def _elementwise(func, args, kwargs):
    ref = _first_bands(list(args) + list(kwargs.values()))
    args = [_onto(func, ref, v) for v in args]
    kwargs = {k: _onto(func, ref, v) for k, v in kwargs.items()}
    out = []
    for j in range(len(ref.bands)):
        a = [_local(func, v, j, ref) for v in args]
        kw = {k: _local(func, v, j, ref) for k, v in kwargs.items()}
        out.append(func(*a, **kw))
    return ref.like(out)


def _to(func, args, kwargs):
    x, rest = args[0], list(args[1:])
    kwargs = dict(kwargs)
    device = kwargs.pop("device", None)
    kept = []
    for a in rest:
        if isinstance(a, (torch.device, str)):
            device = a
        elif isinstance(a, torch.Tensor):
            raise _no_rule("Tensor.to(other)")
        else:
            kept.append(a)
    if device is not None and not _same_device(device, x.device):
        raise _no_rule(f"Tensor.to({device}) of a value on {x.device} (a gather)")
    return x.like([b.to(*kept, **kwargs) for b in x.bands])


def _alike_bands(func, tensors, what: str) -> List[RowBands]:
    """``tensors``, which must all be row-band values of one height, on the
    first one's band edges (:func:`_onto`)."""
    ref = _first_bands([tensors])
    for t in tensors:
        if not isinstance(t, RowBands):
            raise _no_rule(f"{what} of a plain tensor {tuple(t.shape)} with row bands")
    return [_onto(func, ref, t) for t in tensors]


def _cat(func, args, kwargs):
    """``torch.cat`` along another dimension: band by band, a plain operand
    taken as :func:`_local` takes it (one that spans the rows, narrowed);
    along the rows: :func:`_cat_rows`."""
    tensors, dim = _bind(func, ("tensors", "dim"), (None, 0), args, kwargs)
    ref = _first_bands([tensors])
    d = dim % ref.ndim
    if d == ref.axis:
        return _cat_rows(tensors, d)
    tensors = [_onto(func, ref, t) for t in tensors]
    return ref.like([torch.cat([_local(func, t, j, ref) for t in tensors], d) for j in range(len(ref.bands))])


def _cat_rows(tensors, d: int) -> RowBands:
    """``torch.cat`` of row-band values along their rows (IFRNet's joint
    mean of both frames): the operands' bands in order, each on its own
    device, each starting after the rows of the operands before it; exact,
    and a reduction of the result takes its partial sums in band order."""
    ref = _first_bands([tensors])
    other = [n for i, n in enumerate(ref.shape) if i != d]
    bands, starts, rows = [], [], 0
    for t in tensors:
        if not isinstance(t, RowBands) or t.axis != d or [n for i, n in enumerate(t.shape) if i != d] != other:
            raise _no_rule(f"torch.cat along the rows of {t!r} and {ref!r} (row-band values alike but for their rows)")
        bands += t.bands
        starts += [rows + s for s in t.starts]
        rows += t.height
    return RowBands(bands, starts, rows, d)


def _stack(func, args, kwargs):
    """``torch.stack`` of values in the same row bands along a new
    dimension: band by band, the rows one dimension later when the new one
    lands before them."""
    tensors, dim = _bind(func, ("tensors", "dim"), (None, 0), args, kwargs)
    tensors = _alike_bands(func, tensors, "torch.stack")
    ref = tensors[0]
    d = dim % (ref.ndim + 1)
    axis = ref.axis + (d <= ref.axis)
    return ref.like([torch.stack([t.bands[j] for t in tensors], d) for j in range(len(ref.bands))], axis)


def _index(x: RowBands, index, what: str) -> Tuple[tuple, int]:
    """``index`` with its ``...`` spelt out and a slice for every dimension
    it leaves out, and the position of the rows' entry in it."""
    index = index if isinstance(index, tuple) else (index,)
    used = sum(i is not None and i is not Ellipsis for i in index)  # the entries that take a dimension
    if index.count(Ellipsis) == 1:
        k = index.index(Ellipsis)
        index = index[:k] + (slice(None),) * (x.ndim - used) + index[k + 1 :]
        used = x.ndim
    if used > x.ndim or not all(i is None or isinstance(i, (int, slice)) for i in index):
        raise _no_rule(f"{what} with {index!r} (slices, integers, None and one Ellipsis only)")
    index = index + (slice(None),) * (x.ndim - used)
    # the entry of the rows: the axis-th that takes a dimension
    return index, [j for j, i in enumerate(index) if i is not None][x.axis]


def _getitem(func, args, kwargs):
    x, index = args
    index, k = _index(x, index, "Tensor.__getitem__")
    if isinstance(index[k], int):
        raise _no_rule("Tensor.__getitem__ of one row")
    start, stop, step = index[k].indices(x.height)
    if step != 1:
        raise _no_rule("Tensor.__getitem__ of rows with a step")
    stop = max(stop, start)
    bands, starts = [], []
    for b, s in zip(x.bands, x.starts):
        n = b.shape[x.axis]
        a, e = min(max(start - s, 0), n), min(max(stop - s, 0), n)
        local = list(index)
        local[k] = slice(a, max(a, e))
        bands.append(b[tuple(local)])
        starts.append(max(s + a - start, 0))
    # integers before the rows take their dimensions away, and None adds one
    return RowBands(bands, starts, stop - start, sum(not isinstance(i, int) for i in index[:k]))


def _setitem(func, args, kwargs):
    """``x[index] = value`` for an ``index`` that leaves the rows whole
    (IFRNet's ``ResBlock`` writing its side channels): band by band, in
    place, ``value`` a row-band value in the same bands or a plain tensor as
    :func:`_local` takes it."""
    x, index, value = args
    if not isinstance(x, RowBands):
        raise _no_rule(f"Tensor.__setitem__ of a plain tensor {tuple(x.shape)} by a row-band value")
    index, k = _index(x, index, "Tensor.__setitem__")
    if isinstance(index[k], int) or index[k].indices(x.height) != (0, x.height, 1):
        raise _no_rule(f"Tensor.__setitem__ of an index that cuts the rows ({index[k]!r} of {x.height})")
    target = _getitem(func, (x, index), {})  # views of the bands
    value = _onto(func, target, value)
    for j, b in enumerate(target.bands):
        b.copy_(_local(func, value, j, target))


def _permute(func, args, kwargs):
    x, dims = args[0], args[1:] or (kwargs["dims"],)
    if len(dims) == 1 and not isinstance(dims[0], int):
        dims = tuple(dims[0])
    dims = tuple(d % x.ndim for d in dims)
    return x.like([b.permute(dims) for b in x.bands], dims.index(x.axis))


def _expand_as(func, args, kwargs):
    t, x = args
    if isinstance(t, RowBands) or not isinstance(x, RowBands):
        raise _no_rule("Tensor.expand_as of a row-band value")
    return x.like([_local(func, t, j, x).expand_as(b) for j, b in enumerate(x.bands)])


def _owned(
    starts: Sequence[int], out_height: int, first_row: Callable[[int], int], empty: bool = False
) -> List[Tuple[int, int]]:
    """Each band's output rows ``[o0, o1)``: from ``first_row(start)`` (0 for
    the first band) to the next band's, the last to ``out_height``. A band
    with none raises, unless ``empty`` allows it where the output has fewer
    rows than there are bands."""
    firsts = [0] + [min(first_row(s), out_height) for s in starts[1:]]
    spans = list(zip(firsts, firsts[1:] + [out_height]))
    if any(o1 <= o0 for o0, o1 in spans) and not (empty and out_height < len(starts)):
        raise _no_rule(f"a band with no output rows ({spans} of {out_height})")
    return spans


def _spatial(v, nd: int) -> Tuple[int, ...]:
    return (v,) * nd if isinstance(v, int) else tuple(v)


def _with_rows(v: Tuple[int, ...], r: int, value: int) -> Tuple[int, ...]:
    """``v`` with its entry ``r`` (the rows') set to ``value``."""
    return (*v[:r], value, *v[r + 1 :])


def _conv(func, args, kwargs):
    """``conv2d`` on NCHW bands and ``conv3d`` on NCDHW bands (the rows the
    second spatial dimension, FLAVR's and STMFNet's clips): each band takes
    the rows its outputs read from its neighbours (zeros beyond the global
    top and bottom only); the other spatial dimensions keep their own
    padding."""
    x, weight, bias, stride, padding, dilation, groups = _bind(
        func, ("input", "weight", "bias", "stride", "padding", "dilation", "groups"), (None, None, None, 1, 0, 1, 1),
        args, kwargs,
    )
    nd = 2 if func is torch.conv2d else 3
    if not isinstance(x, RowBands) or x.ndim != nd + 2 or x.axis != nd or isinstance(weight, RowBands):
        raise _no_rule(f"{_name(func)} of a value without {'NCHW' if nd == 2 else 'NCDHW'} row bands as its input")
    if padding == "same" and nd == 2:
        return _conv2d_same(func, x, weight, bias, stride, dilation, groups)
    if isinstance(padding, str):
        if padding != "valid":
            raise _no_rule(f"{_name(func)} with padding={padding!r}")
        padding = 0
    r = nd - 2  # the rows among the spatial dimensions
    stride, padding, dilation = _spatial(stride, nd), _spatial(padding, nd), _spatial(dilation, nd)
    sh, ph = stride[r], padding[r]
    reach = dilation[r] * (weight.shape[x.axis] - 1)
    out_h = (x.height + 2 * ph - reach - 1) // sh + 1
    # a band owns the outputs whose middle input row (o * sh - ph + reach //
    # 2) is its own: for a convolution that pads itself (reach = 2 * ph) the
    # outputs line up with the input's bands, and so do those of a VALID
    # convolution after F.pad (the replicate-padded 3x3 of M2M's flow net)
    # (X4K's coarsest flow at 1/256 of a 512-row frame has one row: a band
    # may then own none, and takes one computed and dropped)
    spans = _owned(x.starts, out_h, lambda s: -(-(s + ph - reach // 2) // sh), empty=True)
    out = []
    for j, (o0, o1) in enumerate(spans):
        dev = x.bands[j].device
        rows = x.rows(o0 * sh - ph, (max(o1, o0 + 1) - 1) * sh - ph + reach + 1, j)
        b = None if bias is None else bias.to(dev)
        y = func(rows, weight.to(dev), b, stride, _with_rows(padding, r, 0), dilation, groups)
        out.append(y if o1 > o0 else y.narrow(x.axis, 0, 0))
    return RowBands(out, [o0 for o0, _ in spans], out_h, x.axis)


def _conv2d_same(func, x: RowBands, weight, bias, stride, dilation, groups):
    """``conv2d(padding="same")`` as the explicit pad torch applies:
    ``dilation * (k - 1)`` rows (columns) in all, ``floor(half)`` on top
    (left) and the rest below (right), so an even kernel reads one row below
    and none above. Each band owns the outputs of its own rows (whose
    middle input row is its own, as :func:`_conv`) and reads the halo
    around them, zeros beyond the global top and bottom only."""
    if _pair(stride) != (1, 1):
        raise _no_rule(f"conv2d(padding='same') with stride {stride}")
    dh, dw = _pair(dilation)
    reach, reach_w = dh * (weight.shape[2] - 1), dw * (weight.shape[3] - 1)
    top, left = reach // 2, reach_w // 2
    out = []
    for j, (b, a) in enumerate(zip(x.bands, x.starts)):
        dev = b.device
        rows = x.rows(a - top, a + b.shape[2] + reach - top, j)
        pw = left
        if reach_w - left != left:  # an even kernel's extra column on the right
            rows, pw = F.pad(rows, (left, reach_w - left)), 0
        out.append(func(rows, weight.to(dev), None if bias is None else bias.to(dev), 1, (0, pw), (dh, dw), groups))
    return x.like(out)


def _conv_transpose(func, args, kwargs):
    """``conv_transpose2d`` on NCHW bands and ``conv_transpose3d`` on NCDHW
    bands: each band the input rows its outputs read (one from each
    neighbour for ``(4, 2, 1)``), the result cropped to its own rows."""
    x, weight, bias, stride, padding, output_padding, groups, dilation = _bind(
        func, ("input", "weight", "bias", "stride", "padding", "output_padding", "groups", "dilation"),
        (None, None, None, 1, 0, 0, 1, 1), args, kwargs,
    )
    nd = 2 if func is torch.conv_transpose2d else 3
    if not isinstance(x, RowBands) or x.ndim != nd + 2 or x.axis != nd or isinstance(weight, RowBands):
        raise _no_rule(f"{_name(func)} of a value without {'NCHW' if nd == 2 else 'NCDHW'} row bands as its input")
    r = nd - 2
    stride, padding = _spatial(stride, nd), _spatial(padding, nd)
    output_padding, dilation = _spatial(output_padding, nd), _spatial(dilation, nd)
    sh, ph = stride[r], padding[r]
    if dilation[r] != 1 or output_padding[r] != 0:
        raise _no_rule(f"{_name(func)} with row dilation {dilation[r]} or row output_padding {output_padding[r]}")
    k = weight.shape[x.axis]
    out_h = (x.height - 1) * sh - 2 * ph + k
    spans = _owned(x.starts, out_h, lambda s: s * sh)
    out = []
    for j, (o0, o1) in enumerate(spans):
        dev = x.bands[j].device
        # the input rows whose taps reach outputs o0 .. o1 - 1 (output o =
        # i * sh - ph + tap)
        lo = max(-(-(o0 + ph - (k - 1)) // sh), 0)
        hi = min((o1 - 1 + ph) // sh, x.height - 1)
        b = None if bias is None else bias.to(dev)
        y = func(x.rows(lo, hi + 1, j), weight.to(dev), b, stride, _with_rows(padding, r, 0), output_padding, groups, dilation)
        out.append(y.narrow(x.axis, o0 - lo * sh + ph, o1 - o0))
    return RowBands(out, [o0 for o0, _ in spans], out_h, x.axis)


def _pixel_shuffle(func, args, kwargs):
    x, r = _bind(func, ("input", "upscale_factor"), (None, None), args, kwargs)
    if x.axis != 2:
        raise _no_rule("pixel_shuffle of a value whose rows are not dimension 2")
    return RowBands([func(b, r) for b in x.bands], [s * r for s in x.starts], x.height * r, 2)


def _pixel_unshuffle(func, args, kwargs):
    """``pixel_unshuffle(r)`` (CAIN's space-to-depth by 8): band by band on
    bands re-banded to start on multiples of ``r``, each band's rows and
    first row divided by ``r``."""
    x, r = _bind(func, ("input", "downscale_factor"), (None, None), args, kwargs)
    if x.axis != 2 or x.height % r:
        raise _no_rule(f"pixel_unshuffle({r}) of {x!r} (NCHW rows that {r} divides)")
    x = x.on_multiples(r, x.height // r, f"pixel_unshuffle({r})")
    return RowBands([func(b, r) for b in x.bands], [s // r for s in x.starts], x.height // r, 2)


_INTERPOLATE = tuple(inspect.signature(F.interpolate).parameters)


def _interpolate(func, args, kwargs):
    x, size, scale_factor, mode, align_corners, recompute, antialias = _bind(
        func, _INTERPOLATE, (None, None, None, "nearest", None, None, False), args, kwargs
    )
    if mode == "nearest" and not antialias and not recompute and x.axis == 2:
        return _nearest(func, x, size, scale_factor)
    if mode != "bilinear" or antialias or size is None or scale_factor is not None or x.axis != 2:
        raise _no_rule(
            f"interpolate(mode={mode!r}, align_corners={align_corners}, antialias={antialias}, "
            f"size={size}, scale_factor={scale_factor}) (bilinear to a size, or nearest)"
        )
    out_h, out_w = _pair(size)
    h = x.height
    if align_corners:
        return _bilinear_rows(func, x, out_h, out_w, align_corners=True)
    kw = dict(mode="bilinear", align_corners=False)
    if h % out_h == 0:
        s = h // out_h
        x = x.on_multiples(s, out_h, f"interpolate(mode='bilinear') from {h} to {out_h} rows")
        return RowBands(
            [func(b, size=(b.shape[2] // s, out_w), **kw) for b in x.bands], [a // s for a in x.starts], out_h, 2
        )
    if out_h % h == 0:
        s = out_h // h
        out = []
        for j, (b, a) in enumerate(zip(x.bands, x.starts)):
            lo, hi = max(a - 1, 0), min(a + b.shape[2] + 1, h)
            y = func(x.rows(lo, hi, j), size=((hi - lo) * s, out_w), **kw)
            out.append(y.narrow(2, (a - lo) * s, b.shape[2] * s))
        return RowBands(out, [a * s for a in x.starts], out_h, 2)
    return _bilinear_rows(func, x, out_h, out_w)


def _resized_starts(x: RowBands, out_h: int) -> List[Tuple[int, int]]:
    """Each band's output rows of a resize of ``x`` to ``out_h`` rows: from
    ``floor(start * out_h / height)``, which is where the next level of a
    pyramid of 2x2 poolings starts its band (FILM's 67 -> 135 rows)."""
    return _owned(x.starts, out_h, lambda s: s * out_h // x.height)


def _bilinear_rows(func, x: RowBands, out_h: int, out_w: int, align_corners: bool = False) -> RowBands:
    """Bilinear to ``out_h`` rows by a ratio that is not an integer
    (``align_corners=False``), or by any ratio with ``align_corners=True``
    (STMFNet's kernel maps, upscaled by 2 and 4: output row ``o`` reads
    input row ``o * (height - 1) / (out_h - 1)``, the global ratio, never a
    band's): the rows as torch maps them (source ``max(scale * (dst + 0.5)
    - 0.5, 0)`` with ``scale = height / out_h``, or ``scale * dst`` with
    ``scale = (height - 1) / (out_h - 1)``, in the op's accumulation type,
    the lower tap ``floor``, the upper one a row below but at the last row),
    on the input rows each band's outputs read; then the columns by
    ``func`` at the rows' own height, in that type, and one rounding to the
    input's dtype. The same two-tap sums as the op on the whole tensor, rows
    first."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    h = x.height
    if align_corners:
        scale = torch.tensor(h - 1, dtype=acc) / (out_h - 1) if out_h > 1 else torch.zeros((), dtype=acc)
    else:
        scale = torch.tensor(h, dtype=acc) / out_h
    spans = _resized_starts(x, out_h)
    out = []
    for j, (o0, o1) in enumerate(spans):
        dst = torch.arange(o0, o1, dtype=acc)
        src = scale * dst if align_corners else (scale * (dst + 0.5) - 0.5).clamp_min(0.0)
        lo_row = src.to(torch.int64).clamp_max(h - 1)
        hi_row = torch.where(lo_row < h - 1, lo_row + 1, lo_row)
        lam = (src - lo_row.to(acc)).view(1, 1, -1, 1)
        first, last = int(lo_row[0]), int(hi_row[-1])
        rows = x.rows(first, last + 1, j)
        dev = rows.device
        top = rows.index_select(2, (lo_row - first).to(dev)).to(acc)
        bottom = rows.index_select(2, (hi_row - first).to(dev)).to(acc)
        lam = lam.to(dev)
        y = ((1.0 - lam) * top + lam * bottom).contiguous(memory_format=_memory_format(rows))
        if out_w != x.shape[3]:
            y = func(y, size=(o1 - o0, out_w), mode="bilinear", align_corners=align_corners)
        out.append(y.to(x.dtype))
    return RowBands(out, [o0 for o0, _ in spans], out_h, 2)


def _nearest(func, x: RowBands, size, scale_factor) -> RowBands:
    """Nearest ``interpolate`` by an integer factor of the rows (``size=``
    or ``scale_factor=``): band by band, each band's output its own rows
    times the factor from its first row times the factor (an upscale reads
    no other rows); a downscale by ``s`` needs every band to start on a
    multiple of ``s``."""
    h = x.height
    if size is not None:
        out_h = _pair(size)[0]
    elif scale_factor is not None:
        sf = _pair(scale_factor)[0] if isinstance(scale_factor, (tuple, list)) else scale_factor
        out_h = math.floor(h * sf)
        if sf < 1 or sf != int(sf):
            raise _no_rule(f"interpolate(mode='nearest', scale_factor={scale_factor}) (an integer upscale of the rows)")
    else:
        raise TypeError("interpolate: size or scale_factor")
    if out_h % h == 0:
        up, down = out_h // h, 1
    elif h % out_h == 0:
        up, down = 1, h // out_h
        x = x.on_multiples(down, out_h, f"interpolate(mode='nearest') from {h} to {out_h} rows")
    else:
        raise _no_rule(f"interpolate(mode='nearest') from {h} to {out_h} rows (an integer factor)")
    out = []
    for b in x.bands:
        # a band without rows (a value of fewer rows than bands): torch refuses
        # it, so a row of zeros is resized and its rows dropped
        src = b if b.shape[2] else b.new_zeros((*b.shape[:2], down, b.shape[3]))
        if size is not None:
            y = func(src, size=(src.shape[2] * up // down, _pair(size)[1]), mode="nearest")
        else:
            y = func(src, scale_factor=scale_factor, mode="nearest")
        out.append(y if b.shape[2] else y.narrow(2, 0, 0))
    return RowBands(out, [a * up // down for a in x.starts], out_h, 2)


def _pad(func, args, kwargs):
    """``F.pad``: the top pad goes to the first band and the bottom pad to
    the last; the other dimensions' pads to every band. Constant and
    replicate pads band by band (the first band's first row and the last
    band's last row are the frame's); a reflect pad takes its rows, ``top``
    to 1 and ``height - 2`` down to ``height - 1 - bottom``, from whichever
    bands hold them (a pad longer than the band that takes it reads its
    neighbours), reversed, and pads the other dimensions by reflection band
    by band (the reflection is separable, so the order does not matter)."""
    x, pad, mode, value = _bind(func, ("input", "pad", "mode", "value"), (None, None, "constant", None), args, kwargs)
    if mode not in ("constant", "replicate", "reflect"):
        raise _no_rule(f"F.pad(mode={mode!r})")
    pad = list(pad)
    k = x.ndim - 1 - x.axis  # the pair of pad that the rows take
    top, bottom = (pad[2 * k], pad[2 * k + 1]) if 2 * k < len(pad) else (0, 0)
    if top < 0 or bottom < 0:
        raise _no_rule("F.pad that crops rows")
    if mode == "reflect" and max(top, bottom) >= x.height:
        raise RuntimeError(f"F.pad(mode='reflect'): a pad of {max(top, bottom)} rows of {x.height}")
    out, last = [], len(x.bands) - 1
    for j, b in enumerate(x.bands):
        p = list(pad)
        if 2 * k < len(p):
            p[2 * k], p[2 * k + 1] = (top if j == 0 else 0), (bottom if j == last else 0)
        if mode != "reflect":
            out.append(func(b, p, mode=mode, value=value))
            continue
        if 2 * k < len(p):
            p[2 * k] = p[2 * k + 1] = 0
        pieces = [b]
        if j == 0 and top:
            pieces.insert(0, x.rows(1, top + 1, j).flip(x.axis))
        if j == last and bottom:
            pieces.append(x.rows(x.height - 1 - bottom, x.height - 1, j).flip(x.axis))
        rows = pieces[0] if len(pieces) == 1 else torch.cat(pieces, x.axis)
        out.append(func(rows, p, mode=mode) if any(p) else rows)
    return x.like(out) if top == 0 and bottom == 0 else RowBands(
        out, [0] + [s + top for s in x.starts[1:]], x.height + top + bottom, x.axis
    )


def _warp_rule(func, args, kwargs):
    img, flow, padding_mode, prefer_wide, row0 = _bind(
        func, ("img", "flow", "padding_mode", "prefer_wide", "row0"), (None, None, "border", False, 0), args, kwargs
    )
    if not isinstance(flow, RowBands) or row0 != 0 or flow.axis != 1:
        raise _no_rule("ops.warp.warp of other than NHWC row bands of a flow")
    if isinstance(img, RowBands) and (img.height, img.axis) == (flow.height, flow.axis):
        # gathered whole onto each band's device: its own edges need not be the flow's
        whole = lambda j: img.rows(0, img.height, j)  # noqa: E731
    elif isinstance(img, torch.Tensor) and img.dim() == 4 and img.shape[1] == flow.height:
        # a plain source (XVFI's f32 ones plane): whole already, moved to the band's device
        whole = lambda j: img.to(flow.bands[j].device)  # noqa: E731
    else:
        raise _no_rule(f"ops.warp.warp of a plain source {tuple(img.shape)} by the flow {flow!r}")
    out = [
        func(whole(j), f, padding_mode=padding_mode, prefer_wide=prefer_wide, row0=a)
        for j, (f, a) in enumerate(zip(flow.bands, flow.starts))
    ]
    return flow.like(out)


def _avg_pool2d(func, args, kwargs):
    x, kernel, stride, padding, ceil_mode, count_include_pad, divisor = _bind(
        func, ("input", "kernel_size", "stride", "padding", "ceil_mode", "count_include_pad", "divisor_override"),
        (None, None, None, 0, False, True, None), args, kwargs,
    )
    (kh, kw) = _pair(kernel)
    sh, sw = _pair(stride if stride not in (None, []) else kernel)
    if x.axis != 2 or kh != sh or _pair(padding) != (0, 0) or ceil_mode:
        raise _no_rule(
            f"avg_pool2d(kernel {kernel}, stride {stride}, padding {padding}, ceil_mode {ceil_mode}) on bands from rows "
            f"{x.starts} (windows of their own rows only)"
        )
    x = x.on_multiples(sh, x.height // sh, f"avg_pool2d({kernel})")
    out = [func(b, (kh, kw), (sh, sw), 0, False, count_include_pad, divisor) for b in x.bands]
    return RowBands(out, [a // sh for a in x.starts], x.height // sh, 2)


def _dims(dim, ndim: int) -> Tuple[int, ...]:
    if dim is None:
        return tuple(range(ndim))
    return tuple(sorted({d % ndim for d in ((dim,) if isinstance(dim, int) else dim)}))


def _band_sums(x: RowBands, dims: Tuple[int, ...], keepdim: bool, each: Callable = lambda b: b) -> torch.Tensor:
    """The sum over ``dims`` (the rows among them) of ``each(band)``, each
    band's partial sum moved to band 0's device and added in band order; in
    f32 for half-precision bands, as torch accumulates their sums (the
    caller rounds once)."""
    dev = x.bands[0].device
    acc = torch.float32 if x.dtype in (torch.float16, torch.bfloat16) else None
    total = None
    for b in x.bands:
        part = each(b).sum(dims, keepdim=keepdim, dtype=acc).to(dev)
        total = part if total is None else total + part
    return total


def _reduce(func, args, kwargs):
    """``sum``, ``mean``, ``var``, ``var_mean`` and ``std_mean``: over
    dimensions without the rows, band by band; over the rows, from partial
    sums in band order into a plain tensor on the value's device (``var``
    from the mean first, as torch's: each band's sum of squared deviations
    from it, added in band order, over the global count less
    ``correction``; ``var_mean`` returns both, as AMT's
    ``common.instance_norm`` reads them, ``std_mean`` the root of ``var``
    and the mean, as Sepconv's frame statistics)."""
    name = _name(func).rsplit(".", 1)[-1]
    if name in ("var", "var_mean", "std_mean"):
        x, dim, unbiased, keepdim, correction = _bind(
            func, ("input", "dim", "unbiased", "keepdim", "correction"), (None, None, None, False, None), args, kwargs
        )
        if unbiased is not None and correction is not None:
            raise TypeError("var: unbiased and correction together")
        correction = correction if correction is not None else (1 if unbiased in (None, True) else 0)
        local = dict(correction=correction, keepdim=keepdim)
    else:
        x, dim, keepdim, dtype = _bind(func, ("input", "dim", "keepdim", "dtype"), (None, None, False, None), args, kwargs)
        if dtype is not None:
            raise _no_rule(f"{_name(func)} with dtype=")
        local = dict(keepdim=keepdim)
    dims = _dims(dim, x.ndim)
    if x.axis not in dims:
        axis = x.axis if keepdim else x.axis - sum(d < x.axis for d in dims)
        out = [func(b, dims, **local) for b in x.bands]
        if name in ("var_mean", "std_mean"):
            return tuple(x.like([o[i] for o in out], axis) for i in range(2))
        return x.like(out, axis)
    count = math.prod(x.shape[d] for d in dims)
    total = _band_sums(x, dims, keepdim)
    # half-precision bands' f32 sums, rounded once to their dtype
    rounded = (lambda t: t.to(x.dtype)) if total.dtype != x.dtype and x.dtype.is_floating_point else (lambda t: t)
    if name == "sum":
        return rounded(total)
    mean = total / count
    if name == "mean":
        return rounded(mean)
    centre = mean if keepdim else mean.reshape([1 if d in dims else n for d, n in enumerate(x.shape)])
    sq = _band_sums(x, dims, keepdim, lambda b: (b - centre.to(b.device)).square())
    var = sq / max(count - correction, 0)
    if name == "std_mean":
        return rounded(var.sqrt()), rounded(mean)
    return (rounded(var), rounded(mean)) if name == "var_mean" else rounded(var)


def _extreme(func, args, kwargs):
    """``amax`` and ``amin``: over dimensions without the rows, band by
    band; over the rows, each band's own first, then the bands' in band
    order into a plain tensor on the value's device (exact: a maximum needs
    no order)."""
    x, dim, keepdim = _bind(func, ("input", "dim", "keepdim"), (None, (), False), args, kwargs)
    dims = _dims(None if dim in ((), []) else dim, x.ndim)
    if x.axis not in dims:
        axis = x.axis if keepdim else x.axis - sum(d < x.axis for d in dims)
        return x.like([func(b, dims, keepdim) for b in x.bands], axis)
    pick = torch.maximum if _name(func).endswith("amax") else torch.minimum
    dev = x.bands[0].device
    total = None
    for b in x.bands:
        part = func(b, dims, keepdim).to(dev)
        total = part if total is None else pick(total, part)
    return total


def _index_select(func, args, kwargs):
    """``index_select``: of another dimension, band by band; of the rows
    (FILM's nearest resize, ``common.resize_nearest``), each band owns the
    outputs from ``floor(start * len(index) / height)`` (the starts of
    :func:`_bilinear_rows`) and gathers the input rows they name from every
    band that holds them."""
    x, dim, index = _bind(func, ("input", "dim", "index"), (None, None, None), args, kwargs)
    if isinstance(index, RowBands) or index.dim() != 1:
        raise _no_rule("index_select by other than a plain 1-D index")
    dim %= x.ndim
    if dim != x.axis:
        return x.like([func(b, dim, index.to(b.device)) for b in x.bands])
    idx = index.cpu()
    if len(idx) and (int(idx.min()) < 0 or int(idx.max()) >= x.height):
        raise IndexError(f"index_select: an index outside the {x.height} rows")
    spans = _resized_starts(x, len(idx))
    out = []
    for j, (o0, o1) in enumerate(spans):
        part = idx[o0:o1]
        lo, hi = int(part.min()), int(part.max())
        out.append(func(x.rows(lo, hi + 1, j), dim, (part - lo).to(x.bands[j].device)))
    return RowBands(out, [o0 for o0, _ in spans], len(idx), x.axis)


def _conv2x2_up2x_rule(func, args, kwargs):
    """``common.conv2x2_up2x`` (nearest 2x, then a 2x2 ``padding="same"``
    convolution) of NCHW bands: each band with the one row below it that
    the taps read (zeros below the global bottom), its result's first
    ``2 * rows`` rows from twice its first row."""
    x, weight, bias = _bind(func, ("x", "weight", "bias"), (None, None, None), args, kwargs)
    if not isinstance(x, RowBands) or x.axis != 2 or isinstance(weight, RowBands):
        raise _no_rule("common.conv2x2_up2x of a value without NCHW row bands")
    out = []
    for j, (b, a) in enumerate(zip(x.bands, x.starts)):
        dev = b.device
        y = func(x.rows(a, a + b.shape[2] + 1, j), weight.to(dev), None if bias is None else bias.to(dev))
        out.append(y.narrow(2, 0, 2 * b.shape[2]))
    return RowBands(out, [2 * a for a in x.starts], 2 * x.height, 2)


def _einsum(func, args, kwargs):
    """``torch.einsum`` with one operand in row bands, whose row subscript
    no other operand has and the result keeps: band by band."""
    if kwargs or not isinstance(args[0], str):
        raise _no_rule("torch.einsum (an equation string and operands only)")
    eq, ops = args[0].replace(" ", ""), args[1:]
    banded = [i for i, v in enumerate(ops) if isinstance(v, RowBands)]
    lhs, _, out_sub = eq.partition("->")
    subs = lhs.split(",")
    if len(banded) != 1 or not out_sub or "." in eq or len(subs) != len(ops):
        raise _no_rule(f"torch.einsum({eq!r}) of {len(banded)} row-band operands (one, with an explicit result)")
    x = ops[banded[0]]
    row = subs[banded[0]][x.axis]
    if row not in out_sub or any(row in sub for i, sub in enumerate(subs) if i != banded[0]):
        raise _no_rule(f"torch.einsum({eq!r}) that sums over or mixes the rows")
    out = []
    for j, b in enumerate(x.bands):
        local = [b if i == banded[0] else v.to(b.device) for i, v in enumerate(ops)]
        out.append(func(eq, *local))
    return x.like(out, out_sub.index(row))


def _repeat(func, args, kwargs):
    x, sizes = args[0], _sizes(args[1:])
    if kwargs or len(sizes) != x.ndim or sizes[x.axis] != 1:
        raise _no_rule(f"Tensor.repeat{tuple(sizes)} of {x!r} (of the other dimensions only)")
    return x.like([b.repeat(*sizes) for b in x.bands])


def _sizes(args) -> list:
    """A shape given as ``*sizes`` or as one sequence."""
    return list(args[0]) if len(args) == 1 and not isinstance(args[0], int) else list(args)


def _reshape(func, args, kwargs):
    """``reshape`` and ``view`` of the dimensions before the rows (AMT's
    split of the batch), or of the dimensions after them (FLAVR's and
    STMFNet's merge of time and channels, ``[B, H, W, T, C] -> [B, H, W,
    T * C]``): band by band; a shape that moves or merges the rows raises,
    naming the method."""
    x, shape = args[0], _sizes(args[1:])
    if shape.count(-1) == 1:
        known = math.prod(n for n in shape if n != -1)
        shape[shape.index(-1)] = math.prod(x.shape) // known if known else 0
    tail = x.ndim - x.axis  # the rows and the dimensions after them
    head = tuple(x.shape)[: x.axis + 1]  # the rows and the dimensions before them
    if kwargs or math.prod(shape) != math.prod(x.shape):
        axis = None
    elif len(shape) >= tail and tuple(shape[-tail:]) == tuple(x.shape)[-tail:]:
        axis = len(shape) - tail
    elif tuple(shape[: x.axis + 1]) == head:
        axis = x.axis
    else:
        axis = None
    if axis is None:
        what = "Tensor.view" if func is torch.Tensor.view else "Tensor.reshape"
        raise _no_rule(f"{what}{tuple(shape)} of {x!r} (that moves or merges the rows)")
    return x.like([func(b, (*shape[:axis], b.shape[x.axis], *shape[axis + 1 :])) for b in x.bands], axis)


def _expand(func, args, kwargs):
    """``Tensor.expand`` of the dimensions before the rows (AMT's frames
    tiled over its flows), new leading ones among them; the rows keep their
    size."""
    x, sizes = args[0], _sizes(args[1:])
    axis = x.axis + len(sizes) - x.ndim
    if kwargs or axis < x.axis or sizes[axis] not in (-1, x.height):
        raise _no_rule(f"Tensor.expand{tuple(sizes)} of {x!r} (that changes the rows)")
    return x.like([b.expand(*sizes[:axis], b.shape[x.axis], *sizes[axis + 1 :]) for b in x.bands], axis)


def _unflatten(func, args, kwargs):
    x, dim, sizes = _bind(func, ("input", "dim", "sizes"), (None, None, None), args, kwargs)
    dim %= x.ndim
    if dim == x.axis:
        raise _no_rule("Tensor.unflatten of the rows")
    return x.like([b.unflatten(dim, sizes) for b in x.bands], x.axis + (len(sizes) - 1 if dim < x.axis else 0))


def _bandwise(func, args, kwargs):
    """A function of one value that is row-local (``models.m2m._repeat_branches``)."""
    if len(args) != 1 or kwargs or not isinstance(args[0], RowBands):
        raise _no_rule(f"{_name(func)} of other than one row-band value")
    return args[0].like([func(b) for b in args[0].bands])


def _costvol_rule(func, args, kwargs):
    one, two = _bind(func, ("ten_one", "ten_two"), (None, None), args, kwargs)
    if not (isinstance(one, RowBands) and isinstance(two, RowBands)) or one.axis != 2:
        raise _no_rule("ops.costvol.costvol_func of other than NCHW row bands of both tensors")
    two = _onto(func, one, two)
    out = []
    for j, (b, a) in enumerate(zip(one.bands, one.starts)):
        # the +-R rows around the band (zeros beyond the frame's top and
        # bottom only) and R zero columns on each side
        halo = F.pad(two.rows(a - costvol.R, a + b.shape[2] + costvol.R, j), (costvol.R,) * 2)
        out.append(costvol.costvol_padded(b, halo))
    return one.like(out)


class _CutRows(torch.autograd.Function):
    """A whole-frame partial cut into the bands' rows along dimension 1, each
    piece moved to its band's device; the backward is one ``cat`` of the
    pieces' gradients on the partial's device (where autograd's ``narrow``
    and ``to`` would give each piece's gradient as a zero-filled whole
    frame)."""

    @staticmethod
    def forward(ctx, part: torch.Tensor, spans, devices):
        ctx.device = part.device
        return tuple(part.narrow(1, a, n).to(d) for (a, n), d in zip(spans, devices))

    @staticmethod
    def backward(ctx, *grads):
        return torch.cat([g.to(ctx.device) for g in grads], 1), None, None


def _softsplat_rule(func, args, kwargs):
    """The splat: band ``j``'s sources splat from their first row into a
    whole-frame f32 partial on band ``j``'s device (K2 with a band); band
    ``k`` of the result is the sum of every partial's rows of band ``k``,
    moved to band ``k``'s device and added in band order, cast once. With a
    gradient, partial ``j``'s is the bands of the result's gradient joined
    on band ``j``'s device (:class:`_CutRows`), which the splat's backward
    kernel reads on the band (``softsplat_partial``)."""
    x, flow = _bind(func, ("ten_in", "ten_flow"), (None, None), args, kwargs)
    if not (isinstance(x, RowBands) and isinstance(flow, RowBands)) or x.axis != 1:
        raise _no_rule("ops.softsplat.softsplat_func of other than NHWC row bands of the values and their flow")
    flow = _onto(func, x, flow)
    parts = [softsplat_partial(b, f, a, x.height) for b, f, a in zip(x.bands, flow.bands, x.starts)]
    spans = [(a, b.shape[1]) for b, a in zip(x.bands, x.starts)]
    pieces = [_CutRows.apply(part, spans, [b.device for b in x.bands]) for part in parts]
    out = []
    for k in range(len(spans)):
        total = None
        for cut in pieces:
            total = cut[k] if total is None else total + cut[k]
        out.append(total.to(x.dtype))
    return x.like(out)


def _batch_norm(func, args, kwargs):
    """``F.batch_norm`` on its stored statistics (``training=False``, IFUnet's
    ``nn.BatchNorm2d`` in eval): a per-channel affine, band by band. Batch
    statistics over the rows (``training=True``) raise."""
    x, mean, var, weight, bias, training, momentum, eps = _bind(
        func, ("input", "running_mean", "running_var", "weight", "bias", "training", "momentum", "eps"),
        (None, None, None, None, None, False, 0.1, 1e-5), args, kwargs,
    )
    if training:
        raise _no_rule("batch_norm with training=True (batch statistics over the rows)")
    stats = (mean, var, weight, bias)
    if not isinstance(x, RowBands) or x.axis == 1 or any(isinstance(v, RowBands) for v in stats):
        raise _no_rule("batch_norm of other than row bands by plain statistics")
    return x.like([
        func(b, *(None if v is None else v.to(b.device) for v in stats), False, momentum, eps) for b in x.bands
    ])


def _softmax(func, args, kwargs):
    """``softmax`` over a dimension other than the rows (IFUnet's blend
    weights over channels): band by band; over the rows it raises."""
    x, dim, dtype = _bind(func, ("input", "dim", "dtype"), (None, None, None), args, kwargs)
    if dim is None or dim % x.ndim == x.axis:
        raise _no_rule(f"softmax over the rows (dim {dim} of {x!r})")
    return x.like([func(b, dim) if dtype is None else func(b, dim, dtype=dtype) for b in x.bands])


def _convex_upsample_rule(func, args, kwargs):
    """``models.ifunet.convex_upsample`` of NCHW bands: each band's flow with
    the row above and below it that the 3x3 ``unfold`` taps read (zeros
    beyond the global top and bottom only, as ``padding=1`` gives) and its
    own mask, padded by a row each side whose outputs are cropped; its
    result the ``level`` x rows from ``level`` x its first row."""
    flow, mask, level = _bind(func, ("flow", "mask", "level"), (None, None, None), args, kwargs)
    if not (isinstance(flow, RowBands) and isinstance(mask, RowBands)) or flow.axis != 2:
        raise _no_rule("models.ifunet.convex_upsample of other than NCHW row bands of the flow and its mask")
    mask = _onto(func, flow, mask)
    out = []
    for j, (b, a) in enumerate(zip(flow.bands, flow.starts)):
        rows = b.shape[2]
        y = func(flow.rows(a - 1, a + rows + 1, j), F.pad(mask.bands[j], (0, 0, 1, 1)), level)
        out.append(y.narrow(2, level, level * rows))
    return RowBands(out, [level * a for a in flow.starts], level * flow.height, 2)


def _pad1_rule(func, args, kwargs):
    """``models.cain._reflect_pad1`` and ``models.momo._replicate_pad1`` (a
    reflection or replication pad of one pixel on each side, which hand a
    band over) of NCHW bands: each band with one halo row from each
    neighbour, padded by ``func``, keeps its own rows, so a padded row stays
    only at the global top (the first band's) and bottom (the last band's);
    the next convolution takes its own halo. Bit for bit the whole frame's
    rows."""
    (x,) = _bind(func, ("x",), (None,), args, kwargs)
    if not isinstance(x, RowBands) or x.axis != 2:
        raise _no_rule(f"{_name(func)} of a value without NCHW row bands")
    last = len(x.bands) - 1
    out = []
    for j, (b, a) in enumerate(zip(x.bands, x.starts)):
        n = b.shape[2]
        # func's rows: a padded row, rows lo .. hi - 1, a padded row
        y = func(x.rows(a - (j > 0), a + n + (j < last), j))
        out.append(y.narrow(2, 0 if j == 0 else 2, n + (j == 0) + (j == last)))
    return RowBands(out, [0] + [a + 1 for a in x.starts[1:]], x.height + 2, 2)


def _sepconv_rule(func, args, kwargs):
    """``ops.sepconv.sepconv_func`` (which hands a band over) of NHWC bands:
    band ``j`` of the filters (``ten_ver``'s bands; ``ten_hor`` on their
    edges) makes its own output rows from input rows ``o0`` to ``o1 + K -
    1``, its own and the ``K - 1`` that its vertical taps read below them
    in the input padded by ``(K - 1) / 2`` each side (so the frame's rows
    half of them above and half below), taken from every band that holds
    them; the pad itself lies in the input's first and last bands only."""
    ten_in, ver, hor = _bind(func, ("ten_in", "ten_ver", "ten_hor"), (None, None, None), args, kwargs)
    if not all(isinstance(v, RowBands) and v.axis == 1 for v in (ten_in, ver, hor)):
        raise _no_rule("ops.sepconv.sepconv_func of other than NHWC row bands of the input and both filters")
    hor = _onto(func, ver, hor)
    k = ver.shape[3]
    if ten_in.height != ver.height + k - 1:
        raise _no_rule(f"ops.sepconv.sepconv_func of {ten_in!r} by filters {ver!r} (an input padded by K - 1 rows)")
    return ver.like([
        func(ten_in.rows(a, a + b.shape[1] + k - 1, j), b, hor.bands[j]) for j, (b, a) in enumerate(zip(ver.bands, ver.starts))
    ])


def _reflected(r: int, height: int) -> int:
    """Row ``r`` of a frame of ``height`` rows reflected at its edges (the
    edge row not repeated), for a reach shorter than the frame."""
    return -r if r < 0 else 2 * (height - 1) - r if r >= height else r


def _upsampler_8tap_rule(func, args, kwargs):
    """``models.stmfnet._upsampler_8tap`` (which hands a band over) of NCHW
    bands: each band's column pass reads the 3 rows above it and the 4
    below it, from its neighbours, reflected only at the global top and
    bottom (``stmfnet.upsampler_8tap_rows``); its output is twice its rows
    from twice its first row. The row pass and the columns' reflection are
    the band's own."""
    filt, x = _bind(func, ("filt", "im"), (None, None), args, kwargs)
    if not isinstance(x, RowBands) or x.axis != 2 or isinstance(filt, RowBands):
        raise _no_rule("models.stmfnet._upsampler_8tap of a value without NCHW row bands")
    h = x.height
    if h < 5:
        raise RuntimeError(f"_upsampler_8tap: a reflect pad of 4 rows of {h}")
    out = []
    for j, (b, a) in enumerate(zip(x.bands, x.starts)):
        dev = b.device
        idx = [_reflected(r, h) for r in range(a - 3, a + b.shape[2] + 4)]
        lo, hi = min(idx), max(idx) + 1
        tall = x.rows(lo, hi, j)
        if idx != list(range(lo, hi)):
            tall = tall.index_select(2, torch.tensor(idx, device=dev) - lo).contiguous(memory_format=_memory_format(b))
        out.append(stmfnet.upsampler_8tap_rows(filt.to(dev), b, tall))
    return RowBands(out, [2 * a for a in x.starts], 2 * h, 2)


def _adacof_rule(func, args, kwargs):
    """``ops.adacof.adacof_func`` (which hands bands over) of NHWC bands:
    the replicate-padded input gathered whole onto each band's device (the
    warp's source rule: AdaCoF's offsets are learned and unbounded, so a tap
    may read any row), each band of the weight map (the offsets on its
    edges) making its own output rows from its first row (``row0``)."""
    ten_in, weight, alpha, beta, dilation, row0, out_rows = _bind(
        func, ("ten_in", "weight", "alpha", "beta", "dilation", "row0", "out_rows"), (None, None, None, None, 1, 0, None),
        args, kwargs,
    )
    if not all(isinstance(v, RowBands) and v.axis == 1 for v in (ten_in, weight, alpha, beta)) or row0 or out_rows is not None:
        raise _no_rule("ops.adacof.adacof_func of other than NHWC row bands of the input and its three maps")
    alpha, beta = _onto(func, weight, alpha), _onto(func, weight, beta)
    return weight.like([
        func(ten_in.rows(0, ten_in.height, j), w, alpha.bands[j], beta.bands[j], dilation, row0=a, out_rows=weight.height)
        for j, (w, a) in enumerate(zip(weight.bands, weight.starts))
    ])


def _correlation_rule(func, args, kwargs):
    """``ops.correlation.correlation_func`` (which hands bands over) of NHWC
    bands: each band of the first tensor against the ``+-4`` rows around it
    of the second (zeros beyond the frame's top and bottom only) and 4 zero
    columns on each side (``correlation_padded``); the counterpart of the
    cost volume's rule."""
    one, two = _bind(func, ("ten_one", "ten_two"), (None, None), args, kwargs)
    if not (isinstance(one, RowBands) and isinstance(two, RowBands)) or one.axis != 1:
        raise _no_rule("ops.correlation.correlation_func of other than NHWC row bands of both tensors")
    two = _onto(func, one, two)
    r = correlation.R
    out = []
    for j, (b, a) in enumerate(zip(one.bands, one.starts)):
        halo = F.pad(two.rows(a - r, a + b.shape[1] + r, j).float(), (0, 0, r, r))
        out.append(correlation.correlation_padded(b, halo))
    return one.like(out)


class _BandCorr:
    """``ops.bidir_corr.BidirCorr`` on NCHW row bands (AMT's correlation):
    each target's pyramid is built once per band, on the band's device, from
    the target gathered whole (the warp's source rule); each band's queries
    are its own rows of ``f0``/``f1``, looked up at its own rows of the
    coordinates (global pixel coordinates: AMT's ``coord`` spans the rows,
    :func:`_local`), into its rows of the windows. The same dots, f32 over
    each band's queries: f32 rounding apart from one device, not bits.
    With a gradient, each pyramid's gradient flows back through the
    gathered target into the bands that made it."""

    def __init__(self, f0: RowBands, f1: RowBands, levels: int, radius: int):
        self.radius, self.levels = radius, levels
        self.f0, self.f1 = f0, f1
        pp = 2 * radius + 2
        self.pyr0 = [_Pyramid(f0.gather(b.device), levels, pp) for b in f0.bands]
        self.pyr1 = [_Pyramid(f1.gather(b.device), levels, pp) for b in f1.bands]

    def lookup(self, coords0: RowBands, coords1: RowBands) -> Tuple[RowBands, RowBands]:
        return self._windows(self.f0, self.pyr1, coords0), self._windows(self.f1, self.pyr0, coords1)

    def _windows(self, query: RowBands, pyrs, coords) -> RowBands:
        if not isinstance(coords, RowBands) or coords.axis != 1:
            raise _no_rule(f"ops.bidir_corr.BidirCorr.lookup at {coords!r} (NHWC row bands of the coordinates)")
        coords = _onto(BidirCorr.lookup, query, coords.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return query.like([BidirCorr.windowed(self, q, p, c) for q, p, c in zip(query.bands, pyrs, coords.bands)])


def _bidir_corr_rule(func, args, kwargs):
    f0, f1, levels, radius = _bind(func, ("f0", "f1", "levels", "radius"), (None, None, 4, 3), args, kwargs)
    if not (isinstance(f0, RowBands) and isinstance(f1, RowBands)) or f0.axis != 2:
        raise _no_rule("ops.bidir_corr.BidirCorr of other than NCHW row bands of both feature maps")
    f1 = _onto(func, f0, f1)
    return _BandCorr(f0, f1, levels, radius)


# ---- GMFSS's GMFlow: attention and correlation against gathered keys ----------------------


def _nhwc_pair(func, a, b, what: str):
    """Two NHWC row-band values of one height (``b`` on ``a``'s edges), or
    the refusal naming ``what``."""
    if not (isinstance(a, RowBands) and isinstance(b, RowBands)) or a.axis != 1:
        raise _no_rule(f"{_name(func)} of other than NHWC row bands of {what}")
    return _onto(func, a, b)


def _transformer_rule(func, args, kwargs):
    """``models.gmfss._transformer`` (which hands bands over) of NHWC bands
    of both frames: each layer's linear maps, norms and MLP act on each
    token alone, so band by band; its attention takes each band's queries
    against the keys and values of every band, gathered whole onto the
    band's device (the warp's source rule), in the windows of the global
    rows (``gmfss._window_attention_rows``: the shifted layers' roll wraps
    the frame's last rows onto its first, whatever the bands; the shift
    mask is the whole frame's)."""
    p, f0, f1, splits = _bind(func, ("p", "f0", "f1", "splits"), (None, None, None, None), args, kwargs)
    f1 = _nhwc_pair(func, f0, f1, "both frames' features")
    b, h, w, c = f0.shape
    devs = [x.device for x in f0.bands]
    masks = [gmfss.shift_window_mask(h, w, splits, d, f0.dtype) for d in devs]

    def tokens(x):
        return x.reshape(b, -1, c)

    def attend(layer, sources, targets, with_shift):
        kv = [layer.keys(t) for t in targets]
        out = []
        for j, (s, d, a) in enumerate(zip(sources, devs, f0.starts)):
            k_, v = (torch.cat([t[i].to(d) for t in kv], 1) for i in (0, 1))
            out.append(layer(s, k_, v, h, w, splits, with_shift, masks[j], a))
        return out

    concat0 = [torch.cat([tokens(x), tokens(y)], 0) for x, y in zip(f0.bands, f1.bands)]
    concat1 = [torch.cat([tokens(y), tokens(x)], 0) for x, y in zip(f0.bands, f1.bands)]
    for i, layer in enumerate(p.layers):
        with_shift = i % 2 == 1
        concat0 = attend(layer.self_attn, concat0, concat0, with_shift)
        concat0 = attend(layer.cross_attn_ffn, concat0, concat1, with_shift)
        concat1 = [torch.cat([x[b:], x[:b]], 0) for x in concat0]
    return tuple(f0.like([x[half].reshape(b, -1, w, c) for x in concat0]) for half in (slice(0, b), slice(b, None)))


def _global_corr_rule(func, args, kwargs):
    """``models.gmfss._global_corr_softmax`` (which hands bands over): each
    band's rows of ``f0`` against ``f1`` gathered whole onto its device; the
    softmax runs over the keys, which are whole, and the coordinates are the
    frame's (``row0``)."""
    f0, f1, row0 = _bind(func, ("f0", "f1", "row0"), (None, None, 0), args, kwargs)
    f1 = _nhwc_pair(func, f0, f1, "both frames' features")
    if row0:
        raise _no_rule(f"{_name(func)} of row bands with row0={row0}")
    return f0.like([func(x, f1.rows(0, f1.height, j), a) for j, (x, a) in enumerate(zip(f0.bands, f0.starts))])


def _local_corr_rule(func, args, kwargs):
    """``models.gmfss._local_corr_softmax`` (which hands bands over): each
    band's rows of ``f0`` against the rows of ``f1`` ``r`` above and below
    them (zeros beyond the frame's top and bottom only), the validity mask
    and sample points of the frame's rows (``gmfss.local_corr_rows``)."""
    f0, f1, r = _bind(func, ("f0", "f1", "r"), (None, None, None), args, kwargs)
    f1 = _nhwc_pair(func, f0, f1, "both frames' features")
    return f0.like([
        gmfss.local_corr_rows(x, f1.rows(a - r, a + x.shape[1] + r, j), r, a, f0.height)
        for j, (x, a) in enumerate(zip(f0.bands, f0.starts))
    ])


def _flow_attn_rule(func, args, kwargs):
    """``models.gmfss._flow_attn`` (which hands bands over): the projections
    band by band; the global path takes each band's queries against the
    keys of every band and the flow, gathered whole onto its device
    (``gmfss.flow_attn_global``), the local one each band's keys and flow
    with the row above and below it (zeros beyond the frame's top and
    bottom only) for the 3x3 neighbourhoods (``gmfss.flow_attn_local``)."""
    p, feat, flow, local = _bind(func, ("p", "feat", "flow", "local"), (None, None, None, None), args, kwargs)
    flow = _nhwc_pair(func, feat, flow, "the features and the flow")
    q = [p.q_proj(x) for x in feat.bands]
    if not local:
        keys = [p.k_proj(x) for x in q]
        return feat.like([
            gmfss.flow_attn_global(qj, torch.cat([k.to(qj.device) for k in keys], 1), flow.rows(0, flow.height, j))
            for j, qj in enumerate(q)
        ])
    keys = feat.like([p.k_proj(x) for x in feat.bands])
    return feat.like([
        gmfss.flow_attn_local(qj, keys.rows(a - 1, a + qj.shape[1] + 1, j), flow.rows(a - 1, a + qj.shape[1] + 1, j))
        for j, (qj, a) in enumerate(zip(q, feat.starts))
    ])


def _convex_upsample4_rule(func, args, kwargs):
    """``models.gmfss._convex_upsample4`` (which hands bands over): the
    upsampler's convolutions through their own rules, then each band's
    convex combination of its ``4 * flow`` with the row above and below it
    (zeros beyond the frame's top and bottom only) into 4 times its rows
    from 4 times its first row (``gmfss.convex_combine4``)."""
    p, flow, feat = _bind(func, ("p", "flow", "feat"), (None, None, None), args, kwargs)
    feat = _nhwc_pair(func, flow, feat, "the flow and the features")
    m = p(torch.cat([flow, feat], -1).permute(0, 3, 1, 2))
    if m.starts != flow.starts:
        m = m.reband(flow.starts, _name(func))
    out = [
        gmfss.convex_combine4(mb, flow.rows(a - 1, a + mb.shape[2] + 1, j))
        for j, (mb, a) in enumerate(zip(m.bands, flow.starts))
    ]
    return RowBands(out, [4 * a for a in flow.starts], 4 * flow.height, 1)


def _vector_norm(func, args, kwargs):
    """``torch.linalg.vector_norm`` over dimensions without the rows (the
    flows' and Lab images' channels): band by band."""
    x, order, dim, keepdim, dtype = _bind(func, ("x", "ord", "dim", "keepdim", "dtype"), (None, 2, None, False, None), args, kwargs)
    dims = _dims(dim, x.ndim)
    if x.axis in dims:
        raise _no_rule(f"torch.linalg.vector_norm over the rows (dim {dim} of {x!r})")
    axis = x.axis if keepdim else x.axis - sum(d < x.axis for d in dims)
    return x.like([func(b, order, dims, keepdim, dtype=dtype) for b in x.bands], axis)


def _flip(func, args, kwargs):
    """``flip`` of dimensions without the rows (EISAI's (x, y) flows to (y,
    x)): band by band."""
    x, dims = args[0], _sizes(args[1:]) if args[1:] else list(kwargs["dims"])
    if x.axis in {d % x.ndim for d in dims}:
        raise _no_rule(f"flip of the rows (dims {dims} of {x!r})")
    return x.like([b.flip(dims) for b in x.bands])


def _max_pool2d(func, args, kwargs):
    """``F.max_pool2d`` (EISAI's opening, stride 1 on an input padded with
    -inf, and its ResNet's 3x3 stride-2 pool padded by 1): each band takes
    the rows its outputs' windows read from its neighbours, -inf beyond the
    global top and bottom only (the pool's own padding), and owns the
    outputs whose middle input row is its own (:func:`_conv`'s rule)."""
    x, kernel, stride, padding, dilation, ceil_mode, indices = _bind(
        func, ("input", "kernel_size", "stride", "padding", "dilation", "ceil_mode", "return_indices"),
        (None, None, None, 0, 1, False, False), args, kwargs,
    )
    (kh, kw), (ph, pw) = _pair(kernel), _pair(padding)
    sh, sw = _pair(stride if stride not in (None, []) else kernel)
    if not isinstance(x, RowBands) or x.axis != 2 or ceil_mode or indices or _pair(dilation) != (1, 1):
        raise _no_rule(f"max_pool2d(kernel {kernel}, stride {stride}, dilation {dilation}, ceil_mode {ceil_mode}) of {x!r}")
    out_h = (x.height + 2 * ph - kh) // sh + 1
    spans = _owned(x.starts, out_h, lambda s: -(-(s + ph - (kh - 1) // 2) // sh))
    out = [
        func(x.rows(o0 * sh - ph, (o1 - 1) * sh - ph + kh, j, fill=-math.inf), (kh, kw), (sh, sw), (0, pw))
        for j, (o0, o1) in enumerate(spans)
    ]
    return RowBands(out, [o0 for o0, _ in spans], out_h, 2)


class _BandPyramid:
    """EISAI's all-pairs correlation pyramid (``models.eisai._corr_pyramid``)
    on NCHW row bands of the query features: band ``j``'s levels hold its
    own query pixels against the target gathered whole onto its device, in
    f32. The pooling runs over the target's axes, which are whole, so each
    band's pyramid is its own. ``models.eisai._corr_lookup`` hands it over
    (:func:`_corr_lookup_rule`)."""

    def __init__(self, pyrs: List[List[torch.Tensor]], ref: RowBands):
        self.pyrs, self.ref = pyrs, ref

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return RowBands.__torch_function__(func, types, args, kwargs)


def _corr_pyramid_rule(func, args, kwargs):
    """``models.eisai._corr_pyramid`` (which hands bands over): each band's
    query rows against the target gathered whole (:class:`_BandPyramid`),
    whose ``cat`` carries the target's gradient back into every band."""
    f1, f2 = _bind(func, ("f1", "f2"), (None, None), args, kwargs)
    if not (isinstance(f1, RowBands) and isinstance(f2, RowBands)) or f1.axis != 2 or f2.height != f1.height:
        raise _no_rule(f"{_name(func)} of other than NCHW row bands of both feature maps")
    return _BandPyramid([func(q, f2.rows(0, f2.height, j)) for j, q in enumerate(f1.bands)], f1)


def _corr_lookup_rule(func, args, kwargs):
    """``models.eisai._corr_lookup`` of a :class:`_BandPyramid`: each band's
    windows from its own pyramid at its own rows of the NCHW coordinates
    (row bands, or a plain map of the frame's rows: the first step's
    ``coords0``, narrowed to each band's rows as :func:`_local` does)."""
    pyr, coords = _bind(func, ("pyr", "coords"), (None, None), args, kwargs)
    if not isinstance(pyr, _BandPyramid):
        raise _no_rule(f"{_name(func)} of a plain pyramid at {coords!r}")
    ref = pyr.ref
    if isinstance(coords, RowBands) and coords.axis != 2:
        raise _no_rule(f"{_name(func)} at {coords!r} (NCHW row bands of the coordinates)")
    coords = _onto(func, ref, coords)
    return ref.like([func(p, _local(func, coords, j, ref)) for j, p in enumerate(pyr.pyrs)])


def _convex_upsample_flow_rule(func, args, kwargs):
    """``models.eisai._convex_upsample_flow`` (which hands bands over) of
    NCHW bands: each band's flow with the row above and below it (zeros
    beyond the global top and bottom only) and its own mask, its result 8
    times its rows from 8 times its first row
    (``eisai.convex_upsample_flow_rows``)."""
    flow, mask = _bind(func, ("flow", "mask"), (None, None), args, kwargs)
    if not (isinstance(flow, RowBands) and isinstance(mask, RowBands)) or flow.axis != 2:
        raise _no_rule(f"{_name(func)} of other than NCHW row bands of the flow and its mask")
    mask = _onto(func, flow, mask)
    out = [
        eisai.convex_upsample_flow_rows(flow.rows(a - 1, a + m.shape[2] + 1, j), m)
        for j, (m, a) in enumerate(zip(mask.bands, flow.starts))
    ]
    return RowBands(out, [8 * a for a in flow.starts], 8 * flow.height, 2)


def _batch_edt_rule(func, args, kwargs):
    """``ops.edt.batch_edt`` (which hands bands over) of ``[N, 1, H, W]`` or
    ``[N, H, W]`` row bands: the x pass band by band (it is row-local), its
    result gathered whole onto each band's device for the y pass, which
    makes the band's own rows (``edt.y_pass``): the same integer squared
    distances, bit for bit."""
    (img,) = _bind(func, ("img",), (None,), args, kwargs)
    if not isinstance(img, RowBands) or img.axis != img.ndim - 2 or (img.ndim == 4 and img.shape[1] != 1):
        raise _no_rule(f"{_name(func)} of {img!r} (row bands of [N, 1, H, W] or [N, H, W] maps)")
    imgs = img[:, 0] if img.ndim == 4 else img
    h, w = imgs.height, imgs.shape[2]
    dtype = imgs.dtype if imgs.dtype.is_floating_point else torch.float32
    xs = imgs.like([edt.x_pass(b, float(h * h + w * w)) for b in imgs.bands])
    out = [edt.y_pass(xs.rows(0, h, j), a, b.shape[1], dtype) for j, (b, a) in enumerate(zip(imgs.bands, imgs.starts))]
    return img.like([o[:, None] for o in out] if img.ndim == 4 else out)


# ---- ATM and MoMo: Swin windows, layer and group norms, bicubic resizes and sampling -------------


def _layer_norm(func, args, kwargs):
    """``F.layer_norm`` over trailing dimensions that exclude the rows (ATM's
    fusion norm and each block's ``norm1``/``norm2`` on NHWC tokens): band
    by band."""
    x, shape, weight, bias, eps = _bind(
        func, ("input", "normalized_shape", "weight", "bias", "eps"), (None, None, None, None, 1e-5), args, kwargs
    )
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if not isinstance(x, RowBands) or x.axis >= x.ndim - len(shape) or any(isinstance(v, RowBands) for v in (weight, bias)):
        raise _no_rule(f"layer_norm over {len(shape)} trailing dimensions of {x!r} (dimensions after the rows)")
    return x.like([
        func(b, shape, None if weight is None else weight.to(b.device), None if bias is None else bias.to(b.device), eps)
        for b in x.bands
    ])


def _linear(func, args, kwargs):
    """``F.linear`` over the last dimension of NHWC bands (ATM's token
    projections and MLPs): band by band."""
    x, weight, bias = _bind(func, ("input", "weight", "bias"), (None, None, None), args, kwargs)
    if not isinstance(x, RowBands) or x.axis == x.ndim - 1 or isinstance(weight, RowBands) or isinstance(bias, RowBands):
        raise _no_rule(f"linear of {x!r} (row bands whose rows are not the last dimension, by plain weights)")
    return x.like([func(b, weight.to(b.device), None if bias is None else bias.to(b.device)) for b in x.bands])


def _rows_at(x: RowBands, src: Sequence[int], j: int) -> torch.Tensor:
    """The global rows ``src`` in order on band ``j``'s device (zeros for
    rows outside ``[0, height)``), each run of consecutive rows taken at once
    from the bands that hold it (:meth:`RowBands.rows`)."""
    pieces, lo = [], 0
    for k in range(1, len(src) + 1):
        if k == len(src) or src[k] != src[k - 1] + 1:
            pieces.append(x.rows(src[lo], src[k - 1] + 1, j))
            lo = k
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, x.axis)


def _windowed_rule(func, args, kwargs):
    """``models.atm._windowed`` (which hands a band over) of NHWC bands: each
    band computes the windows of the padded, rolled map that hold its own
    rows (``atm.window_rows_of``), reading their rows from its neighbours
    and, under the shift, the rows that the roll wraps from the frame's
    other end (zeros for the centred pad), with those windows' masks
    (``atm.windowed_rows``), and keeps its own rows of the result. A window
    across a band edge is computed by both bands, each keeping its rows."""
    blk, x, shift = _bind(func, ("blk", "x", "shift"), (None, None, 0), args, kwargs)
    if not isinstance(x, RowBands) or x.axis != 1:
        raise _no_rule(f"{_name(func)} of a value without NHWC row bands")
    h, w = x.height, x.shape[2]
    outs = []
    for j, (b, a) in enumerate(zip(x.bands, x.starts)):
        n = b.shape[1]
        lo = min(a, h - 1)  # a band without rows computes one window row and keeps none of it
        wins, src = atm.window_rows_of(h, blk.window, shift, lo, lo + max(n, 1))
        res = atm.windowed_rows(blk, _rows_at(x, src, j), shift, h, w, wins)
        keep = torch.tensor([src.index(g) for g in range(a, a + n)], dtype=torch.int64, device=b.device)
        outs.append([r.index_select(1, keep) for r in res])
    return tuple(x.like([o[i] for o in outs]) for i in range(len(outs[0])))


def _group_norm_silu_rule(func, args, kwargs):
    """``models.momo._group_norm_silu`` (which hands a band over) of NCHW
    bands: each group's mean, then its variance about that mean, in f32 from
    the bands' partial sums added in band order (as ``var_mean``'s rule),
    then the affine and SiLU band by band (``momo.group_affine_silu``)."""
    x, gn = _bind(func, ("x", "gn"), (None, None), args, kwargs)
    if not isinstance(x, RowBands) or x.axis != 2:
        raise _no_rule(f"{_name(func)} of a value without NCHW row bands")
    n, c, h, w = x.shape
    dev = x.bands[0].device
    views = [momo.group_view(b).float() for b in x.bands]
    count = h * w * (c // momo.GROUPS)

    def total(each):
        out = None
        for v in views:
            part = each(v).sum((1, 3), keepdim=True).to(dev)
            out = part if out is None else out + part
        return out

    mean = total(lambda v: v) / count
    var = total(lambda v: (v - mean.to(v.device)).square()) / count
    return x.like([momo.group_affine_silu(b, gn, mean.to(b.device), var.to(b.device)) for b in x.bands])


def _convex_upsampling8_rule(func, args, kwargs):
    """``models.momo._convex_upsampling8`` (which hands bands over) of NCHW
    bands: each band's flow with the row above and below it (zeros beyond
    the global top and bottom only) and its own rows of the mask, its result
    8 times its rows from 8 times its first row
    (``momo.convex_upsampling8_rows``)."""
    flow, mask = _bind(func, ("flow", "mask"), (None, None), args, kwargs)
    if not (isinstance(flow, RowBands) and isinstance(mask, RowBands)) or flow.axis != 2:
        raise _no_rule(f"{_name(func)} of other than NCHW row bands of the flow and its mask")
    mask = _onto(func, flow, mask)
    out = [
        momo.convex_upsampling8_rows(flow.rows(a - 1, a + m.shape[2] + 1, j), m)
        for j, (m, a) in enumerate(zip(mask.bands, flow.starts))
    ]
    return RowBands(out, [8 * a for a in flow.starts], 8 * flow.height, 2)


def _mean_std_rule(func, args, kwargs):
    """``models.momo._mean_std`` (which hands a band over): ``std_mean`` of
    the f32 frames over dimensions 1-3 from the bands' partial sums
    (:func:`_reduce`), into plain ``[b, 1, 1, 1]`` tensors."""
    (x,) = _bind(func, ("frames6",), (None,), args, kwargs)
    if not isinstance(x, RowBands) or x.axis != 2:
        raise _no_rule(f"{_name(func)} of a value without NCHW row bands")
    std, mean = torch.std_mean(x.float(), dim=(1, 2, 3), correction=1)
    return mean.view(-1, 1, 1, 1), (std + 1e-8).view(-1, 1, 1, 1)


def _backwarp_rule(func, args, kwargs):
    """``models.momo._backwarp`` (which hands bands over): the image gathered
    whole onto each band's device (the warp's source rule), each band of the
    flow sampling its own rows from its first row (``row0``): bit for bit
    the whole frame's rows."""
    img, flow, row0 = _bind(func, ("img", "flow", "row0"), (None, None, 0), args, kwargs)
    if not (isinstance(img, RowBands) and isinstance(flow, RowBands)) or flow.axis != 2 or img.axis != 2 or row0:
        raise _no_rule(f"{_name(func)} of other than NCHW row bands of the image and the flow")
    if img.height != flow.height:
        raise _no_rule(f"{_name(func)} of {img!r} by the flow {flow!r} (one height)")
    return flow.like([func(img.rows(0, img.height, j), f, a) for j, (f, a) in enumerate(zip(flow.bands, flow.starts))])


def _as_frame_rule(func, args, kwargs):
    """``models.momo._as_frame``: noise drawn whole on the frame's first band
    device, cut into the frame's bands, each moved to its band's device."""
    noise, frame = _bind(func, ("noise", "frame"), (None, None), args, kwargs)
    if isinstance(noise, RowBands) or not isinstance(frame, RowBands) or noise.shape[frame.axis] != frame.height:
        raise _no_rule(f"{_name(func)} of {noise!r} into the bands of {frame!r}")
    return frame.like([noise.narrow(frame.axis, a, b.shape[frame.axis]).to(b.device) for b, a in zip(frame.bands, frame.starts)])


_BICUBIC_TAPS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def _bicubic_taps(height: int, out_h: int, antialias: bool, device: torch.device, dtype: torch.dtype):
    """The rows' taps of a bicubic resize of ``height`` rows to ``out_h`` as
    torch's kernel on ``device`` computes them (the weights of its own
    ``F.interpolate`` of a one-hot row per channel, in ``dtype``, its
    accumulation type): ``(first, last, weights)``, per output row its first
    and last input rows (on the host), and the weights in the form that
    :func:`_resize_bicubic_rule` reads: antialiased, the ``[out_h, height]``
    matrix; plain, the ``[T, out_h]`` weights of each row's first input row
    and the ``T - 1`` after it (0 past its last; T <= 4). Made once per
    resize and device."""
    key = (height, out_h, antialias, str(device), dtype)
    if key not in _BICUBIC_TAPS:
        with torch.inference_mode(False), torch.no_grad():
            # two columns: torch 2.13's antialiased CPU kernel misreads a map one column wide
            eye = torch.eye(height, dtype=dtype, device=device).view(1, height, height, 1).expand(-1, -1, -1, 2).contiguous()
            weights = F.interpolate(eye, size=(out_h, 2), mode="bicubic", align_corners=False, antialias=antialias)
            weights = weights[0, :, :, 0].t().contiguous()  # [out_h, height]
            nz = (weights != 0).cpu()
            first = nz.int().argmax(1)
            last = height - 1 - nz.flip(1).int().argmax(1)
            if not antialias:
                cols = first[:, None] + torch.arange(int((last - first).max()) + 1)[None]
                weights = torch.where(cols <= last[:, None], weights.cpu().gather(1, cols.clamp_max(height - 1)), 0.0)
                weights = weights.t().contiguous().to(device)
            _BICUBIC_TAPS[key] = (first, last, weights)
    return _BICUBIC_TAPS[key]


def _resize_bicubic_rule(func, args, kwargs):
    """``common.resize_bicubic`` (which hands a band over) of NCHW bands, to
    any size, antialiased (PIL's filter, a = -0.5, its support scaled by the
    factor, as torch's kernel) or plain (a = -0.75, edge taps clamped): each
    band's outputs from ``floor(start * out / in)`` (:func:`_resized_starts`),
    their rows as the sum of the taps of the global ratio with torch's own
    weights (:func:`_bicubic_taps`) over the input rows they read, from every
    band that holds them: one product by the band's block of the weights
    for the antialiased resizes (up to ~4x the factor taps a row; as one
    gather a tap they ran MoMo's split slower, ``PERF.md``), a sum over the
    (up to) 4 taps for the plain upscales, where a product would multiply
    each output by every input row of its band; then the columns by
    ``F.interpolate`` at the rows' own height (the identity on the rows), in
    the resize's accumulation type (f32; the plain resize of an f64 value in
    f64), rounded once to the input's dtype. The same sums as
    the whole tensor's, rows first."""
    x, out_hw, antialias = _bind(func, ("x", "out_hw", "antialias"), (None, None, False), args, kwargs)
    if not isinstance(x, RowBands) or x.axis != 2:
        raise _no_rule(f"{_name(func)} of a value without NCHW row bands")
    out_h, out_w = _pair(out_hw)
    acc = torch.float64 if x.dtype == torch.float64 and not antialias else torch.float32
    spans = _resized_starts(x, out_h)
    out = []
    for j, (o0, o1) in enumerate(spans):
        first, last, weights = _bicubic_taps(x.height, out_h, antialias, x.bands[j].device, acc)
        lo, hi = int(first[o0:o1].min()), int(last[o0:o1].max()) + 1
        rows = x.rows(lo, hi, j).to(acc)
        if antialias:
            y = torch.matmul(weights[o0:o1, lo:hi], rows)
        else:
            y = None
            for t in range(weights.shape[0]):
                idx = (first[o0:o1] + t).clamp(max=x.height - 1).to(rows.device) - lo
                part = rows.index_select(2, idx.clamp(max=hi - 1 - lo)) * weights[t, o0:o1].view(1, 1, -1, 1)
                y = part if y is None else y + part
        if out_w != x.shape[3]:
            y = F.interpolate(y, size=(o1 - o0, out_w), mode="bicubic", align_corners=False, antialias=antialias)
        out.append(y.to(dtype=x.dtype, memory_format=torch.channels_last))
    return RowBands(out, [o0 for o0, _ in spans], out_h, 2)


_RULES: Dict[Callable, Callable] = {}
for _f in (
    torch.add, torch.sub, torch.mul, torch.div, torch.rsub, torch.neg, torch.clamp, torch.sigmoid,
    torch.Tensor.add, torch.Tensor.sub, torch.Tensor.mul, torch.Tensor.div, torch.Tensor.neg, torch.Tensor.clamp,
    torch.Tensor.sigmoid, torch.Tensor.__radd__, torch.Tensor.__rsub__, torch.Tensor.__rmul__,
    torch.Tensor.__rtruediv__, torch.Tensor.float, torch.Tensor.contiguous, torch.Tensor.detach, F.leaky_relu,
    torch.prelu, torch.exp, torch.Tensor.exp, torch.abs, torch.Tensor.abs, torch.square, torch.Tensor.square,
    torch.sqrt, torch.Tensor.sqrt, torch.Tensor.eq, torch.Tensor.lt, torch.Tensor.le, torch.Tensor.gt, torch.Tensor.ge,
    F.relu, torch.relu, torch.Tensor.relu, torch.floor, torch.Tensor.floor, torch.tanh, torch.Tensor.tanh,
    torch.ones_like, torch.where, torch.pow, torch.log, F.gelu, F.silu,
):
    _RULES[_f] = _elementwise
for _f in (torch.sum, torch.Tensor.sum, torch.mean, torch.Tensor.mean, torch.var, torch.Tensor.var, torch.var_mean,
           torch.std_mean):
    _RULES[_f] = _reduce
for _f in (torch.amax, torch.Tensor.amax, torch.amin, torch.Tensor.amin):
    _RULES[_f] = _extreme
_RULES.update({
    torch.Tensor.to: _to,
    torch.cat: _cat,
    torch.stack: _stack,
    torch.index_select: _index_select,
    torch.Tensor.index_select: _index_select,
    torch.Tensor.__getitem__: _getitem,
    torch.Tensor.__setitem__: _setitem,
    torch.Tensor.permute: _permute,
    torch.permute: _permute,
    torch.Tensor.expand_as: _expand_as,
    torch.conv2d: _conv,
    torch.conv3d: _conv,
    torch.conv_transpose2d: _conv_transpose,
    torch.conv_transpose3d: _conv_transpose,
    torch.pixel_shuffle: _pixel_shuffle,
    torch.pixel_unshuffle: _pixel_unshuffle,
    F.interpolate: _interpolate,
    F.pad: _pad,
    F.avg_pool2d: _avg_pool2d,
    torch.einsum: _einsum,
    torch.Tensor.repeat: _repeat,
    torch.Tensor.reshape: _reshape,
    torch.reshape: _reshape,
    torch.Tensor.view: _reshape,
    torch.Tensor.expand: _expand,
    F.batch_norm: _batch_norm,
    torch.softmax: _softmax,
    torch.Tensor.softmax: _softmax,
    torch.Tensor.unflatten: _unflatten,
    warp: _warp_rule,
    costvol.costvol_func: _costvol_rule,
    softsplat_func: _softsplat_rule,
    m2m._repeat_branches: _bandwise,
    common.conv2x2_up2x: _conv2x2_up2x_rule,
    ifunet.convex_upsample: _convex_upsample_rule,
    cain._reflect_pad1: _pad1_rule,
    momo._replicate_pad1: _pad1_rule,
    sepconv_func: _sepconv_rule,
    BidirCorr: _bidir_corr_rule,
    stmfnet._upsampler_8tap: _upsampler_8tap_rule,
    adacof_func: _adacof_rule,
    correlation.correlation_func: _correlation_rule,
    gmfss._transformer: _transformer_rule,
    gmfss._global_corr_softmax: _global_corr_rule,
    gmfss._local_corr_softmax: _local_corr_rule,
    gmfss._flow_attn: _flow_attn_rule,
    gmfss._convex_upsample4: _convex_upsample4_rule,
    torch.linalg.vector_norm: _vector_norm,
    torch.flip: _flip,
    torch.Tensor.flip: _flip,
    F.max_pool2d: _max_pool2d,
    eisai._corr_pyramid: _corr_pyramid_rule,
    eisai._corr_lookup: _corr_lookup_rule,
    eisai._convex_upsample_flow: _convex_upsample_flow_rule,
    edt.batch_edt: _batch_edt_rule,
    F.layer_norm: _layer_norm,
    F.linear: _linear,
    atm._windowed: _windowed_rule,
    momo._group_norm_silu: _group_norm_silu_rule,
    momo._convex_upsampling8: _convex_upsampling8_rule,
    momo._mean_std: _mean_std_rule,
    momo._backwarp: _backwarp_rule,
    momo._as_frame: _as_frame_rule,
    common.resize_bicubic: _resize_bicubic_rule,
})
