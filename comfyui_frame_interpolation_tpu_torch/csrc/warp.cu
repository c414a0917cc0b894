// Backward bilinear warp for Hopper (sm_90a), hand-written CUDA C++: two
// kernels over one shared coordinate/weight function.
//
// K1, the narrow-channel warp, replaces the JAX package's Pallas kernels of
// the bulk/patch warp:
//   comfyui_frame_interpolation_tpu/ops/pallas/warp_kernel.py
//     _warp_kernel_diag_roll (bulk pass, l.78, via warp_pallas_planes_v2)
//     _patch_kernel / _patch_tile (exact patch pass, l.647/687, via _run_patch)
// Its body is warp_bilinear_tiled_kernel, for any strides.
// warp_bilinear_wide_kernel replaces the rows/MXU kernel of the same file,
//     _warp_kernel_rows_mxu (l.297, via warp_pallas_rows_v3), which the
//     feature warps take (C = 16 .. 960: FILM, M2M, GMFSS, STMFNet, RIFE
//     4.0's Contextnet, IFRNet, IFUnet, AMT).
// The TPU has no fast gather, so those kernels tile the frame into (8, 128)
// blocks, DMA a source window per block, patch the blocks whose flow left the
// window, and for wide features fold channels into the batch and sum the taps
// as one-hot matmuls. Hopper gathers directly from L1/L2, so the patch pass,
// the folding and the matmuls are not carried over: every kernel here is
// exact for any flow.
//
// What they compute (the plain twin is ops/warp.py:bilinear_sample):
//   sx = float(x) + flow_x, sy = float(y) + flow_y                  (f32)
//   border: sx, sy clamped to [0, w-1] x [0, h-1] before floor (NaN stays NaN)
//   zeros:  a non-finite coordinate goes off the frame; coordinates are clamped
//           to +-2w / +-2h (both taps stay off the frame) so that the float to
//           int conversion is defined; taps outside the frame weigh 0
//   out = p00*w00 + p01*w01 + p10*w10 + p11*w11, summed in f32 in that order
//   (y0x0, y0x1, y1x0, y1x1) and cast once to the image dtype.
// The coordinates, indices and weights come from one function, bilinear_taps,
// that every kernel calls, so they cannot drift apart. Every multiply and
// add uses the _rn intrinsics, so nvcc cannot contract them into FMAs and the
// result rounds exactly as the plain twin's does. Every tap index is clamped
// into the frame before the read: no flow value can make a kernel read out of
// bounds.
//
// What bounds them on H100: memory. Per output pixel a kernel reads 2 flow
// values and 4 taps of C channels and writes C values; for locally smooth flow
// the taps of neighbouring pixels overlap, so device traffic approaches flow +
// one image read + the output. At RIFE's batch-8 1080p warp ([16, 1088, 1920,
// 7] bf16, f32 flow) that is 1.20 GB, 0.359 ms at 3.35 TB/s.
//
// K1 is built for that bound. A thread per pixel that reads its taps a
// channel at a time in a runtime loop (K1's first design) issues, at C = 7
// bf16 (14-byte pixels), 28 dependent two-byte loads and 7 two-byte stores,
// each warp-wide access touching about 14 sectors for 64 useful bytes. The
// tiled body:
//   1. a block owns a tile of kTileH x kTileW output pixels, a warp per tile
//      row and a thread per pixel, and takes each pixel's taps from
//      bilinear_taps (with a row stride of 2^32 and a pixel stride of 1, so
//      one offset carries a tap's row and column);
//   2. the pixel's flow is one 8-byte load (4 bytes for bf16/f16 flow);
//   3. for the widths of the main paths (C = 3, 7: RIFE, FILM's and M2M's
//      image warps) the channel loop is unrolled, so every tap load of a
//      pixel is in flight at once; other widths keep a loop;
//   4. pixels of more than 8 bytes are written to the warp's row of a shared
//      output tile with 32-bit stores, and the warp then stores the row as
//      16-byte vectors (scalar stores for the unaligned head and tail of a
//      row); pixels of 8 bytes or less are stored straight from registers,
//      which measured faster on the H100.
// The taps are read through L1, not staged: copying a tile's source box
// into shared memory first measured slower on the H100 (the block-wide box
// reduction and its barriers cost more than the L1 hits they replace), and
// so did 8- and 16-row tiles. Other layouts (NCHW planes, permuted views,
// channel slices) take the same body with scalar stores: on NCHW planes it
// measured 1.6x faster than the loop per pixel (PERF.md).
//
// The wide body is for channel-stride-1 features. It is bound by memory too,
// but its pixels are 32 to 1920 bytes, so what decides its speed is how each
// tap's run of channels is read: as few loads as the alignment allows, every
// lane busy, and one flow load and one coordinate computation per pixel, not
// per lane. Pixels of 40 to 108 bytes (bf16 C = 20, 36, 44, 54: IFRNet's and
// AMT's features) mostly do not start on 16 bytes, so 16-byte loads alone
// cannot serve them, and a power-of-two lane group per pixel would leave
// lanes idle. The body:
//   1. picks its vector width V on the host: the largest of 16, 8 and 4
//      bytes, or else one element, that divides the pixel's bytes, every
//      image and output stride and both base addresses, so every tap and
//      output pixel starts on V bytes and no pixel takes a narrower path
//      (bf16 C = 20, 36, 44 read 8-byte vectors, C = 54 4-byte ones, C = 24,
//      32, 64 ... 960 16-byte ones; a channel slice with an odd start reads
//      elements, exactly);
//   2. gives a block a flat run of pixels (of all n * h * w, so the narrow
//      rows of deep levels fill blocks too) of up to 2048 (pixel, vector)
//      pairs, fewer where the grid would otherwise have under 2 blocks an
//      SM (the deep levels' launches take a few microseconds, and their
//      latency, not the bytes, sets their time): a thread per pixel loads
//      its flow once (8 bytes), computes its taps and weights with
//      bilinear_taps and stages them in shared memory;
//   3. then lets the block's lanes cover the run's (pixel, vector) pairs in
//      order, pair q being vector q % P of pixel q / P (P = C * size / V,
//      stepped without a division): no lane idles but at the run's end,
//      each warp stores one contiguous stretch of the output, and reads each
//      tap as contiguous V-byte runs through L1;
//   4. gives each thread 2 (16-byte) or 4 (narrower) pairs at a time with
//      all their tap loads issued before the first sum (4 and 8 measured
//      slower: more registers, fewer blocks resident).
// The sums are blend's, in the twin's order: bit for bit the twin's result.
// On the H100 it reaches 84-90 % of the bytes bound on FILM's levels and
// 58-71 % on IFRNet's and AMT's C = 20-36 features (PERF.md); 4-byte
// vectors (bf16 C = 54) stay below half of it.
//
// A row band (the space axis of parallel/, which splits a frame's rows over
// devices): K1 and the backward kernel take the flow's and the output's
// height h apart from the source's hs, and the source row row0 of the
// band's first row. Output row y samples source row coordinate
// row0 + y + flow_y; the border clamp and the zeros test use hs. The grid
// tiles the band's output; only bilinear_taps' row changes. With row0 = 0
// and hs = h every sum is the whole-frame kernel's. The wide kernel takes
// the same band: its flat run of pixels counts the band's n * h * w output
// pixels, each stages the taps of source row row0 + y, and the output
// offset keeps the band's y.
//
// Which kernel a call takes is decided in Python
// (ops/cuda/warp_kernel.py:route), from C, the dtype and the channel stride.
// All offsets are 64-bit: a batch-8 1080p RIFE call already holds 2.3e8
// elements, and wide feature warps pass 2^31.
//
// warp_bilinear_backward_kernel is the warp's gradient, for training (its
// note heads its section below).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "scatter.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };
enum Body { kTiled = 0, kWide = 1 };

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f32(const __half* p) {
  return __half2float(*p);
}

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_f32(__half* p, float v) {
  *p = __float2half_rn(v);
}

struct Strides {
  int64_t n, c, h, w;
};

__device__ __forceinline__ int64_t clamp_index(float v, int64_t hi) {
  // v is finite and within +-2*extent here; NaN (border mode only) reads row 0
  int64_t i = isnan(v) ? 0 : static_cast<int64_t>(v);
  return i < 0 ? 0 : (i > hi ? hi : i);
}

// The four taps of one output pixel: element offsets of the tap pixels
// (y * stride_h + x * stride_w of the image) and their weights.
struct Taps {
  int64_t o00, o01, o10, o11;
  float w00, w01, w10, w11;
};

// Coordinates, border/zeros handling, the +-2w/+-2h clamp, the tap indices
// and the four weights of output pixel (x, y) under flow (fx, fy): the one
// place every kernel takes them from.
template <bool ZEROS>
__device__ __forceinline__ Taps bilinear_taps(int64_t x, int64_t y, float fx,
                                              float fy, int64_t h, int64_t w,
                                              int64_t stride_h,
                                              int64_t stride_w) {
  float sx = __fadd_rn(static_cast<float>(x), fx);
  float sy = __fadd_rn(static_cast<float>(y), fy);
  const float wm1 = static_cast<float>(w - 1);
  const float hm1 = static_cast<float>(h - 1);

  if (ZEROS) {
    const float fw = static_cast<float>(w);
    const float fh = static_cast<float>(h);
    if (!(isfinite(sx) && isfinite(sy))) {
      sx = -4.0f * fw;
      sy = -4.0f * fh;
    }
    sx = fminf(fmaxf(sx, -2.0f * fw), 2.0f * fw);
    sy = fminf(fmaxf(sy, -2.0f * fh), 2.0f * fh);
  } else {
    // comparisons keep NaN as NaN, as torch.clamp does (fminf would drop it)
    sx = sx < 0.0f ? 0.0f : (sx > wm1 ? wm1 : sx);
    sy = sy < 0.0f ? 0.0f : (sy > hm1 ? hm1 : sy);
  }

  const float x0 = floorf(sx);
  const float y0 = floorf(sy);
  const float wx = __fsub_rn(sx, x0);
  const float wy = __fsub_rn(sy, y0);
  const float ux = __fsub_rn(1.0f, wx);
  const float uy = __fsub_rn(1.0f, wy);
  Taps t;
  t.w00 = __fmul_rn(ux, uy);
  t.w01 = __fmul_rn(wx, uy);
  t.w10 = __fmul_rn(ux, wy);
  t.w11 = __fmul_rn(wx, wy);

  const float x1 = __fadd_rn(x0, 1.0f);
  const float y1 = __fadd_rn(y0, 1.0f);
  if (ZEROS) {
    const bool vx0 = x0 >= 0.0f && x0 <= wm1;
    const bool vx1 = x1 >= 0.0f && x1 <= wm1;
    const bool vy0 = y0 >= 0.0f && y0 <= hm1;
    const bool vy1 = y1 >= 0.0f && y1 <= hm1;
    t.w00 = (vy0 && vx0) ? t.w00 : 0.0f;
    t.w01 = (vy0 && vx1) ? t.w01 : 0.0f;
    t.w10 = (vy1 && vx0) ? t.w10 : 0.0f;
    t.w11 = (vy1 && vx1) ? t.w11 : 0.0f;
  }

  const int64_t ix0 = clamp_index(x0, w - 1) * stride_w;
  const int64_t ix1 = clamp_index(x1, w - 1) * stride_w;
  const int64_t iy0 = clamp_index(y0, h - 1) * stride_h;
  const int64_t iy1 = clamp_index(y1, h - 1) * stride_h;
  t.o00 = iy0 + ix0;
  t.o01 = iy0 + ix1;
  t.o10 = iy1 + ix0;
  t.o11 = iy1 + ix1;
  return t;
}

// A pixel's flow (x, y): one 8-byte (f32) or 4-byte (bf16, f16) load where
// the two channels are adjacent and aligned, else two loads.
template <typename TF>
__device__ __forceinline__ void load_flow(const TF* fp, int64_t stride_c,
                                          float& fx, float& fy) {
  if (stride_c == 1 &&
      (reinterpret_cast<uintptr_t>(fp) & (2 * sizeof(TF) - 1)) == 0) {
    if constexpr (sizeof(TF) == 4) {
      const float2 f = __ldg(reinterpret_cast<const float2*>(fp));
      fx = f.x;
      fy = f.y;
    } else {
      const unsigned int bits = __ldg(reinterpret_cast<const unsigned int*>(fp));
      TF pair[2];
      memcpy(pair, &bits, sizeof(bits));
      fx = load_f32(&pair[0]);
      fy = load_f32(&pair[1]);
    }
  } else {
    fx = load_f32(fp);
    fy = load_f32(fp + stride_c);
  }
}

// One channel's bilinear sum, in the twin's order.
__device__ __forceinline__ float blend(float p00, float p01, float p10,
                                       float p11, const Taps& t) {
  float acc = __fmul_rn(p00, t.w00);
  acc = __fadd_rn(acc, __fmul_rn(p01, t.w01));
  acc = __fadd_rn(acc, __fmul_rn(p10, t.w10));
  return __fadd_rn(acc, __fmul_rn(p11, t.w11));
}

// ---- K1: the tiled kernel -----------------------------------------------------

constexpr int kTileW = 32;  // one warp per tile row
constexpr int kTileH = 4;
constexpr int kTileThreads = kTileW * kTileH;
// pixels of at most this many bytes are stored straight to global memory,
// wider ones through the shared output tile
constexpr int kOutStageMinBytes = 8;
// an output tile row of pixels up to 32 bytes, plus room to start the row on
// the same offset mod 16 as its global address
constexpr int kOutRowBytes = kTileW * 32 + 16;
// bilinear_taps with this row stride and a pixel stride of 1 packs a tap's
// (row, column) into one offset: row << 32 | column
constexpr int64_t kRowKey = int64_t{1} << 32;

__device__ __forceinline__ int key_col(int64_t o) {
  return static_cast<int>(o & 0xffffffff);
}
__device__ __forceinline__ int key_row(int64_t o) {
  return static_cast<int>(o >> 32);
}

// Element k of a, or 0 where k is out of range (k is a compile-time value
// once the callers' loops are unrolled).
template <int N>
__device__ __forceinline__ uint32_t word_at(const uint32_t (&a)[N], int k) {
  return k >= 0 && k < N ? a[k < 0 ? 0 : (k >= N ? N - 1 : k)] : 0u;
}

// The bits store_f32 writes for v.
template <typename T>
__device__ __forceinline__ uint32_t bits_of(float v) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(v);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  } else {
    return __half_as_ushort(__float2half_rn(v));
  }
}

// Write the c channels v of one pixel to shared memory at dst (aligned to the
// element size) with 32-bit stores, and 16-bit ones at an unaligned head or
// tail.
template <typename T, int N>
__device__ __forceinline__ void write_pixel(unsigned char* dst,
                                            const float (&v)[N], int c) {
  uint32_t b[N];
#pragma unroll
  for (int i = 0; i < N; ++i) b[i] = bits_of<T>(v[i]);
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < c) reinterpret_cast<uint32_t*>(dst)[i] = b[i];
    }
  } else {
    // word j of the 4-byte aligned run holds channels 2j - odd and 2j + 1 - odd
    const int odd = (reinterpret_cast<uintptr_t>(dst) & 2) ? 1 : 0;
    unsigned char* base = dst - 2 * odd;
#pragma unroll
    for (int j = 0; j <= N / 2; ++j) {
      const int lo = 2 * j - odd;
      const uint32_t lv = odd ? word_at(b, 2 * j - 1) : word_at(b, 2 * j);
      const uint32_t hv = odd ? word_at(b, 2 * j) : word_at(b, 2 * j + 1);
      const bool lo_in = lo >= 0 && lo < c;
      const bool hi_in = lo + 1 < c;
      if (lo_in && hi_in) {
        *reinterpret_cast<uint32_t*>(base + 4 * j) = lv | (hv << 16);
      } else if (lo_in) {
        *reinterpret_cast<unsigned short*>(base + 4 * j) = static_cast<unsigned short>(lv);
      } else if (hi_in && lo < 0) {
        *reinterpret_cast<unsigned short*>(base + 4 * j + 2) = static_cast<unsigned short>(hv);
      }
    }
  }
}

// One output pixel of exactly KC channels, its taps read a channel at a time
// from element addresses p00 .. p11 (channel stride cs), every load issued
// before the first sum. Writes to the shared output tile at dst, or to
// global memory at o (channel stride so_c) when dst is null.
template <typename TI, int KC>
__device__ __forceinline__ void warp_pixel_unrolled(
    const TI* p00, const TI* p01, const TI* p10, const TI* p11, int64_t cs,
    const Taps& t, unsigned char* dst, TI* o, int64_t so_c) {
  float a[KC], bq[KC], cq[KC], d[KC], v[KC];
#pragma unroll
  for (int i = 0; i < KC; ++i) {
    a[i] = load_f32(p00 + i * cs);
    bq[i] = load_f32(p01 + i * cs);
    cq[i] = load_f32(p10 + i * cs);
    d[i] = load_f32(p11 + i * cs);
  }
#pragma unroll
  for (int i = 0; i < KC; ++i) v[i] = blend(a[i], bq[i], cq[i], d[i], t);
  if (dst != nullptr) {
    write_pixel<TI>(dst, v, KC);
  } else {
#pragma unroll
    for (int i = 0; i < KC; ++i) store_f32(o + i * so_c, v[i]);
  }
}

// KC > 0: the body for exactly KC channels; KC = 0: any C.
template <typename TI, typename TF, bool ZEROS, int KC>
__global__ void __launch_bounds__(kTileThreads)
    warp_bilinear_tiled_kernel(const TI* __restrict__ img,
                               const TF* __restrict__ flow,
                               TI* __restrict__ out, int64_t c, int64_t h,
                               int64_t w, int64_t hs, int64_t row0,
                               Strides si, Strides sf, Strides so) {
  // grid (ceil(w / kTileW), ceil(h / kTileH), n) over the output band of h
  // rows, block (kTileW, kTileH); the source has hs rows, the band's first
  // is its row row0
  __shared__ alignas(16) unsigned char otile[kTileH * kOutRowBytes];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int64_t tile_x = static_cast<int64_t>(blockIdx.x) * kTileW;
  const int64_t x = tile_x + tx;
  const int64_t y = static_cast<int64_t>(blockIdx.y) * kTileH + ty;
  const int64_t b = blockIdx.z;
  if (KC > 0) c = KC;
  constexpr int64_t isz = sizeof(TI);
  const int64_t p_bytes = c * isz;
  // output pixels are contiguous runs of p_bytes: rows go out as 16-byte
  // vectors through the shared tile
  const bool dense_out =
      so.c == 1 && so.w == c && p_bytes > kOutStageMinBytes && p_bytes <= 32;

  // 1. the taps, and the bilinear sums into this warp's row of the shared
  // output tile where it takes them
  TI* o = out + b * so.n + y * so.h + x * so.w;
  const uintptr_t orow_start = reinterpret_cast<uintptr_t>(
      out + b * so.n + y * so.h + tile_x * so.w);
  unsigned char* dst =
      dense_out ? otile + ty * kOutRowBytes + (orow_start & 15) + tx * p_bytes
                : nullptr;
  if (x < w && y < h) {
    float fx, fy;
    load_flow(flow + b * sf.n + y * sf.h + x * sf.w, sf.c, fx, fy);
    const Taps t = bilinear_taps<ZEROS>(x, row0 + y, fx, fy, hs, w, kRowKey, 1);
    const TI* base = img + b * si.n;
    const TI* r0 = base + key_row(t.o00) * si.h;
    const TI* r1 = base + key_row(t.o10) * si.h;
    const TI* p00 = r0 + key_col(t.o00) * si.w;
    const TI* p01 = r0 + key_col(t.o01) * si.w;
    const TI* p10 = r1 + key_col(t.o00) * si.w;
    const TI* p11 = r1 + key_col(t.o01) * si.w;
    if constexpr (KC > 0) {
      warp_pixel_unrolled<TI, KC>(p00, p01, p10, p11, si.c, t, dst, o, so.c);
    } else {
      for (int64_t ch = 0; ch < c; ++ch) {
        const int64_t off = ch * si.c;
        const float v = blend(load_f32(p00 + off), load_f32(p01 + off),
                              load_f32(p10 + off), load_f32(p11 + off), t);
        store_f32(dense_out ? reinterpret_cast<TI*>(dst) + ch : o + ch * so.c, v);
      }
    }
  }

  // 2. each warp stores its own tile row: a scalar head up to the first
  // 16-byte boundary, 16-byte vectors, a scalar tail
  if (!dense_out) return;
  __syncwarp();
  if (y >= h) return;
  const int64_t npx = w - tile_x < kTileW ? w - tile_x : kTileW;
  const uintptr_t start = orow_start;
  const uintptr_t end = start + npx * p_bytes;
  // global address a sits at srow + (a - (start & ~15)) in the shared tile
  const unsigned char* srow = otile + ty * kOutRowBytes;
  const uintptr_t v0 = ((start + 15) & ~uintptr_t{15}) < end
                           ? ((start + 15) & ~uintptr_t{15})
                           : end;
  const uintptr_t v1 = (end & ~uintptr_t{15}) > v0 ? (end & ~uintptr_t{15}) : v0;
  for (uintptr_t a = v0 + 16 * tx; a < v1; a += 16 * kTileW) {
    *reinterpret_cast<uint4*>(a) =
        *reinterpret_cast<const uint4*>(srow + (a - (start & ~uintptr_t{15})));
  }
  for (uintptr_t a = start + isz * tx; a < v0; a += isz * kTileW) {
    *reinterpret_cast<TI*>(a) =
        *reinterpret_cast<const TI*>(srow + (a - (start & ~uintptr_t{15})));
  }
  for (uintptr_t a = v1 + isz * tx; a < end; a += isz * kTileW) {
    *reinterpret_cast<TI*>(a) =
        *reinterpret_cast<const TI*>(srow + (a - (start & ~uintptr_t{15})));
  }
}

// ---- the wide kernel ----------------------------------------------------------

constexpr int kWideThreads = 256;
// the most pixels a block stages taps for (the size of its shared tap table)
constexpr int kWidePixels = 256;
// the (pixel, vector) pairs a block covers: up to kWideVectorsPerBlock (8 a
// thread), fewer where that would leave fewer than kWideMinBlocks blocks (2
// on each of the H100's 132 SMs), but at least one a thread
constexpr int kWideVectorsPerBlock = 2048;
constexpr int64_t kWideMinBlocks = 264;

// V bytes of channels as one load or store
template <int V>
struct VecBits;
template <>
struct VecBits<16> {
  using T = uint4;
};
template <>
struct VecBits<8> {
  using T = uint2;
};
template <>
struct VecBits<4> {
  using T = unsigned int;
};
template <>
struct VecBits<2> {
  using T = unsigned short;
};

template <typename T, int V>
struct Vec {
  static constexpr int kN = V / static_cast<int>(sizeof(T));
  alignas(V) T v[kN];
};

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, Vec<T, V>& r) {
  using B = typename VecBits<V>::T;
  *reinterpret_cast<B*>(r.v) = __ldg(reinterpret_cast<const B*>(p));
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const Vec<T, V>& r) {
  using B = typename VecBits<V>::T;
  *reinterpret_cast<B*>(p) = *reinterpret_cast<const B*>(r.v);
}

// A staged pixel's four tap offsets from img, in elements
struct alignas(16) TapOffsets {
  int64_t o00, o01, o10, o11;
};

// a / d for non-negative a, d: a 32-bit division where both fit (every
// practical frame), a 64-bit one otherwise
__device__ __forceinline__ int64_t div_index(int64_t a, int64_t d) {
  return ((a | d) >> 32) == 0
             ? static_cast<int64_t>(static_cast<uint32_t>(a) / static_cast<uint32_t>(d))
             : a / d;
}

// V: the vector width in bytes, chosen by the host so that every tap and
// output pixel starts on V bytes; vecs: vectors per pixel (C * sizeof(TI) / V);
// block_pixels: pixels per block, at most kWidePixels.
template <typename TI, typename TF, bool ZEROS, int V>
__global__ void __launch_bounds__(kWideThreads)
    warp_bilinear_wide_kernel(const TI* __restrict__ img,
                              const TF* __restrict__ flow,
                              TI* __restrict__ out, int64_t npix, int64_t h,
                              int64_t w, int64_t hs, int64_t row0, int vecs,
                              int block_pixels, Strides si, Strides sf,
                              Strides so) {
  // grid (ceil(npix / block_pixels)); a block takes the flat run of pixels
  // [g0, g0 + block_pixels) of all n * h * w output pixels, row-major (the
  // band's h rows, which sample the source's hs rows from row row0 on)
  constexpr int kN = Vec<TI, V>::kN;
  constexpr int kUnroll = V >= 16 ? 2 : 4;
  __shared__ TapOffsets s_taps[kWidePixels];
  __shared__ float4 s_weights[kWidePixels];
  __shared__ int64_t s_out[kWidePixels];

  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * block_pixels;
  const int np = static_cast<int>(npix - g0 < block_pixels ? npix - g0 : block_pixels);

  // 1. a thread per pixel: one flow load, the taps and weights, staged
  for (int i = threadIdx.x; i < np; i += kWideThreads) {
    const int64_t g = g0 + i;
    const int64_t row = div_index(g, w);
    const int64_t x = g - row * w;
    const int64_t b = div_index(row, h);
    const int64_t y = row - b * h;
    float fx, fy;
    load_flow(flow + b * sf.n + y * sf.h + x * sf.w, sf.c, fx, fy);
    const Taps t = bilinear_taps<ZEROS>(x, row0 + y, fx, fy, hs, w, si.h, si.w);
    const int64_t ib = b * si.n;
    s_taps[i] = TapOffsets{ib + t.o00, ib + t.o01, ib + t.o10, ib + t.o11};
    s_weights[i] = make_float4(t.w00, t.w01, t.w10, t.w11);
    s_out[i] = b * so.n + y * so.h + x * so.w;
  }
  __syncthreads();

  // 2. the lanes cover the block's (pixel, vector) pairs in order, so a warp
  // stores one contiguous run of the output and reads each tap as contiguous
  // runs; kUnroll pairs a thread, all their loads issued before the first sum.
  // Pair q is pixel q / vecs, vector q % vecs, stepped without a division.
  const int total = np * vecs;
  const int step_p = kWideThreads / vecs;
  const int step_v = kWideThreads - step_p * vecs;
  int p = static_cast<int>(threadIdx.x) / vecs;
  int v = static_cast<int>(threadIdx.x) - p * vecs;
  for (int q = threadIdx.x; q < total; q += kUnroll * kWideThreads) {
    Vec<TI, V> a[kUnroll], bq[kUnroll], cq[kUnroll], d[kUnroll];
    int pu[kUnroll], vu[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      pu[u] = p;
      vu[u] = v;
      if (q + u * kWideThreads < total) {
        const TapOffsets o = s_taps[p];
        const int64_t ch = static_cast<int64_t>(v) * kN;
        load_vec(img + o.o00 + ch, a[u]);
        load_vec(img + o.o01 + ch, bq[u]);
        load_vec(img + o.o10 + ch, cq[u]);
        load_vec(img + o.o11 + ch, d[u]);
      }
      p += step_p;
      v += step_v;
      if (v >= vecs) {
        v -= vecs;
        ++p;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (q + u * kWideThreads < total) {
        const float4 wt = s_weights[pu[u]];
        const Taps t{0, 0, 0, 0, wt.x, wt.y, wt.z, wt.w};
        Vec<TI, V> r;
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          store_f32(&r.v[i], blend(load_f32(&a[u].v[i]), load_f32(&bq[u].v[i]),
                                   load_f32(&cq[u].v[i]), load_f32(&d[u].v[i]), t));
        }
        store_vec(out + s_out[pu[u]] + static_cast<int64_t>(vu[u]) * kN, r);
      }
    }
  }
}

// ---- the backward kernel ------------------------------------------------------
//
// warp_bilinear_backward_kernel is the warp's gradient, for training. It
// stands for XLA's VJP of the gather in the JAX package's ops/warp.py:61
// bilinear_sample, through which JAX trains; no Pallas kernel has a
// backward. Its plain version is ops/warp.py:warp_backward_torch
// (torch.autograd through the twin). Per output pixel, from the forward's
// taps and weights (bilinear_taps):
//   grad_img:  g_c * w_k added to each tap k, a forward splat of grad_out at
//              the sample coordinates (the clamped taps in border mode, only
//              the taps in the frame in zeros mode; a tap of weight 0 adds
//              nothing);
//   grad_flow: sum_c g_c * d out_c / d sx (and sy) over the four taps, in
//              f32, times the border clamp's derivative: 1 inside, 0.5 at an
//              exact bound (JAX's jnp.clip = min(max(x, lo), hi), whose
//              derivative splits a tie: clip_slope), 0 outside. In zeros
//              mode a non-finite coordinate gives zero gradients, as the
//              forward gives 0.
// What bounds it on H100: bytes, plus the image gradient's atomic
// read-modify-write. It reads grad_out, the image and the flow once and
// writes grad_flow once; the image gradient is summed by atomics in L2 into
// an f32 buffer that the wrapper zero-fills first and that, at training
// sizes, does not stay in the 50 MB L2, so each of its lines is read and
// written back. At [16, 1088, 1920, 7] f32 that is 0.94 + 0.94 + 0.27 GB
// read, 0.27 GB written and the 1.07 GB buffer read and written: ~4.5 GB,
// ~1.4 ms at 3.35 TB/s (the wrapper's zero fill writes the buffer once more,
// outside the kernel). A first design (a thread per pixel, a channel loop,
// a scalar atomic per tap and channel into NCHW planes copied into the
// image's layout afterwards) reached 26.6 % of the bytes bound there, behind
// aten.grid_sampler_2d_backward (PERF.md). What held it back, and what this
// body does about each:
//   1. scalar atomics, 936 M L2 atomic operations at that shape for smooth
//      flow. The image gradient is a splat, so K2's cure applies
//      (scatter.cuh): a block takes a tile of 32 x 8 output pixels, a thread
//      each; the taps that neighbouring pixels share are merged by rows
//      (shared memory) and columns (warp shuffles) before one atomic per tap
//      left, about 1.16 a pixel for smooth flow; and each tap left adds its
//      channels as float4 atomics into a channels-last buffer [N, H, W, Cp],
//      Cp = C rounded up to 4 (2 float4s a tap for C = 7, 1 for C = 3):
//      ~80 M vector atomics at that shape;
//   2. the buffer around the kernel: the NCHW buffer took a copy into the
//      image's layout after the kernel. The padded channels-last buffer is
//      the image's layout but for the padding, so the wrapper returns a view
//      of it for f32 images and casts it once for bf16/f16;
//   3. scalar loads: a thread holds its pixel's grad_out channels and its
//      four taps' in registers, 4 channels at a time (C = 7 is two groups,
//      each group's sums merged by the tile's one plan), read as 16- or
//      8-byte vectors where the host found the channels contiguous and
//      every pixel aligned (the vector widths are arguments, checked on the
//      host), else element by element.
// Registers decide the rest: groups of 8 channels took 128 registers a
// thread, two blocks an SM, and measured slower on the H100 than groups of 4
// held to 80 registers (three blocks); without the image's gradient the
// kernel is an instance of its own, held to 64 (PERF.md).

// the channels a thread of the backward holds at once: one float4 atomic a
// tap (8 measured slower on the H100 at C = 7: more registers, fewer
// blocks an SM)
constexpr int kBackwardGroup = 4;
// blocks of scatter::kThreads an SM the backward's registers leave room for:
// ptxas then keeps it to 80 registers a thread with the image's gradient
// and to 64 without (each measured faster than fewer blocks on the H100;
// 4 blocks with the image's gradient spill)
constexpr int kBackwardMinBlocks = 3;
constexpr int kBackwardMinBlocksFlowOnly = 4;

// The derivative of jnp.clip(v, 0, hi) = min(max(v, 0), hi) as JAX takes it:
// each of max and min gives 1 to the side that wins and 0.5 at a tie.
__device__ __forceinline__ float clip_slope(float v, float hi) {
  const float lo_side = v > 0.0f ? 1.0f : (v == 0.0f ? 0.5f : 0.0f);
  const float m = v > 0.0f ? v : 0.0f;
  const float hi_side = m < hi ? 1.0f : (m == hi ? 0.5f : 0.0f);
  return lo_side * hi_side;
}

// The derivatives of the four tap weights by sx and by sy at output pixel
// (x, y) under flow (fx, fy), with the border clamp's derivative folded in
// (zero for a tap outside the frame in zeros mode, and for every tap of a
// non-finite coordinate there): the backward's counterpart of
// bilinear_taps, in the same f32 arithmetic.
struct TapSlopes {
  float dx00, dx01, dx10, dx11, dy00, dy01, dy10, dy11;
};

template <bool ZEROS>
__device__ __forceinline__ TapSlopes bilinear_slopes(int64_t x, int64_t y,
                                                     float fx, float fy,
                                                     int64_t h, int64_t w) {
  float sx = __fadd_rn(static_cast<float>(x), fx);
  float sy = __fadd_rn(static_cast<float>(y), fy);
  const float wm1 = static_cast<float>(w - 1);
  const float hm1 = static_cast<float>(h - 1);
  float cx = 1.0f, cy = 1.0f;
  if (ZEROS) {
    if (!(isfinite(sx) && isfinite(sy))) return TapSlopes{0, 0, 0, 0, 0, 0, 0, 0};
    // the forward's +-2w / +-2h clamp moves no tap into the frame: its
    // derivative meets only taps of weight 0
    const float fw = static_cast<float>(w);
    const float fh = static_cast<float>(h);
    sx = fminf(fmaxf(sx, -2.0f * fw), 2.0f * fw);
    sy = fminf(fmaxf(sy, -2.0f * fh), 2.0f * fh);
  } else {
    cx = clip_slope(sx, wm1);
    cy = clip_slope(sy, hm1);
    sx = sx < 0.0f ? 0.0f : (sx > wm1 ? wm1 : sx);
    sy = sy < 0.0f ? 0.0f : (sy > hm1 ? hm1 : sy);
  }
  const float x0 = floorf(sx);
  const float y0 = floorf(sy);
  const float wx = __fsub_rn(sx, x0);
  const float wy = __fsub_rn(sy, y0);
  const float ux = __fsub_rn(1.0f, wx);
  const float uy = __fsub_rn(1.0f, wy);
  // w00 = ux uy, w01 = wx uy, w10 = ux wy, w11 = wx wy
  TapSlopes s{-uy * cx, uy * cx, -wy * cx, wy * cx,
              -ux * cy, -wx * cy, ux * cy, wx * cy};
  if (ZEROS) {
    const float x1 = __fadd_rn(x0, 1.0f);
    const float y1 = __fadd_rn(y0, 1.0f);
    const bool vx0 = x0 >= 0.0f && x0 <= wm1;
    const bool vx1 = x1 >= 0.0f && x1 <= wm1;
    const bool vy0 = y0 >= 0.0f && y0 <= hm1;
    const bool vy1 = y1 >= 0.0f && y1 <= hm1;
    if (!(vy0 && vx0)) s.dx00 = s.dy00 = 0.0f;
    if (!(vy0 && vx1)) s.dx01 = s.dy01 = 0.0f;
    if (!(vy1 && vx0)) s.dx10 = s.dy10 = 0.0f;
    if (!(vy1 && vx1)) s.dx11 = s.dy11 = 0.0f;
  }
  return s;
}

// Channels [0, n) of one pixel (at p, channel stride stride_c) as f32 into
// v, zeros past n: as `vec`-byte vectors where vec is 16 or 8 (the host
// checked that the channels are contiguous and every vector aligned; a
// vector wider than G elements is read as 8-byte ones), else element by
// element.
template <typename T, int G>
__device__ __forceinline__ void load_group(const T* p, int64_t stride_c, int n,
                                           int vec, float (&v)[G]) {
  constexpr int k16 = 16 / static_cast<int>(sizeof(T));
  constexpr int k8 = 8 / static_cast<int>(sizeof(T));
#pragma unroll
  for (int i = 0; i < G; ++i) v[i] = 0.0f;
  if constexpr (k16 <= G) {
    if (vec == 16) {
#pragma unroll
      for (int i = 0; i < G; i += k16) {
        if (i < n) {
          const uint4 bits = __ldg(reinterpret_cast<const uint4*>(p + i));
          T e[k16];
          memcpy(e, &bits, sizeof(bits));
#pragma unroll
          for (int j = 0; j < k16; ++j) v[i + j] = load_f32(&e[j]);
        }
      }
      return;
    }
  }
  if constexpr (k8 <= G) {
    if (vec >= 8) {  // a 16-byte fit is an 8-byte one
#pragma unroll
      for (int i = 0; i < G; i += k8) {
        if (i < n) {
          const uint2 bits = __ldg(reinterpret_cast<const uint2*>(p + i));
          T e[k8];
          memcpy(e, &bits, sizeof(bits));
#pragma unroll
          for (int j = 0; j < k8; ++j) v[i + j] = load_f32(&e[j]);
        }
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < G; ++i) {
    if (i < n) v[i] = load_f32(p + i * stride_c);
  }
}

// grid (ceil(w / kTileW), ceil(h / kTileH), n) of scatter's tiles over the
// output band of h rows (source rows row0 on, of hs), block (kTileW,
// kTileH), a thread per output pixel holding kBackwardGroup channels at a
// time. With IMG, grad_img is the zeroed f32 buffer [n, hs, w, cp] of the
// whole source (cp a multiple of 4, 16 bytes aligned); without, the image needs no
// gradient, grad_img is null and only grad_flow is computed (an instance of
// its own, whose registers leave room for more blocks).
template <typename TI, typename TF, bool ZEROS, bool IMG>
__global__ void __launch_bounds__(scatter::kThreads,
                                  IMG ? kBackwardMinBlocks : kBackwardMinBlocksFlowOnly)
    warp_bilinear_backward_kernel(const TI* __restrict__ img,
                                  const TF* __restrict__ flow,
                                  const TI* __restrict__ grad_out,
                                  float* __restrict__ grad_img,
                                  TF* __restrict__ grad_flow, int c, int cp,
                                  int64_t h, int64_t w, int64_t hs,
                                  int64_t row0, Strides si, Strides sf,
                                  Strides sg, Strides sgf, int vec_img,
                                  int vec_grad) {
  constexpr int G = kBackwardGroup;
  __shared__ scatter::MergeTile<G> tile;
  const int64_t x =
      static_cast<int64_t>(blockIdx.x) * scatter::kTileW + threadIdx.x;
  const int64_t y =
      static_cast<int64_t>(blockIdx.y) * scatter::kTileH + threadIdx.y;
  const int64_t b = blockIdx.z;
  const bool inside = x < w && y < h;

  // 1. the forward's taps and weights (a tap's row and column packed into
  // one offset, as K1 does) and their slopes by sx and sy
  Taps t{0, 0, 0, 0, 0.0f, 0.0f, 0.0f, 0.0f};
  TapSlopes s{0, 0, 0, 0, 0, 0, 0, 0};
  if (inside) {
    float fx, fy;
    load_flow(flow + b * sf.n + y * sf.h + x * sf.w, sf.c, fx, fy);
    t = bilinear_taps<ZEROS>(x, row0 + y, fx, fy, hs, w, kRowKey, 1);
    s = bilinear_slopes<ZEROS>(x, row0 + y, fx, fy, hs, w);
  }
  const int r0 = key_row(t.o00), r1 = key_row(t.o10);
  const int c0 = key_col(t.o00), c1 = key_col(t.o01);
  const TI* ib = img + b * si.n;
  // tap k's pixel in the image and in the gradient's buffer, computed where
  // it is read (fewer registers than four pointers each)
  auto tap = [&](int k) {
    return ib + ((k & 2) ? r1 : r0) * si.h + ((k & 1) ? c1 : c0) * si.w;
  };
  const TI* go = grad_out + b * sg.n + y * sg.h + x * sg.w;
  const float weight[4] = {t.w00, t.w01, t.w10, t.w11};
  // own: this pixel adds to the tap; live: the tap takes an atomic (after
  // the merges, which hand taps on and take them over)
  bool own[4], live[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) own[k] = live[k] = inside && weight[k] != 0.0f;
  auto q = [&](int k) {
    return grad_img + ((b * hs + ((k & 2) ? r1 : r0)) * w + ((k & 1) ? c1 : c0)) * cp;
  };

  float gx = 0.0f, gy = 0.0f;
  scatter::MergePlan plan{};
  for (int ch0 = 0; ch0 < c; ch0 += G) {
    // 2. the group's grad_out and tap channels, and the flow's gradient
    const int n = inside ? min(G, c - ch0) : 0;
    float g[G];
    float v[4][G];
    load_group(go + ch0 * sg.c, sg.c, n, vec_grad, g);
#pragma unroll
    for (int k = 0; k < 4; ++k) load_group(tap(k) + ch0 * si.c, si.c, n, vec_img, v[k]);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      gx += g[i] * (s.dx00 * v[0][i] + s.dx01 * v[1][i] + s.dx10 * v[2][i] + s.dx11 * v[3][i]);
      gy += g[i] * (s.dy00 * v[0][i] + s.dy01 * v[1][i] + s.dy10 * v[2][i] + s.dy11 * v[3][i]);
    }
    if (!IMG) continue;
    // 3. the taps' sums, merged with the neighbours' that are the same
    // pixels, then one float4 atomic for the group of each tap left
    float sum[4][G];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int i = 0; i < G; ++i) sum[k][i] = own[k] ? __fmul_rn(g[i], weight[k]) : 0.0f;
    }
    if (ch0 == 0) {
      plan = scatter::merge_corners(tile, c0, c1, r0, r1, inside, sum, live);
    } else {
      scatter::merge_more(tile, plan, sum);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (live[k]) scatter::add_sums(q(k) + ch0, G, 1, sum[k]);
    }
  }
  if (inside) {
    TF* gf = grad_flow + b * sgf.n + y * sgf.h + x * sgf.w;
    store_f32(gf, gx);
    store_f32(gf + sgf.c, gy);
  }
}

struct BackwardLaunch {
  int64_t n, c, h, w, hs, row0, cp;
  Strides si, sf, sg, sgf;
  int vec_img, vec_grad;
  cudaStream_t stream;
};

template <typename TI, typename TF, bool ZEROS>
void launch_backward_mode(const TI* ip, const TF* fp, const TI* gp,
                          float* grad_img, TF* gfp, const BackwardLaunch& l) {
  const dim3 blocks(
      static_cast<unsigned int>((l.w + scatter::kTileW - 1) / scatter::kTileW),
      static_cast<unsigned int>((l.h + scatter::kTileH - 1) / scatter::kTileH),
      static_cast<unsigned int>(l.n));
  const dim3 threads(scatter::kTileW, scatter::kTileH);
  const int c = static_cast<int>(l.c), cp = static_cast<int>(l.cp);
  if (grad_img != nullptr) {
    warp_bilinear_backward_kernel<TI, TF, ZEROS, true><<<blocks, threads, 0, l.stream>>>(
        ip, fp, gp, grad_img, gfp, c, cp, l.h, l.w, l.hs, l.row0, l.si, l.sf, l.sg, l.sgf, l.vec_img, l.vec_grad);
  } else {
    warp_bilinear_backward_kernel<TI, TF, ZEROS, false><<<blocks, threads, 0, l.stream>>>(
        ip, fp, gp, grad_img, gfp, c, cp, l.h, l.w, l.hs, l.row0, l.si, l.sf, l.sg, l.sgf, l.vec_img, l.vec_grad);
  }
}

template <typename TI, typename TF>
void launch_backward_typed(const void* img, const void* flow,
                           const void* grad_out, float* grad_img,
                           void* grad_flow, bool zeros,
                           const BackwardLaunch& l) {
  const TI* ip = static_cast<const TI*>(img);
  const TF* fp = static_cast<const TF*>(flow);
  const TI* gp = static_cast<const TI*>(grad_out);
  TF* gfp = static_cast<TF*>(grad_flow);
  if (zeros) {
    launch_backward_mode<TI, TF, true>(ip, fp, gp, grad_img, gfp, l);
  } else {
    launch_backward_mode<TI, TF, false>(ip, fp, gp, grad_img, gfp, l);
  }
}

template <typename TI>
int launch_backward_flow(const void* img, const void* flow,
                         const void* grad_out, float* grad_img,
                         void* grad_flow, int flow_dtype, bool zeros,
                         const BackwardLaunch& l) {
  switch (flow_dtype) {
    case kF32:
      launch_backward_typed<TI, float>(img, flow, grad_out, grad_img, grad_flow, zeros, l);
      return 0;
    case kBF16:
      launch_backward_typed<TI, __nv_bfloat16>(img, flow, grad_out, grad_img, grad_flow, zeros, l);
      return 0;
    case kF16:
      launch_backward_typed<TI, __half>(img, flow, grad_out, grad_img, grad_flow, zeros, l);
      return 0;
  }
  return -1;
}

// Whether the backward may read channels of a tensor of c channels by
// strides s at base in vectors of `vec` bytes: one element (isz bytes)
// always; 8 or 16 bytes where the channels are contiguous and vec divides
// the pixel's bytes, the batch, row and pixel strides' bytes and the address.
bool vector_fits(int64_t vec, int64_t isz, int64_t c, const Strides& s,
                 const void* base) {
  if (vec == isz) return true;
  if ((vec != 8 && vec != 16) || (c > 1 && s.c != 1)) return false;
  const uint64_t bits =
      static_cast<uint64_t>(c * isz) | static_cast<uint64_t>(s.n * isz) |
      static_cast<uint64_t>(s.h * isz) | static_cast<uint64_t>(s.w * isz) |
      reinterpret_cast<uintptr_t>(base);
  return bits % static_cast<uint64_t>(vec) == 0;
}

struct Launch {
  int64_t n, c, h, w, hs, row0;
  Strides si, sf, so;
  cudaStream_t stream;
};

template <typename TI, typename TF, bool ZEROS>
void launch_body(const TI* ip, const TF* fp, TI* op, Body body,
                 const Launch& l) {
  if (body == kTiled) {
    const dim3 blocks(
        static_cast<unsigned int>((l.w + kTileW - 1) / kTileW),
        static_cast<unsigned int>((l.h + kTileH - 1) / kTileH),
        static_cast<unsigned int>(l.n));
    const dim3 threads(kTileW, kTileH);
    if (l.c == 3) {
      warp_bilinear_tiled_kernel<TI, TF, ZEROS, 3><<<blocks, threads, 0, l.stream>>>(
          ip, fp, op, l.c, l.h, l.w, l.hs, l.row0, l.si, l.sf, l.so);
    } else if (l.c == 7) {
      warp_bilinear_tiled_kernel<TI, TF, ZEROS, 7><<<blocks, threads, 0, l.stream>>>(
          ip, fp, op, l.c, l.h, l.w, l.hs, l.row0, l.si, l.sf, l.so);
    } else {
      warp_bilinear_tiled_kernel<TI, TF, ZEROS, 0><<<blocks, threads, 0, l.stream>>>(
          ip, fp, op, l.c, l.h, l.w, l.hs, l.row0, l.si, l.sf, l.so);
    }
    return;
  }
  // the vector width: the largest of 16, 8 and 4 bytes (else one element)
  // that divides the pixel's bytes, every image and output stride and both
  // base addresses, so every tap and output pixel starts on it
  constexpr int64_t isz = sizeof(TI);
  const uint64_t bits =
      static_cast<uint64_t>(l.c * isz) | static_cast<uint64_t>(l.si.n * isz) |
      static_cast<uint64_t>(l.si.h * isz) | static_cast<uint64_t>(l.si.w * isz) |
      static_cast<uint64_t>(l.so.n * isz) | static_cast<uint64_t>(l.so.h * isz) |
      static_cast<uint64_t>(l.so.w * isz) | reinterpret_cast<uintptr_t>(ip) |
      reinterpret_cast<uintptr_t>(op);
  const int64_t vb = bits % 16 == 0 ? 16 : bits % 8 == 0 ? 8 : bits % 4 == 0 ? 4 : isz;
  const int64_t vecs = l.c * isz / vb;
  const int64_t npix = l.n * l.h * l.w;
  int64_t pairs = npix * vecs / kWideMinBlocks;
  pairs = pairs < kWideThreads ? kWideThreads : (pairs > kWideVectorsPerBlock ? kWideVectorsPerBlock : pairs);
  const int64_t per_block = pairs / vecs;
  const int block_pixels = static_cast<int>(
      per_block < 1 ? 1 : (per_block > kWidePixels ? kWidePixels : per_block));
  const dim3 blocks(static_cast<unsigned int>((npix + block_pixels - 1) / block_pixels));
  const int v = static_cast<int>(vecs);
  if (vb == 16) {
    warp_bilinear_wide_kernel<TI, TF, ZEROS, 16><<<blocks, kWideThreads, 0, l.stream>>>(
        ip, fp, op, npix, l.h, l.w, l.hs, l.row0, v, block_pixels, l.si, l.sf, l.so);
  } else if (vb == 8) {
    warp_bilinear_wide_kernel<TI, TF, ZEROS, 8><<<blocks, kWideThreads, 0, l.stream>>>(
        ip, fp, op, npix, l.h, l.w, l.hs, l.row0, v, block_pixels, l.si, l.sf, l.so);
  } else if (vb == 4) {
    warp_bilinear_wide_kernel<TI, TF, ZEROS, 4><<<blocks, kWideThreads, 0, l.stream>>>(
        ip, fp, op, npix, l.h, l.w, l.hs, l.row0, v, block_pixels, l.si, l.sf, l.so);
  } else if constexpr (sizeof(TI) == 2) {
    warp_bilinear_wide_kernel<TI, TF, ZEROS, 2><<<blocks, kWideThreads, 0, l.stream>>>(
        ip, fp, op, npix, l.h, l.w, l.hs, l.row0, v, block_pixels, l.si, l.sf, l.so);
  }
}

template <typename TI, typename TF>
void launch_typed(const void* img, const void* flow, void* out, bool zeros,
                  Body body, const Launch& l) {
  const TI* ip = static_cast<const TI*>(img);
  const TF* fp = static_cast<const TF*>(flow);
  TI* op = static_cast<TI*>(out);
  if (zeros) {
    launch_body<TI, TF, true>(ip, fp, op, body, l);
  } else {
    launch_body<TI, TF, false>(ip, fp, op, body, l);
  }
}

template <typename TI>
int launch_flow(const void* img, const void* flow, void* out, int flow_dtype,
                bool zeros, Body body, const Launch& l) {
  switch (flow_dtype) {
    case kF32:
      launch_typed<TI, float>(img, flow, out, zeros, body, l);
      return 0;
    case kBF16:
      launch_typed<TI, __nv_bfloat16>(img, flow, out, zeros, body, l);
      return 0;
    case kF16:
      launch_typed<TI, __half>(img, flow, out, zeros, body, l);
      return 0;
  }
  return -1;
}

int launch(const void* img, const void* flow, void* out, int img_dtype,
           int flow_dtype, bool zeros, Body body, const Launch& l) {
  if (l.n * l.h * l.w == 0) return 0;
  if (l.n > 65535 || l.h > 65535) return -2;  // grid y/z limits
  // the wide kernel counts pixels in a one-dimensional grid and (pixel,
  // vector) pairs in ints
  if (body == kWide && (l.n * l.h * l.w > 0x7fffffff || l.c > (int64_t{1} << 28))) return -2;
  int rc;
  switch (img_dtype) {
    case kF32:
      rc = launch_flow<float>(img, flow, out, flow_dtype, zeros, body, l);
      break;
    case kBF16:
      rc = launch_flow<__nv_bfloat16>(img, flow, out, flow_dtype, zeros, body,
                                      l);
      break;
    case kF16:
      rc = launch_flow<__half>(img, flow, out, flow_dtype, zeros, body, l);
      break;
    default:
      rc = -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

Launch make_launch(int64_t n, int64_t c, int64_t h, int64_t w, int64_t hs,
                   int64_t row0, int64_t si_n, int64_t si_c, int64_t si_h,
                   int64_t si_w, int64_t sf_n, int64_t sf_c, int64_t sf_h,
                   int64_t sf_w, int64_t so_n, int64_t so_c, int64_t so_h,
                   int64_t so_w, void* stream) {
  return Launch{n, c, h, w, hs, row0,
                Strides{si_n, si_c, si_h, si_w},
                Strides{sf_n, sf_c, sf_h, sf_w},
                Strides{so_n, so_c, so_h, so_w},
                static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Warp `img` ([n, c, hs, w] by element strides) by `flow` ([n, 2, h, w],
// channel 0 = x, 1 = y) into `out` ([n, c, h, w]) with K1's tiled body: the
// band of h output rows from source row row0 (the whole frame for row0 = 0,
// hs = h). Any strides are exact; the 16-byte row stores need channel
// stride 1 and pixel stride c. Dtype codes: 0 f32, 1 bf16, 2 f16. Returns
// the launch's cudaGetLastError() (0 on success), -1 for an unknown dtype
// code, or -2 when n, h or hs exceeds the grid's 65535 limit or the band
// does not lie within the source. Launches on `stream` and does not
// synchronise.
extern "C" int cfi_warp_bilinear(
    const void* img, const void* flow, void* out, int img_dtype,
    int flow_dtype, int zeros, int64_t n, int64_t c, int64_t h, int64_t w,
    int64_t hs, int64_t row0, int64_t si_n, int64_t si_c, int64_t si_h,
    int64_t si_w, int64_t sf_n, int64_t sf_c, int64_t sf_h, int64_t sf_w,
    int64_t so_n, int64_t so_c, int64_t so_h, int64_t so_w, void* stream) {
  if (hs > 65535 || row0 < 0 || row0 + h > hs) return -2;
  return launch(img, flow, out, img_dtype, flow_dtype, zeros != 0, kTiled,
                make_launch(n, c, h, w, hs, row0, si_n, si_c, si_h, si_w,
                            sf_n, sf_c, sf_h, sf_w, so_n, so_c, so_h, so_w,
                            stream));
}

// The same warp by the wide kernel, with the same row band (h output rows
// from source row row0 of the image's hs). `img` and `out` must have channel
// stride 1 (channels_last); their batch, row and pixel strides are free. Same
// return codes as cfi_warp_bilinear, and -2 also when n * h * w exceeds
// 2^31 - 1 or c exceeds 2^28.
extern "C" int cfi_warp_bilinear_wide(
    const void* img, const void* flow, void* out, int img_dtype,
    int flow_dtype, int zeros, int64_t n, int64_t c, int64_t h, int64_t w,
    int64_t hs, int64_t row0, int64_t si_n, int64_t si_h, int64_t si_w,
    int64_t sf_n, int64_t sf_c, int64_t sf_h, int64_t sf_w, int64_t so_n,
    int64_t so_h, int64_t so_w, void* stream) {
  if (row0 < 0 || row0 + h > hs) return -2;
  return launch(img, flow, out, img_dtype, flow_dtype, zeros != 0, kWide,
                make_launch(n, c, h, w, hs, row0, si_n, 1, si_h, si_w, sf_n,
                            sf_c, sf_h, sf_w, so_n, 1, so_h, so_w, stream));
}

// The warp's gradient: given `grad_out` (the forward output's gradient,
// [n, c, h, w] in the image's dtype) for the warp of `img` ([n, c, hs, w])
// by `flow` ([n, 2, h, w]: the band of h rows from source row row0, the
// whole frame for row0 = 0, hs = h), adds the image's gradient into
// `grad_img` (f32, [n, hs, w, cp] contiguous, cp >= c a multiple of 4, 16
// bytes aligned, zeroed by the caller; null when the image needs none) and
// writes the flow's into `grad_flow` ([n, 2, h, w], the flow's dtype). img, flow, grad_out and grad_flow take their own
// element strides, in the order n, c, h, w. img and grad_out are read in
// vectors of vec_img and vec_grad bytes: 16, 8, or one element (see
// vector_fits). Same dtype codes and return codes as cfi_warp_bilinear; -2
// also for a c over 2^28, a w over 2^31 - 1, a grad_img or vector width
// that does not fit.
extern "C" int cfi_warp_bilinear_backward(
    const void* img, const void* flow, const void* grad_out, void* grad_img,
    void* grad_flow, int img_dtype, int flow_dtype, int zeros, int64_t n,
    int64_t c, int64_t h, int64_t w, int64_t hs, int64_t row0, int64_t si_n,
    int64_t si_c, int64_t si_h, int64_t si_w, int64_t sf_n, int64_t sf_c,
    int64_t sf_h, int64_t sf_w, int64_t sg_n, int64_t sg_c, int64_t sg_h,
    int64_t sg_w, int64_t sgf_n, int64_t sgf_c, int64_t sgf_h, int64_t sgf_w,
    int64_t cp, int64_t vec_img, int64_t vec_grad, void* stream) {
  if (n * h * w == 0) return 0;
  if (n > 65535 || h > 65535 || hs > 65535) return -2;  // grid y/z limits
  if (row0 < 0 || row0 + h > hs) return -2;  // the band lies within the source
  // K1's packed tap offsets hold a row and a column in 32 bits each
  if (w > 0x7fffffff || c > (int64_t{1} << 28)) return -2;
  if (grad_img != nullptr &&
      (cp < c || cp % 4 != 0 || (reinterpret_cast<uintptr_t>(grad_img) & 15) != 0)) {
    return -2;
  }
  const BackwardLaunch l{n, c, h, w, hs, row0, cp,
                         Strides{si_n, si_c, si_h, si_w},
                         Strides{sf_n, sf_c, sf_h, sf_w},
                         Strides{sg_n, sg_c, sg_h, sg_w},
                         Strides{sgf_n, sgf_c, sgf_h, sgf_w},
                         static_cast<int>(vec_img), static_cast<int>(vec_grad),
                         static_cast<cudaStream_t>(stream)};
  const int64_t isz = img_dtype == kF32 ? 4 : 2;
  if (!vector_fits(vec_img, isz, c, l.si, img) ||
      !vector_fits(vec_grad, isz, c, l.sg, grad_out)) {
    return -2;
  }
  float* gi = static_cast<float*>(grad_img);
  const bool zm = zeros != 0;
  int rc;
  switch (img_dtype) {
    case kF32:
      rc = launch_backward_flow<float>(img, flow, grad_out, gi, grad_flow, flow_dtype, zm, l);
      break;
    case kBF16:
      rc = launch_backward_flow<__nv_bfloat16>(img, flow, grad_out, gi, grad_flow, flow_dtype, zm, l);
      break;
    case kF16:
      rc = launch_backward_flow<__half>(img, flow, grad_out, gi, grad_flow, flow_dtype, zm, l);
      break;
    default:
      rc = -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
