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
//     _warp_kernel_rows_mxu (l.297, via warp_pallas_rows_v3), which FILM's
//     and M2M's wide feature warps (C = 32 .. 960) take.
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
// The wide body is for channel-stride-1 features whose pixels span 32 bytes
// or more, or a whole number of 16-byte vectors. A group of G lanes serves
// one pixel: each lane computes the pixel's coordinates and weights (the same
// values, from the same flow load), then the lanes stride over the channels with 16-byte vector loads, 8
// bf16/f16 or 4 f32, so a group reads each tap as whole contiguous lines. G
// is the power of two that covers C / 8 (bf16) or C / 4 (f32), at most 32: 8
// lanes at C = 64 bf16 (one 128 B line per tap), a full warp that loops 3.75
// times at C = 960. Channels past the last whole vector, and every channel of
// a pixel whose tap or output addresses are not 16-byte aligned (a channel
// slice, or a C whose pixels do not start on 16 bytes), take a scalar path
// whose lanes still stride over the channels.
//
// Which kernel a call takes is decided in Python
// (ops/cuda/warp_kernel.py:route), from C, the dtype and the channel stride.
// All offsets are 64-bit: a batch-8 1080p RIFE call already holds 2.3e8
// elements, and wide feature warps pass 2^31.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

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
                               int64_t w, Strides si, Strides sf, Strides so) {
  // grid (ceil(w / kTileW), ceil(h / kTileH), n), block (kTileW, kTileH)
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
    const Taps t = bilinear_taps<ZEROS>(x, y, fx, fy, h, w, kRowKey, 1);
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

// 16 bytes of T as floats, and back.
template <typename T>
struct Vec16 {
  static constexpr int kN = 16 / sizeof(T);
  alignas(16) T v[kN];
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, Vec16<T>& r) {
  *reinterpret_cast<uint4*>(r.v) = __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename TI, typename TF, bool ZEROS>
__global__ void warp_bilinear_wide_kernel(const TI* __restrict__ img,
                                          const TF* __restrict__ flow,
                                          TI* __restrict__ out, int64_t c,
                                          int64_t h, int64_t w, int log2_group,
                                          Strides si, Strides sf, Strides so) {
  // grid (ceil(w / (blockDim.x >> log2_group)), h, n); channel stride is 1
  const int lane = threadIdx.x & ((1 << log2_group) - 1);
  const int group = 1 << log2_group;
  const int64_t x =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> log2_group) +
      (threadIdx.x >> log2_group);
  if (x >= w) return;
  const int64_t y = blockIdx.y;
  const int64_t b = blockIdx.z;

  const TF* fp = flow + b * sf.n + y * sf.h + x * sf.w;
  const Taps t = bilinear_taps<ZEROS>(x, y, load_f32(fp), load_f32(fp + sf.c),
                                      h, w, si.h, si.w);
  const TI* base = img + b * si.n;
  const TI* t00 = base + t.o00;
  const TI* t01 = base + t.o01;
  const TI* t10 = base + t.o10;
  const TI* t11 = base + t.o11;
  TI* o = out + b * so.n + y * so.h + x * so.w;

  constexpr int kVec = Vec16<TI>::kN;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(t00) | reinterpret_cast<uintptr_t>(t01) |
        reinterpret_cast<uintptr_t>(t10) | reinterpret_cast<uintptr_t>(t11) |
        reinterpret_cast<uintptr_t>(o)) &
       15) == 0;
  const int64_t c_vec = aligned ? (c / kVec) * kVec : 0;

  for (int64_t ch = static_cast<int64_t>(lane) * kVec; ch < c_vec;
       ch += static_cast<int64_t>(group) * kVec) {
    Vec16<TI> a, bq, cq, d, r;
    load_vec(t00 + ch, a);
    load_vec(t01 + ch, bq);
    load_vec(t10 + ch, cq);
    load_vec(t11 + ch, d);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      store_f32(&r.v[i], blend(load_f32(&a.v[i]), load_f32(&bq.v[i]),
                               load_f32(&cq.v[i]), load_f32(&d.v[i]), t));
    }
    *reinterpret_cast<uint4*>(o + ch) = *reinterpret_cast<const uint4*>(r.v);
  }
  // scalar path: the tail past the last whole vector, or every channel of a
  // pixel whose addresses are not 16-byte aligned
  for (int64_t ch = c_vec + lane; ch < c; ch += group) {
    store_f32(o + ch, blend(load_f32(t00 + ch), load_f32(t01 + ch),
                            load_f32(t10 + ch), load_f32(t11 + ch), t));
  }
}

struct Launch {
  int64_t n, c, h, w;
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
          ip, fp, op, l.c, l.h, l.w, l.si, l.sf, l.so);
    } else if (l.c == 7) {
      warp_bilinear_tiled_kernel<TI, TF, ZEROS, 7><<<blocks, threads, 0, l.stream>>>(
          ip, fp, op, l.c, l.h, l.w, l.si, l.sf, l.so);
    } else {
      warp_bilinear_tiled_kernel<TI, TF, ZEROS, 0><<<blocks, threads, 0, l.stream>>>(
          ip, fp, op, l.c, l.h, l.w, l.si, l.sf, l.so);
    }
    return;
  }
  // the group covers C in 16-byte vectors, rounded up to a power of two <= 32
  constexpr int kThreads = 256;
  const int64_t vectors = (l.c + Vec16<TI>::kN - 1) / Vec16<TI>::kN;
  int log2_group = 0;
  while (log2_group < 5 && (int64_t{1} << log2_group) < vectors) ++log2_group;
  const int64_t pixels_per_block = kThreads >> log2_group;
  const dim3 blocks(
      static_cast<unsigned int>((l.w + pixels_per_block - 1) / pixels_per_block),
      static_cast<unsigned int>(l.h), static_cast<unsigned int>(l.n));
  warp_bilinear_wide_kernel<TI, TF, ZEROS><<<blocks, kThreads, 0, l.stream>>>(
      ip, fp, op, l.c, l.h, l.w, log2_group, l.si, l.sf, l.so);
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

Launch make_launch(int64_t n, int64_t c, int64_t h, int64_t w, int64_t si_n,
                   int64_t si_c, int64_t si_h, int64_t si_w, int64_t sf_n,
                   int64_t sf_c, int64_t sf_h, int64_t sf_w, int64_t so_n,
                   int64_t so_c, int64_t so_h, int64_t so_w, void* stream) {
  return Launch{n, c, h, w,
                Strides{si_n, si_c, si_h, si_w},
                Strides{sf_n, sf_c, sf_h, sf_w},
                Strides{so_n, so_c, so_h, so_w},
                static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Warp `img` ([n, c, h, w] by element strides) by `flow` ([n, 2, h, w], channel
// 0 = x, 1 = y) into `out` ([n, c, h, w]) with K1's tiled body. Any strides
// are exact; the 16-byte row stores need channel stride 1 and pixel stride
// c. Dtype codes: 0 f32, 1 bf16, 2 f16. Returns the launch's
// cudaGetLastError() (0 on success), -1 for an unknown dtype code, or -2 when
// n or h exceeds the grid's 65535 limit. Launches on `stream` and does not
// synchronise.
extern "C" int cfi_warp_bilinear(
    const void* img, const void* flow, void* out, int img_dtype,
    int flow_dtype, int zeros, int64_t n, int64_t c, int64_t h, int64_t w,
    int64_t si_n, int64_t si_c, int64_t si_h, int64_t si_w, int64_t sf_n,
    int64_t sf_c, int64_t sf_h, int64_t sf_w, int64_t so_n, int64_t so_c,
    int64_t so_h, int64_t so_w, void* stream) {
  return launch(img, flow, out, img_dtype, flow_dtype, zeros != 0, kTiled,
                make_launch(n, c, h, w, si_n, si_c, si_h, si_w, sf_n, sf_c,
                            sf_h, sf_w, so_n, so_c, so_h, so_w, stream));
}

// The same warp by the wide kernel. `img` and `out` must have channel stride
// 1 (channels_last); their batch, row and pixel strides are free. Same return
// codes as cfi_warp_bilinear.
extern "C" int cfi_warp_bilinear_wide(
    const void* img, const void* flow, void* out, int img_dtype,
    int flow_dtype, int zeros, int64_t n, int64_t c, int64_t h, int64_t w,
    int64_t si_n, int64_t si_h, int64_t si_w, int64_t sf_n, int64_t sf_c,
    int64_t sf_h, int64_t sf_w, int64_t so_n, int64_t so_h, int64_t so_w,
    void* stream) {
  return launch(img, flow, out, img_dtype, flow_dtype, zeros != 0, kWide,
                make_launch(n, c, h, w, si_n, 1, si_h, si_w, sf_n, sf_c, sf_h,
                            sf_w, so_n, 1, so_h, so_w, stream));
}
