// Backward bilinear warp for Hopper (sm_90a), hand-written CUDA C++: two
// kernels over one shared coordinate/weight function.
//
// warp_bilinear_kernel (K1) replaces the JAX package's Pallas kernels of the
// bulk/patch warp:
//   comfyui_frame_interpolation_tpu/ops/pallas/warp_kernel.py
//     _warp_kernel_diag_roll (bulk pass, l.78, via warp_pallas_planes_v2)
//     _patch_kernel / _patch_tile (exact patch pass, l.647/687, via _run_patch)
// warp_bilinear_wide_kernel replaces the rows/MXU kernel of the same file,
//     _warp_kernel_rows_mxu (l.297, via warp_pallas_rows_v3), which FILM's
//     wide feature warps (C = 64 .. 960) take.
// The TPU has no fast gather, so those kernels tile the frame into (8, 128)
// blocks, DMA a source window per block, patch the blocks whose flow left the
// window, and for wide features fold channels into the batch and sum the taps
// as one-hot matmuls. Hopper gathers directly from L1/L2, so none of that is
// carried over: both kernels here are direct gathers, exact for any flow.
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
// that both kernels call, so the two cannot drift apart. Every multiply and
// add uses the _rn intrinsics, so nvcc cannot contract them into FMAs and the
// result rounds exactly as the plain twin's does. Every tap index is clamped
// into the frame before the read: no flow value can make a kernel read out of
// bounds.
//
// What bounds them on H100: memory. Per output pixel a kernel reads 2 flow
// values and 4 taps of C channels and writes C values; for locally smooth flow
// the taps of neighbouring pixels overlap, so most tap reads hit L1/L2 and
// device traffic approaches flow + one image read + the output.
//
// K1 runs one thread per output pixel and loops over C with scalar loads,
// through 64-bit element strides, so NCHW and channels_last tensors both work
// without a copy. That suits narrow images (RIFE's 3-7 channels).
//
// The wide kernel is for channels_last features with many channels. In K1 the
// lanes of a warp serve neighbouring pixels, so at C = 960 bf16 their scalar
// loads lie 1,920 B apart and each load instruction touches 32 sectors. Here a
// group of G lanes serves one pixel instead: each lane computes the pixel's
// coordinates and weights (the same values, from the same flow load), then
// the lanes stride over the channels with 16-byte vector loads, 8 bf16/f16 or
// 4 f32, so a group reads each tap as whole contiguous lines. G is the power
// of two that covers C / 8 (bf16) or C / 4 (f32), at most 32: 8 lanes at
// C = 64 bf16 (one 128 B line per tap), a full warp that loops 3.75 times at
// C = 960. Channels past the last whole vector, and every channel of a pixel
// whose tap or output addresses are not 16-byte aligned (a channel slice, or
// a C whose pixels do not start on 16 bytes), take a scalar path whose lanes
// still stride over the channels. The arithmetic per channel is K1's. No
// shared-memory staging or TMA yet: that is later work.
//
// All offsets are 64-bit: a batch-8 1080p RIFE call already holds 2.3e8
// elements, and wide feature warps pass 2^31.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

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
// place both kernels take them from.
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

// One channel's bilinear sum, in the twin's order.
__device__ __forceinline__ float blend(float p00, float p01, float p10,
                                       float p11, const Taps& t) {
  float acc = __fmul_rn(p00, t.w00);
  acc = __fadd_rn(acc, __fmul_rn(p01, t.w01));
  acc = __fadd_rn(acc, __fmul_rn(p10, t.w10));
  return __fadd_rn(acc, __fmul_rn(p11, t.w11));
}

template <typename TI, typename TF, bool ZEROS>
__global__ void warp_bilinear_kernel(const TI* __restrict__ img,
                                     const TF* __restrict__ flow,
                                     TI* __restrict__ out, int64_t c,
                                     int64_t h, int64_t w,
                                     Strides si, Strides sf, Strides so) {
  // grid (ceil(w / blockDim.x), h, n): no 64-bit division per thread
  const int64_t x =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (x >= w) return;
  const int64_t y = blockIdx.y;
  const int64_t b = blockIdx.z;

  const TF* fp = flow + b * sf.n + y * sf.h + x * sf.w;
  const Taps t = bilinear_taps<ZEROS>(x, y, load_f32(fp), load_f32(fp + sf.c),
                                      h, w, si.h, si.w);
  const TI* base = img + b * si.n;
  TI* o = out + b * so.n + y * so.h + x * so.w;

  for (int64_t ch = 0; ch < c; ++ch) {
    const int64_t off = ch * si.c;
    store_f32(o + ch * so.c,
              blend(load_f32(base + t.o00 + off), load_f32(base + t.o01 + off),
                    load_f32(base + t.o10 + off), load_f32(base + t.o11 + off),
                    t));
  }
}

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

template <typename TI, typename TF>
void launch_typed(const void* img, const void* flow, void* out, bool zeros,
                  bool wide, const Launch& l) {
  const TI* ip = static_cast<const TI*>(img);
  const TF* fp = static_cast<const TF*>(flow);
  TI* op = static_cast<TI*>(out);
  if (!wide) {
    constexpr int kThreads = 128;
    const dim3 blocks(
        static_cast<unsigned int>((l.w + kThreads - 1) / kThreads),
        static_cast<unsigned int>(l.h), static_cast<unsigned int>(l.n));
    if (zeros) {
      warp_bilinear_kernel<TI, TF, true><<<blocks, kThreads, 0, l.stream>>>(
          ip, fp, op, l.c, l.h, l.w, l.si, l.sf, l.so);
    } else {
      warp_bilinear_kernel<TI, TF, false><<<blocks, kThreads, 0, l.stream>>>(
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
  if (zeros) {
    warp_bilinear_wide_kernel<TI, TF, true><<<blocks, kThreads, 0, l.stream>>>(
        ip, fp, op, l.c, l.h, l.w, log2_group, l.si, l.sf, l.so);
  } else {
    warp_bilinear_wide_kernel<TI, TF, false><<<blocks, kThreads, 0, l.stream>>>(
        ip, fp, op, l.c, l.h, l.w, log2_group, l.si, l.sf, l.so);
  }
}

template <typename TI>
int launch_flow(const void* img, const void* flow, void* out, int flow_dtype,
                bool zeros, bool wide, const Launch& l) {
  switch (flow_dtype) {
    case kF32:
      launch_typed<TI, float>(img, flow, out, zeros, wide, l);
      return 0;
    case kBF16:
      launch_typed<TI, __nv_bfloat16>(img, flow, out, zeros, wide, l);
      return 0;
    case kF16:
      launch_typed<TI, __half>(img, flow, out, zeros, wide, l);
      return 0;
  }
  return -1;
}

int launch(const void* img, const void* flow, void* out, int img_dtype,
           int flow_dtype, bool zeros, bool wide, const Launch& l) {
  if (l.n * l.h * l.w == 0) return 0;
  if (l.n > 65535 || l.h > 65535) return -2;  // grid y/z limits
  int rc;
  switch (img_dtype) {
    case kF32:
      rc = launch_flow<float>(img, flow, out, flow_dtype, zeros, wide, l);
      break;
    case kBF16:
      rc = launch_flow<__nv_bfloat16>(img, flow, out, flow_dtype, zeros, wide,
                                      l);
      break;
    case kF16:
      rc = launch_flow<__half>(img, flow, out, flow_dtype, zeros, wide, l);
      break;
    default:
      rc = -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Warp `img` ([n, c, h, w] by element strides) by `flow` ([n, 2, h, w], channel
// 0 = x, 1 = y) into `out` ([n, c, h, w]). Dtype codes: 0 f32, 1 bf16, 2 f16.
// Returns the launch's cudaGetLastError() (0 on success), -1 for an unknown
// dtype code, or -2 when n or h exceeds the grid's 65535 limit. Launches on
// `stream` and does not synchronise.
extern "C" int cfi_warp_bilinear(
    const void* img, const void* flow, void* out, int img_dtype,
    int flow_dtype, int zeros, int64_t n, int64_t c, int64_t h, int64_t w,
    int64_t si_n, int64_t si_c, int64_t si_h, int64_t si_w, int64_t sf_n,
    int64_t sf_c, int64_t sf_h, int64_t sf_w, int64_t so_n, int64_t so_c,
    int64_t so_h, int64_t so_w, void* stream) {
  const Launch l{n, c, h, w,
                 Strides{si_n, si_c, si_h, si_w},
                 Strides{sf_n, sf_c, sf_h, sf_w},
                 Strides{so_n, so_c, so_h, so_w},
                 static_cast<cudaStream_t>(stream)};
  return launch(img, flow, out, img_dtype, flow_dtype, zeros != 0, false, l);
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
  const Launch l{n, c, h, w,
                 Strides{si_n, 1, si_h, si_w},
                 Strides{sf_n, sf_c, sf_h, sf_w},
                 Strides{so_n, 1, so_h, so_w},
                 static_cast<cudaStream_t>(stream)};
  return launch(img, flow, out, img_dtype, flow_dtype, zeros != 0, true, l);
}
