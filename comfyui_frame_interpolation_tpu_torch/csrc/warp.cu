// Backward bilinear warp for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the JAX package's two Pallas TPU kernels of the warp family:
//   comfyui_frame_interpolation_tpu/ops/pallas/warp_kernel.py
//     _warp_kernel_diag_roll (bulk pass, l.78, via warp_pallas_planes_v2)
//     _patch_kernel / _patch_tile (exact patch pass, l.647/687, via _run_patch)
// The TPU has no fast gather, so those kernels tile the frame into (8, 128)
// blocks, DMA a source window per block and patch the blocks whose flow left
// the window. Hopper gathers directly from L1/L2, so none of that is carried
// over: one thread computes one output pixel for every channel, exact for any
// flow.
//
// What it computes (the plain twin is ops/warp.py:bilinear_sample):
//   sx = float(x) + flow_x, sy = float(y) + flow_y                  (f32)
//   border: sx, sy clamped to [0, w-1] x [0, h-1] before floor (NaN stays NaN)
//   zeros:  a non-finite coordinate goes off the frame; coordinates are clamped
//           to +-2w / +-2h (both taps stay off the frame) so that the float to
//           int conversion is defined; taps outside the frame weigh 0
//   out = p00*w00 + p01*w01 + p10*w10 + p11*w11, summed in f32 in that order
//   (y0x0, y0x1, y1x0, y1x1) and cast once to the image dtype.
// Every multiply and add uses the _rn intrinsics, so nvcc cannot contract
// them into FMAs and the result rounds exactly as the plain twin's does.
// Every tap index is clamped into the frame before the read: no flow value
// can make the kernel read out of bounds.
//
// What bounds it on H100: memory. Per output pixel it reads 2 flow values and
// 4 taps of C channels and writes C values; at bf16 C=7 (RIFE's 3 image + 4
// feature channels) that is about 8 + 4*14 + 14 bytes, and for locally smooth
// flow the 4 taps of neighbouring threads overlap, so most tap reads hit L1/L2
// and device traffic approaches flow + one image read + the output. The design
// does nothing more about it yet: a thread per pixel, a loop over C, 64-bit
// element strides so NCHW and channels_last tensors both work without a copy.
// Staging source tiles in shared memory (cp.async or TMA) is later work.
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
  float sx = __fadd_rn(static_cast<float>(x), load_f32(fp));
  float sy = __fadd_rn(static_cast<float>(y), load_f32(fp + sf.c));
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
  float w00 = __fmul_rn(ux, uy);
  float w01 = __fmul_rn(wx, uy);
  float w10 = __fmul_rn(ux, wy);
  float w11 = __fmul_rn(wx, wy);

  const float x1 = __fadd_rn(x0, 1.0f);
  const float y1 = __fadd_rn(y0, 1.0f);
  if (ZEROS) {
    const bool vx0 = x0 >= 0.0f && x0 <= wm1;
    const bool vx1 = x1 >= 0.0f && x1 <= wm1;
    const bool vy0 = y0 >= 0.0f && y0 <= hm1;
    const bool vy1 = y1 >= 0.0f && y1 <= hm1;
    w00 = (vy0 && vx0) ? w00 : 0.0f;
    w01 = (vy0 && vx1) ? w01 : 0.0f;
    w10 = (vy1 && vx0) ? w10 : 0.0f;
    w11 = (vy1 && vx1) ? w11 : 0.0f;
  }

  const int64_t ix0 = clamp_index(x0, w - 1);
  const int64_t ix1 = clamp_index(x1, w - 1);
  const int64_t iy0 = clamp_index(y0, h - 1);
  const int64_t iy1 = clamp_index(y1, h - 1);

  const TI* base = img + b * si.n;
  const TI* t00 = base + iy0 * si.h + ix0 * si.w;
  const TI* t01 = base + iy0 * si.h + ix1 * si.w;
  const TI* t10 = base + iy1 * si.h + ix0 * si.w;
  const TI* t11 = base + iy1 * si.h + ix1 * si.w;
  TI* o = out + b * so.n + y * so.h + x * so.w;

  for (int64_t ch = 0; ch < c; ++ch) {
    const int64_t off = ch * si.c;
    float acc = __fmul_rn(load_f32(t00 + off), w00);
    acc = __fadd_rn(acc, __fmul_rn(load_f32(t01 + off), w01));
    acc = __fadd_rn(acc, __fmul_rn(load_f32(t10 + off), w10));
    acc = __fadd_rn(acc, __fmul_rn(load_f32(t11 + off), w11));
    store_f32(o + ch * so.c, acc);
  }
}

template <typename TI, typename TF>
void launch_typed(const void* img, const void* flow, void* out, bool zeros,
                  int64_t n, int64_t c, int64_t h, int64_t w, Strides si,
                  Strides sf, Strides so, cudaStream_t stream) {
  constexpr int kThreads = 128;
  const dim3 blocks(static_cast<unsigned int>((w + kThreads - 1) / kThreads),
                    static_cast<unsigned int>(h), static_cast<unsigned int>(n));
  const TI* ip = static_cast<const TI*>(img);
  const TF* fp = static_cast<const TF*>(flow);
  TI* op = static_cast<TI*>(out);
  if (zeros) {
    warp_bilinear_kernel<TI, TF, true><<<blocks, kThreads, 0, stream>>>(
        ip, fp, op, c, h, w, si, sf, so);
  } else {
    warp_bilinear_kernel<TI, TF, false><<<blocks, kThreads, 0, stream>>>(
        ip, fp, op, c, h, w, si, sf, so);
  }
}

template <typename TI>
int launch_flow(const void* img, const void* flow, void* out, int flow_dtype,
                bool zeros, int64_t n, int64_t c, int64_t h, int64_t w,
                Strides si, Strides sf, Strides so, cudaStream_t stream) {
  switch (flow_dtype) {
    case kF32:
      launch_typed<TI, float>(img, flow, out, zeros, n, c, h, w, si, sf, so,
                              stream);
      return 0;
    case kBF16:
      launch_typed<TI, __nv_bfloat16>(img, flow, out, zeros, n, c, h, w, si,
                                      sf, so, stream);
      return 0;
    case kF16:
      launch_typed<TI, __half>(img, flow, out, zeros, n, c, h, w, si, sf, so,
                               stream);
      return 0;
  }
  return -1;
}

}  // namespace

// Warp `img` ([n, c, h, w] by element strides) by `flow` ([n, 2, h, w], channel
// 0 = x, 1 = y) into `out` ([n, c, h, w]). Dtype codes: 0 f32, 1 bf16, 2 f16.
// Returns the launch's cudaGetLastError() (0 on success), -1 for an unknown
// dtype code, or -2 when n or h exceeds the grid's 65535 limit. Launches on `stream` and does not synchronise.
extern "C" int cfi_warp_bilinear(
    const void* img, const void* flow, void* out, int img_dtype,
    int flow_dtype, int zeros, int64_t n, int64_t c, int64_t h, int64_t w,
    int64_t si_n, int64_t si_c, int64_t si_h, int64_t si_w, int64_t sf_n,
    int64_t sf_c, int64_t sf_h, int64_t sf_w, int64_t so_n, int64_t so_c,
    int64_t so_h, int64_t so_w, void* stream) {
  if (n * h * w == 0) return 0;
  if (n > 65535 || h > 65535) return -2;  // grid y/z limits
  const Strides si{si_n, si_c, si_h, si_w};
  const Strides sf{sf_n, sf_c, sf_h, sf_w};
  const Strides so{so_n, so_c, so_h, so_w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (img_dtype) {
    case kF32:
      rc = launch_flow<float>(img, flow, out, flow_dtype, zeros != 0, n, c, h,
                              w, si, sf, so, s);
      break;
    case kBF16:
      rc = launch_flow<__nv_bfloat16>(img, flow, out, flow_dtype, zeros != 0,
                                      n, c, h, w, si, sf, so, s);
      break;
    case kF16:
      rc = launch_flow<__half>(img, flow, out, flow_dtype, zeros != 0, n, c,
                               h, w, si, sf, so, s);
      break;
    default:
      rc = -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
