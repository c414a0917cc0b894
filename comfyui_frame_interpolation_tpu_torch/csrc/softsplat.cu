// Forward bilinear splat for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the JAX package's two Pallas TPU kernels of the splat family:
//   comfyui_frame_interpolation_tpu/ops/pallas/softsplat_kernel.py
//     _splat_kernel_stacked (banded splat, l.365, via softsplat_pallas_stacked
//       l.565 and softsplat_pallas_banded l.654)
//     _splat_kernel (single-band splat, l.53, via softsplat_pallas_planes
//       l.221 and softsplat_pallas l.276)
// The TPU has no fast scatter, so those kernels turn the splat into one-hot
// matmuls on the MXU: they tile the frame, DMA a target window per tile, split
// the sources into displacement bands, fold wide C into the batch, and leave
// the sources outside every band to an XLA scatter residual. Hopper has fast
// fp32 atomics in L2, so none of that is carried over: one thread takes one
// source pixel and adds its value into the four target corners with
// atomicAdd, exact for any displacement.
//
// What it computes (the plain twin is ops/softsplat.py:softsplat_torch):
//   fx = float(x) + flow_x, fy = float(y) + flow_y                    (f32)
//   a non-finite fx or fy drops the source; fx, fy are clamped to +-2w / +-2h
//   (a clamped axis keeps both corners off the frame) so that the float to
//   int conversion is defined;
//   x0 = floor(fx), wx1 = fx - x0, wx0 = 1 - wx1 (and the same for y);
//   corners y0x0, y0x1, y1x0, y1x1 with weights wx*wy; a corner off the frame
//   is dropped; out[corner][c] += value[c] * weight, in f32.
// Every multiply and subtraction uses the _rn intrinsics, so nvcc cannot
// contract them into FMAs and each product rounds exactly as the twin's does.
// The sums are fp32 atomics, whose order changes from run to run: the result
// matches the twin to rounding, not bit for bit.
//
// What bounds it on H100: L2 atomic throughput. At M2M's 1080p batch-2 shape
// ([16, 4, 1088, 1920]) one call issues 33.4 M sources x 4 corners x 4
// channels = 535 M fp32 atomics, against about 0.8 GB of reads (values and
// flow) and 0.53 GB of f32 output. Neighbouring sources land on neighbouring
// targets for smooth flow, so a warp's atomics mostly hit the same L2 lines;
// rough flows pile many sources onto a few targets and serialise on them.
// The design does nothing more about it yet: a thread per source pixel, a
// loop over C, 64-bit element strides so NCHW, channels_last and NHWC views
// all work without a copy. Warp-aggregated or shared-memory pre-reduction of
// the atomics is later work.
//
// The output buffer is f32 and zeroed by the caller; the kernel only adds.

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

struct Strides {
  int64_t n, c, h, w;
};

template <typename TI>
__device__ __forceinline__ void splat_corner(const TI* src, float* dst,
                                             int64_t c, int64_t si_c,
                                             int64_t so_c, float weight) {
  for (int64_t ch = 0; ch < c; ++ch) {
    atomicAdd(dst + ch * so_c, __fmul_rn(load_f32(src + ch * si_c), weight));
  }
}

template <typename TI, typename TF>
__global__ void softsplat_kernel(const TI* __restrict__ in,
                                 const TF* __restrict__ flow,
                                 float* __restrict__ out, int64_t c,
                                 int64_t h, int64_t w, Strides si, Strides sf,
                                 Strides so) {
  // grid (ceil(w / blockDim.x), h, n): no 64-bit division per thread
  const int64_t x =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (x >= w) return;
  const int64_t y = blockIdx.y;
  const int64_t b = blockIdx.z;

  const TF* fp = flow + b * sf.n + y * sf.h + x * sf.w;
  float fx = __fadd_rn(static_cast<float>(x), load_f32(fp));
  float fy = __fadd_rn(static_cast<float>(y), load_f32(fp + sf.c));
  if (!(isfinite(fx) && isfinite(fy))) return;
  const float fw = static_cast<float>(w);
  const float fh = static_cast<float>(h);
  fx = fminf(fmaxf(fx, -2.0f * fw), 2.0f * fw);
  fy = fminf(fmaxf(fy, -2.0f * fh), 2.0f * fh);

  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const float wx1 = __fsub_rn(fx, x0);
  const float wy1 = __fsub_rn(fy, y0);
  const float wx0 = __fsub_rn(1.0f, wx1);
  const float wy0 = __fsub_rn(1.0f, wy1);

  const int64_t ix0 = static_cast<int64_t>(x0);
  const int64_t iy0 = static_cast<int64_t>(y0);
  const int64_t ix1 = ix0 + 1;
  const int64_t iy1 = iy0 + 1;
  const bool vx0 = ix0 >= 0 && ix0 < w;
  const bool vx1 = ix1 >= 0 && ix1 < w;
  const bool vy0 = iy0 >= 0 && iy0 < h;
  const bool vy1 = iy1 >= 0 && iy1 < h;

  const TI* src = in + b * si.n + y * si.h + x * si.w;
  float* ob = out + b * so.n;
  if (vy0 && vx0)
    splat_corner(src, ob + iy0 * so.h + ix0 * so.w, c, si.c, so.c,
                 __fmul_rn(wx0, wy0));
  if (vy0 && vx1)
    splat_corner(src, ob + iy0 * so.h + ix1 * so.w, c, si.c, so.c,
                 __fmul_rn(wx1, wy0));
  if (vy1 && vx0)
    splat_corner(src, ob + iy1 * so.h + ix0 * so.w, c, si.c, so.c,
                 __fmul_rn(wx0, wy1));
  if (vy1 && vx1)
    splat_corner(src, ob + iy1 * so.h + ix1 * so.w, c, si.c, so.c,
                 __fmul_rn(wx1, wy1));
}

template <typename TI, typename TF>
void launch_typed(const void* in, const void* flow, float* out, int64_t n,
                  int64_t c, int64_t h, int64_t w, Strides si, Strides sf,
                  Strides so, cudaStream_t stream) {
  constexpr int kThreads = 128;
  const dim3 blocks(static_cast<unsigned int>((w + kThreads - 1) / kThreads),
                    static_cast<unsigned int>(h), static_cast<unsigned int>(n));
  softsplat_kernel<TI, TF><<<blocks, kThreads, 0, stream>>>(
      static_cast<const TI*>(in), static_cast<const TF*>(flow), out, c, h, w,
      si, sf, so);
}

template <typename TI>
int launch_flow(const void* in, const void* flow, float* out, int flow_dtype,
                int64_t n, int64_t c, int64_t h, int64_t w, Strides si,
                Strides sf, Strides so, cudaStream_t stream) {
  switch (flow_dtype) {
    case kF32:
      launch_typed<TI, float>(in, flow, out, n, c, h, w, si, sf, so, stream);
      return 0;
    case kBF16:
      launch_typed<TI, __nv_bfloat16>(in, flow, out, n, c, h, w, si, sf, so,
                                      stream);
      return 0;
    case kF16:
      launch_typed<TI, __half>(in, flow, out, n, c, h, w, si, sf, so, stream);
      return 0;
  }
  return -1;
}

}  // namespace

// Splat `in` ([n, c, h, w] by element strides) by `flow` ([n, 2, h, w],
// channel 0 = x, 1 = y), adding into the zeroed f32 `out` ([n, c, h, w]).
// Dtype codes: 0 f32, 1 bf16, 2 f16. Returns the launch's cudaGetLastError()
// (0 on success), -1 for an unknown dtype code, or -2 when n or h exceeds the
// grid's 65535 limit. Launches on `stream` and does not synchronise.
extern "C" int cfi_softsplat(const void* in, const void* flow, void* out,
                             int in_dtype, int flow_dtype, int64_t n,
                             int64_t c, int64_t h, int64_t w, int64_t si_n,
                             int64_t si_c, int64_t si_h, int64_t si_w,
                             int64_t sf_n, int64_t sf_c, int64_t sf_h,
                             int64_t sf_w, int64_t so_n, int64_t so_c,
                             int64_t so_h, int64_t so_w, void* stream) {
  if (n * h * w == 0) return 0;
  if (n > 65535 || h > 65535) return -2;  // grid y/z limits
  const Strides si{si_n, si_c, si_h, si_w};
  const Strides sf{sf_n, sf_c, sf_h, sf_w};
  const Strides so{so_n, so_c, so_h, so_w};
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (in_dtype) {
    case kF32:
      rc = launch_flow<float>(in, flow, op, flow_dtype, n, c, h, w, si, sf, so,
                              s);
      break;
    case kBF16:
      rc = launch_flow<__nv_bfloat16>(in, flow, op, flow_dtype, n, c, h, w,
                                      si, sf, so, s);
      break;
    case kF16:
      rc = launch_flow<__half>(in, flow, op, flow_dtype, n, c, h, w, si, sf,
                               so, s);
      break;
    default:
      rc = -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
