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
// fp32 atomics in L2, so none of that is carried over: each source adds its
// value into its four target corners with atomics, exact for any
// displacement.
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
// What bounds it on H100. The least traffic is the values and the flow in and
// the output once: at M2M's 1080p batch-2 splat ([16, 4, 1088, 1920] bf16,
// f32 flow, bf16 out) 0.80 GB, 0.239 ms at 3.35 TB/s. A thread per source
// with one scalar atomic per corner and channel issues 33.4 M x 4 x 4 =
// 535 M L2 atomics there, and that atomic rate, not the bytes, bounded the
// first version of this kernel. This one cuts the atomic operations:
//   1. vector atomics: a pixel's channels go to L2 as one atomicAdd(float4*)
//      (or float2) where the output has channel stride 1 and the pixel's
//      address is 16 (8) bytes aligned, as M2M's C = 4 NHWC output is;
//      other layouts and channel tails take scalar atomics;
//   2. pre-reduction of the corners that neighbouring sources share, for
//      C <= kMergeC (M2M's 4): a block takes a tile of sources, a thread
//      each, and merges the corners by rows and columns before one atomic
//      per corner left (scatter.cuh, shared with the warp's backward, whose
//      image gradient is the same kind of splat). For smooth flow most
//      corners merge; rough flow merges less, and a merge is exact whatever
//      the flow.

// The output buffer is f32 and zeroed by the caller; the kernel only adds.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "scatter.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

using scatter::kThreads;
using scatter::kTileH;
using scatter::kTileW;
// the widest input whose corners neighbouring sources merge before the
// atomics
constexpr int kMergeC = 4;

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

// A source's flow (x, y): one 8-byte (f32) or 4-byte (bf16, f16) load where
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

template <typename TI, typename TF>
__global__ void __launch_bounds__(kThreads)
    softsplat_kernel(const TI* __restrict__ in, const TF* __restrict__ flow,
                     float* __restrict__ out, int64_t c, int64_t h, int64_t w,
                     Strides si, Strides sf, Strides so) {
  // grid (ceil(w / kTileW), ceil(h / kTileH), n), block (kTileW, kTileH)
  __shared__ scatter::MergeTile<kMergeC> tile;

  const int64_t x = static_cast<int64_t>(blockIdx.x) * kTileW + threadIdx.x;
  const int64_t y = static_cast<int64_t>(blockIdx.y) * kTileH + threadIdx.y;
  const int64_t b = blockIdx.z;

  // 1. the source's corners and weights, as the first version computed them
  bool live = x < w && y < h;
  int64_t ix0 = 0, iy0 = 0;
  float wx0 = 0.0f, wx1 = 0.0f, wy0 = 0.0f, wy1 = 0.0f;
  if (live) {
    float fx, fy;
    load_flow(flow + b * sf.n + y * sf.h + x * sf.w, sf.c, fx, fy);
    fx = __fadd_rn(static_cast<float>(x), fx);
    fy = __fadd_rn(static_cast<float>(y), fy);
    live = isfinite(fx) && isfinite(fy);
    if (live) {
      const float fw = static_cast<float>(w);
      const float fh = static_cast<float>(h);
      fx = fminf(fmaxf(fx, -2.0f * fw), 2.0f * fw);
      fy = fminf(fmaxf(fy, -2.0f * fh), 2.0f * fh);
      const float x0 = floorf(fx);
      const float y0 = floorf(fy);
      wx1 = __fsub_rn(fx, x0);
      wy1 = __fsub_rn(fy, y0);
      wx0 = __fsub_rn(1.0f, wx1);
      wy0 = __fsub_rn(1.0f, wy1);
      ix0 = static_cast<int64_t>(x0);
      iy0 = static_cast<int64_t>(y0);
    }
  }
  const int64_t ix1 = ix0 + 1;
  const int64_t iy1 = iy0 + 1;
  const bool vx0 = live && ix0 >= 0 && ix0 < w;
  const bool vx1 = live && ix1 >= 0 && ix1 < w;
  const bool vy0 = live && iy0 >= 0 && iy0 < h;
  const bool vy1 = live && iy1 >= 0 && iy1 < h;
  // corners 0 .. 3: y0x0, y0x1, y1x0, y1x1
  bool valid[4] = {vy0 && vx0, vy0 && vx1, vy1 && vx0, vy1 && vx1};
  const float weight[4] = {__fmul_rn(wx0, wy0), __fmul_rn(wx1, wy0),
                           __fmul_rn(wx0, wy1), __fmul_rn(wx1, wy1)};
  const TI* src = in + b * si.n + y * si.h + x * si.w;
  float* ob = out + b * so.n;
  auto corner = [&](int k) {
    return ob + ((k & 2) ? iy1 : iy0) * so.h + ((k & 1) ? ix1 : ix0) * so.w;
  };

  if (c <= kMergeC) {
    // 2. the corners' sums, to be merged with the neighbours' that land on
    // the same pixels
    float sum[4][kMergeC];
#pragma unroll
    for (int ch = 0; ch < kMergeC; ++ch) {
      const float v = ch < c && live ? load_f32(src + ch * si.c) : 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) sum[k][ch] = __fmul_rn(v, weight[k]);
    }
    // 3. merge the corners that neighbouring sources share (by rows, then
    // columns)
    scatter::merge_corners(tile, static_cast<int>(ix0), static_cast<int>(ix1),
                           static_cast<int>(iy0), static_cast<int>(iy1), live,
                           sum, valid);
    // 4. one (vector) atomic per corner left
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (valid[k]) scatter::add_sums(corner(k), static_cast<int>(c), so.c, sum[k]);
    }
    return;
  }

  // wider inputs: every corner straight into global memory
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!valid[k]) continue;
    scatter::add_pixel(corner(k), c, so.c, [&](int64_t ch) {
      return __fmul_rn(load_f32(src + ch * si.c), weight[k]);
    });
  }
}

template <typename TI, typename TF>
void launch_typed(const void* in, const void* flow, float* out, int64_t n,
                  int64_t c, int64_t h, int64_t w, Strides si, Strides sf,
                  Strides so, cudaStream_t stream) {
  const dim3 blocks(static_cast<unsigned int>((w + kTileW - 1) / kTileW),
                    static_cast<unsigned int>((h + kTileH - 1) / kTileH),
                    static_cast<unsigned int>(n));
  softsplat_kernel<TI, TF><<<blocks, dim3(kTileW, kTileH), 0, stream>>>(
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
// (0 on success), -1 for an unknown dtype code, or -2 when n exceeds the
// grid's 65535 limit. Launches on `stream` and does not synchronise.
extern "C" int cfi_softsplat(const void* in, const void* flow, void* out,
                             int in_dtype, int flow_dtype, int64_t n,
                             int64_t c, int64_t h, int64_t w, int64_t si_n,
                             int64_t si_c, int64_t si_h, int64_t si_w,
                             int64_t sf_n, int64_t sf_c, int64_t sf_h,
                             int64_t sf_w, int64_t so_n, int64_t so_c,
                             int64_t so_h, int64_t so_w, void* stream) {
  if (n * h * w == 0) return 0;
  if (n > 65535 || h > 65535) return -2;  // grid z limit (and the wrapper's h)
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
