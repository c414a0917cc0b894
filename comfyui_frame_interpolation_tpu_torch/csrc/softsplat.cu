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
//
// The splat's gradient (softsplat_backward_kernel, cfi_softsplat_backward)
// replaces no Pallas kernel: the JAX package trains through XLA's VJP of the
// scatter-add in comfyui_frame_interpolation_tpu/ops/softsplat.py
// (_softsplat_xla, l.83). Its plain version is
// ops/softsplat.py:softsplat_backward_torch. For a source p with kept
// corners q_k, weights w_k and the output's gradient g:
//   grad_in[p][c] = sum_k w_k * g[q_k][c]
//   s_k = sum_c in[p][c] * g[q_k][c]
//   grad_fx[p] = (s_y0x1 - s_y0x0) * wy0 + (s_y1x1 - s_y1x0) * wy1
//   grad_fy[p] = (s_y1x0 - s_y0x0) * wx0 + (s_y1x1 - s_y0x1) * wx1
// (floor has a zero derivative, so d wx1 / d fx = 1 and d wx0 / d fx = -1,
// one-sided at an integer coordinate as in JAX). A dropped corner adds
// nothing, and a source with a non-finite or clamped target keeps no corner,
// so its gradients are 0. Both kernels take their corners and weights from
// one function, splat_corners, so a sample rounds to the same pixels in
// both and its flow gradient does not jump.
//
// The backward is a gather, not a scatter: each source reads the output's
// gradient at its own four corners and writes only its own pixel. So it
// needs no atomics and no zero-filled buffer, and two launches give the same
// bits. A group of G lanes (a power of two, up to a warp) takes a source,
// each lane 4 channels at a time (one 16-byte f32 or 8-byte bf16/f16 vector
// where the channels are contiguous and every pixel aligned), and the flow
// gradient's channel sums meet by warp shuffles. It is bounded by bytes:
// the input, the flow and the output's gradient read once, the two
// gradients written once (268.4 MB at M2M's b8 256x256 training splat, NHWC
// [64, 256, 256, 4] f32: 0.080 ms at 3.35 TB/s); the gathers of
// neighbouring sources share their corners in L1 and L2.

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

// A source's four target corners and their bilinear weights, as both
// kernels compute them. Corners 0 .. 3: y0x0, y0x1, y1x0, y1x1.
struct Corners {
  int64_t ix0 = 0, iy0 = 0;
  float wx0 = 0.0f, wx1 = 0.0f, wy0 = 0.0f, wy1 = 0.0f;
  float weight[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  bool valid[4] = {false, false, false, false};  // on the frame
  bool live = false;                              // a finite target
};

// The corners of the source at (x, y) moved by the flow (fx, fy): a
// non-finite target keeps no corner; the target is clamped to +-2w / +-2h
// (a clamped axis keeps both corners off the frame) so that the float to
// int conversion is defined. The _rn intrinsics keep nvcc from contracting
// the products and differences into FMAs.
__device__ __forceinline__ Corners splat_corners(int64_t x, int64_t y,
                                                 int64_t w, int64_t h,
                                                 float fx, float fy) {
  Corners k;
  fx = __fadd_rn(static_cast<float>(x), fx);
  fy = __fadd_rn(static_cast<float>(y), fy);
  if (!(isfinite(fx) && isfinite(fy))) return k;
  const float fw = static_cast<float>(w);
  const float fh = static_cast<float>(h);
  fx = fminf(fmaxf(fx, -2.0f * fw), 2.0f * fw);
  fy = fminf(fmaxf(fy, -2.0f * fh), 2.0f * fh);
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  k.live = true;
  k.wx1 = __fsub_rn(fx, x0);
  k.wy1 = __fsub_rn(fy, y0);
  k.wx0 = __fsub_rn(1.0f, k.wx1);
  k.wy0 = __fsub_rn(1.0f, k.wy1);
  k.ix0 = static_cast<int64_t>(x0);
  k.iy0 = static_cast<int64_t>(y0);
  k.weight[0] = __fmul_rn(k.wx0, k.wy0);
  k.weight[1] = __fmul_rn(k.wx1, k.wy0);
  k.weight[2] = __fmul_rn(k.wx0, k.wy1);
  k.weight[3] = __fmul_rn(k.wx1, k.wy1);
  const bool vx0 = k.ix0 >= 0 && k.ix0 < w;
  const bool vx1 = k.ix0 + 1 >= 0 && k.ix0 + 1 < w;
  const bool vy0 = k.iy0 >= 0 && k.iy0 < h;
  const bool vy1 = k.iy0 + 1 >= 0 && k.iy0 + 1 < h;
  k.valid[0] = vy0 && vx0;
  k.valid[1] = vy0 && vx1;
  k.valid[2] = vy1 && vx0;
  k.valid[3] = vy1 && vx1;
  return k;
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

  // 1. the source's corners and weights
  bool live = x < w && y < h;
  Corners cn;
  if (live) {
    float fx, fy;
    load_flow(flow + b * sf.n + y * sf.h + x * sf.w, sf.c, fx, fy);
    cn = splat_corners(x, y, w, h, fx, fy);
    live = cn.live;
  }
  const int64_t ix0 = cn.ix0, iy0 = cn.iy0;
  const int64_t ix1 = ix0 + 1;
  const int64_t iy1 = iy0 + 1;
  bool valid[4] = {cn.valid[0], cn.valid[1], cn.valid[2], cn.valid[3]};
  const float(&weight)[4] = cn.weight;
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

// ---- the splat's gradient -------------------------------------------------

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_f32(__half* p, float v) {
  *p = __float2half_rn(v);
}

// `n` <= 4 channels of a pixel as f32 (the rest 0): one aligned vector (16
// bytes of f32, 8 of bf16/f16) where `vec` and all 4 are there, else one
// element at a time by `stride_c`.
template <typename T>
__device__ __forceinline__ void load4(const T* p, int64_t stride_c, int n,
                                      bool vec, float (&v)[4]) {
  if (vec && n == 4) {
    if constexpr (sizeof(T) == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      T e[4];
      memcpy(e, &q, sizeof(q));
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = load_f32(&e[j]);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j < n ? load_f32(p + j * stride_c) : 0.0f;
}

// The `n` <= 4 channels `v` of a pixel in T, as load4 reads them.
template <typename T>
__device__ __forceinline__ void store4(T* p, int64_t stride_c, int n, bool vec,
                                       const float (&v)[4]) {
  if (vec && n == 4) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      T e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) store_f32(&e[j], v[j]);
      uint2 q;
      memcpy(&q, e, sizeof(q));
      *reinterpret_cast<uint2*>(p) = q;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < n) store_f32(p + j * stride_c, v[j]);
  }
}

// What a backward launch computes, and which tensors it reads in vectors.
enum : int {
  kInGrad = 1,  // write grad_in
  kVecIn = 2,   // in, grad_out and grad_in: 4 channels as one vector
  kVecGrad = 4,
  kVecInGrad = 8,
};

struct BackwardArgs {
  const void* in;
  const void* flow;
  const float* grad_out;
  void* grad_in;
  void* grad_flow;
  int64_t c, h, w;
  Strides si, sf, sg, sgi, sgf;
  int log2_group;  // 2^log2_group lanes per source
  int flags;
};

template <typename TI, typename TF>
__global__ void __launch_bounds__(kThreads)
    softsplat_backward_kernel(const BackwardArgs a) {
  // grid (ceil(h * w / sources a block), n), kThreads threads a block: a
  // group of lanes per source, the sources of an image in row-major order
  const int group = 1 << a.log2_group;
  const int lane = threadIdx.x & (group - 1);
  const int64_t s = static_cast<int64_t>(blockIdx.x) * (kThreads >> a.log2_group) +
                    (threadIdx.x >> a.log2_group);
  const int64_t b = blockIdx.y;
  const bool in_frame = s < a.h * a.w;
  const int64_t y = in_frame ? s / a.w : 0;
  const int64_t x = in_frame ? s - y * a.w : 0;

  // 1. the source's corners and weights, as the forward computes them
  Corners cn;
  if (in_frame) {
    float fx, fy;
    load_flow(static_cast<const TF*>(a.flow) + b * a.sf.n + y * a.sf.h + x * a.sf.w,
              a.sf.c, fx, fy);
    cn = splat_corners(x, y, a.w, a.h, fx, fy);
  }
  const float* gb = a.grad_out + b * a.sg.n;
  const TI* src = static_cast<const TI*>(a.in) + b * a.si.n + y * a.si.h + x * a.si.w;

  // 2. this lane's groups of 4 channels: the input's gradient gathered from
  // the kept corners (in corner order), and each corner's sum over the
  // channels of in * g for the flow's gradient
  float sk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int64_t groups = (a.c + 3) / 4;
  for (int64_t cg = lane; cg < groups; cg += group) {
    const int64_t ch = cg * 4;
    const int nch = static_cast<int>(a.c - ch < 4 ? a.c - ch : 4);
    float g[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (cn.valid[k]) {
        const float* q = gb + (cn.iy0 + (k >> 1)) * a.sg.h + (cn.ix0 + (k & 1)) * a.sg.w;
        load4(q + ch * a.sg.c, a.sg.c, nch, (a.flags & kVecGrad) != 0, g[k]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) g[k][j] = 0.0f;
      }
    }
    if ((a.flags & kInGrad) && in_frame) {
      float gi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (cn.valid[k]) acc = __fadd_rn(acc, __fmul_rn(g[k][j], cn.weight[k]));
        }
        gi[j] = acc;
      }
      TI* dst = static_cast<TI*>(a.grad_in) + b * a.sgi.n + y * a.sgi.h + x * a.sgi.w;
      store4(dst + ch * a.sgi.c, a.sgi.c, nch, (a.flags & kVecInGrad) != 0, gi);
    }
    if (cn.live) {
      float v[4];
      load4(src + ch * a.si.c, a.si.c, nch, (a.flags & kVecIn) != 0, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sk[k] = __fadd_rn(sk[k], __fmul_rn(v[j], g[k][j]));
      }
    }
  }

  // 3. the flow's gradient: the group's sums meet by shuffles (every lane of
  // the warp takes part), and the group's first lane writes it
  for (int off = group >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) sk[k] = __fadd_rn(sk[k], __shfl_xor_sync(0xffffffffu, sk[k], off));
  }
  if (lane == 0 && in_frame) {
    const float gfx = __fadd_rn(__fmul_rn(__fsub_rn(sk[1], sk[0]), cn.wy0),
                                __fmul_rn(__fsub_rn(sk[3], sk[2]), cn.wy1));
    const float gfy = __fadd_rn(__fmul_rn(__fsub_rn(sk[2], sk[0]), cn.wx0),
                                __fmul_rn(__fsub_rn(sk[3], sk[1]), cn.wx1));
    TF* gf = static_cast<TF*>(a.grad_flow) + b * a.sgf.n + y * a.sgf.h + x * a.sgf.w;
    store_f32(gf, gfx);
    store_f32(gf + a.sgf.c, gfy);
  }
}

// Whether 4 channels of every pixel of a tensor of c channels at `p` with
// element strides `st` are one aligned vector of 4 * isz bytes.
bool vectors_fit(const void* p, const Strides& st, int64_t c, int64_t isz) {
  if (p == nullptr || (c > 1 && st.c != 1)) return false;
  const uint64_t bits = static_cast<uint64_t>(reinterpret_cast<uintptr_t>(p)) |
                        static_cast<uint64_t>(st.n * isz) |
                        static_cast<uint64_t>(st.h * isz) |
                        static_cast<uint64_t>(st.w * isz);
  return bits % static_cast<uint64_t>(4 * isz) == 0;
}

template <typename TI, typename TF>
void launch_backward_typed(BackwardArgs a, int64_t n, cudaStream_t stream) {
  const int64_t isz = sizeof(TI);
  if (vectors_fit(a.in, a.si, a.c, isz)) a.flags |= kVecIn;
  if (vectors_fit(a.grad_out, a.sg, a.c, sizeof(float))) a.flags |= kVecGrad;
  if (vectors_fit(a.grad_in, a.sgi, a.c, isz)) a.flags |= kVecInGrad;
  const int64_t per_block = kThreads >> a.log2_group;
  const dim3 blocks(static_cast<unsigned int>((a.h * a.w + per_block - 1) / per_block),
                    static_cast<unsigned int>(n));
  softsplat_backward_kernel<TI, TF><<<blocks, kThreads, 0, stream>>>(a);
}

template <typename TI>
int launch_backward_flow(const BackwardArgs& a, int flow_dtype, int64_t n,
                         cudaStream_t stream) {
  switch (flow_dtype) {
    case kF32:
      launch_backward_typed<TI, float>(a, n, stream);
      return 0;
    case kBF16:
      launch_backward_typed<TI, __nv_bfloat16>(a, n, stream);
      return 0;
    case kF16:
      launch_backward_typed<TI, __half>(a, n, stream);
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

// The gradient of the splat of `in` ([n, c, h, w] by element strides) by
// `flow` ([n, 2, h, w]) for the f32 output gradient `grad_out` ([n, c, h,
// w], any strides, stride 0 included): `grad_in` ([n, c, h, w], in's
// dtype) and `grad_flow` ([n, 2, h, w], flow's dtype), each written in full
// by the kernel (no zero fill needed). `grad_in` may be null and is then not
// computed. Dtype codes as cfi_softsplat. Returns the launch's
// cudaGetLastError() (0 on success), -1 for an unknown dtype code, -2 when
// n or h*w exceeds the grid, -3 when `grad_flow` is null. Launches on
// `stream` and does not synchronise.
extern "C" int cfi_softsplat_backward(
    const void* in, const void* flow, const void* grad_out, void* grad_in,
    void* grad_flow, int in_dtype, int flow_dtype, int64_t n, int64_t c,
    int64_t h, int64_t w, int64_t si_n, int64_t si_c, int64_t si_h,
    int64_t si_w, int64_t sf_n, int64_t sf_c, int64_t sf_h, int64_t sf_w,
    int64_t sg_n, int64_t sg_c, int64_t sg_h, int64_t sg_w, int64_t sgi_n,
    int64_t sgi_c, int64_t sgi_h, int64_t sgi_w, int64_t sgf_n, int64_t sgf_c,
    int64_t sgf_h, int64_t sgf_w, void* stream) {
  if (grad_flow == nullptr) return -3;
  if (n * h * w == 0) return 0;
  if (n > 65535 || h * w > (int64_t{1} << 31)) return -2;
  BackwardArgs a;
  a.in = in;
  a.flow = flow;
  a.grad_out = static_cast<const float*>(grad_out);
  a.grad_in = grad_in;
  a.grad_flow = grad_flow;
  a.c = c;
  a.h = h;
  a.w = w;
  a.si = Strides{si_n, si_c, si_h, si_w};
  a.sf = Strides{sf_n, sf_c, sf_h, sf_w};
  a.sg = Strides{sg_n, sg_c, sg_h, sg_w};
  a.sgi = Strides{sgi_n, sgi_c, sgi_h, sgi_w};
  a.sgf = Strides{sgf_n, sgf_c, sgf_h, sgf_w};
  // lanes per source: the groups of 4 channels, rounded up to a power of
  // two, at most a warp
  a.log2_group = 0;
  while ((int64_t{1} << a.log2_group) * 4 < c && a.log2_group < 5) ++a.log2_group;
  a.flags = grad_in != nullptr ? kInGrad : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (in_dtype) {
    case kF32:
      rc = launch_backward_flow<float>(a, flow_dtype, n, s);
      break;
    case kBF16:
      rc = launch_backward_flow<__nv_bfloat16>(a, flow_dtype, n, s);
      break;
    case kF16:
      rc = launch_backward_flow<__half>(a, flow_dtype, n, s);
      break;
    default:
      rc = -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
