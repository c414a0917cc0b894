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
// bits. It is bounded by bytes: the input, the flow and the f32 output
// gradient read once, the two gradients written once (268.4 MB at M2M's b8
// 256x256 training splat, NHWC [64, 256, 256, 4] f32: 0.080 ms at 3.35
// TB/s; 105.9 MB at EISAI's [8, 128, 128, 66] f32: 0.032 ms); the gathers
// of neighbouring sources share their corners in L1 and L2. A first body
// gave each source a power-of-two group of lanes, 4 channels a lane, and
// reached 58 % of that bound at C = 4 but 22 % at EISAI's C = 66 (PERF.md),
// for three reasons, each of which this body answers:
//   1. idle lanes: C = 65 or 66 is 17 groups of 4 on 32 lanes. Here a
//      block takes a flat run of sources (of all n * h * w) and its lanes
//      cover the run's (source, vector) pairs in order, so no lane idles but
//      at the run's end (softsplat_backward_kernel_spread);
//   2. scalar loads: 4-channel vectors need every pixel on 16 bytes, which
//      f32 pixels of C = 6, 65, 66, 258 ... are not. The host picks the
//      channels per vector K (4, 2 or 1) as the largest for which in,
//      grad_out and grad_in have contiguous channels and every pixel starts
//      on K elements of its own dtype: EISAI's f32 C = 66, 258, 514 read
//      8-byte vectors, odd C 4-byte words whose lanes sit side by side, so
//      every warp-wide access is one contiguous run;
//   3. work repeated per lane: a thread per source loads its flow once,
//      computes its corners (splat_corners) and stages their offsets, bilinear
//      factors and kept bits in shared memory for the pairs; each pair
//      writes its four corner sums to a slot of a table in shared memory,
//      and after one barrier lanes per (source, corner) add the slots in a
//      fixed order (no shared-memory atomics, which would make the sum's
//      order change from run to run), shuffles join the four corners, and
//      one lane stores the flow's gradient as one vector.
// A block's stage, pairs and sums run one after the other, so each block
// waits out two memory round trips besides its pairs' own; a run of up to
// 2048 pairs (8 a thread) shares them among more work. On the H100 that
// measured 1.1-1.3x faster than 1024 pairs, and 3072-6144 pairs (the table
// in dynamic shared memory), warps that each take their own run with no
// block-wide barrier, 8 pairs a thread in flight at once, and a 64-register
// cap (which spills) all measured slower (PERF.md).
// The input's gradient sums its four corner products in corner order with
// the _rn intrinsics in every body, so it is the same bits whatever the
// vector width; the flow's sums meet in another order than the first
// body's. Sources of up to 8 channels (M2M, STMFNet, XVFI, GMFSS's C = 4,
// EISAI's C = 6: a pixel of two vectors gains nothing from a table) and
// inputs whose channels are not contiguous (NCHW planes, where a warp then
// reads 32 neighbouring pixels of one channel) keep a thread per source
// (softsplat_backward_kernel), 4 channels at a time in vectors of K.

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

// B bytes as one load or store
template <int B>
struct Bits;
template <>
struct Bits<16> {
  using T = uint4;
};
template <>
struct Bits<8> {
  using T = uint2;
};
template <>
struct Bits<4> {
  using T = unsigned int;
};

// N (2 or 4) elements from an address aligned to N * sizeof(T), as f32
template <int N, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  using B = typename Bits<N * sizeof(T)>::T;
  const B raw = __ldg(reinterpret_cast<const B*>(p));
  T e[N];
  memcpy(e, &raw, sizeof(raw));
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = load_f32(&e[j]);
}

template <int N, typename T>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  T e[N];
#pragma unroll
  for (int j = 0; j < N; ++j) store_f32(&e[j], v[j]);
  typename Bits<N * sizeof(T)>::T raw;
  memcpy(&raw, e, sizeof(raw));
  *reinterpret_cast<decltype(raw)*>(p) = raw;
}

// `n` <= 4 channels of a pixel as f32 (the rest 0). K is the channels per
// vector that the host found aligned in every pixel (4, 2; 1 for elements,
// by `stride_c`): a full run of K channels is one vector, a tail is read in
// pieces of 2 (which K = 4's alignment also gives) or elements.
template <int K, typename T>
__device__ __forceinline__ void load_run(const T* p, int64_t stride_c, int n,
                                         float (&v)[4]) {
  if constexpr (K == 4) {
    if (n == 4) {
      load_vec<4>(p, v);
      return;
    }
  }
  if constexpr (K >= 2) {
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      if (j + 2 <= n) {
        load_vec<2>(p + j, v + j);
      } else {
        v[j] = j < n ? load_f32(p + j) : 0.0f;
        v[j + 1] = 0.0f;
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j < n ? load_f32(p + j * stride_c) : 0.0f;
}

// The `n` <= 4 channels `v` of a pixel in T, as load_run reads them.
template <int K, typename T>
__device__ __forceinline__ void store_run(T* p, int64_t stride_c, int n,
                                          const float (&v)[4]) {
  if constexpr (K == 4) {
    if (n == 4) {
      store_vec<4>(p, v);
      return;
    }
  }
  if constexpr (K >= 2) {
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      if (j + 2 <= n) {
        store_vec<2>(p + j, v + j);
      } else if (j < n) {
        store_f32(p + j, v[j]);
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < n) store_f32(p + j * stride_c, v[j]);
  }
}

// `n` <= N channels of a pixel whose runs of N channels start aligned, as
// f32 (the rest 0): a full run as one vector, a tail by elements.
template <int N, typename T>
__device__ __forceinline__ void load_n(const T* p, int n, float (&v)[N]) {
  if (n == N) {
    if constexpr (N == 1) {
      v[0] = load_f32(p);
    } else {
      load_vec<N>(p, v);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = j < n ? load_f32(p + j) : 0.0f;
}

// The `n` <= N channels `v` of a pixel in T, as load_n reads them.
template <int N, typename T>
__device__ __forceinline__ void store_n(T* p, int n, const float (&v)[N]) {
  if (n == N) {
    if constexpr (N == 1) {
      store_f32(p, v[0]);
    } else {
      store_vec<N>(p, v);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < n) store_f32(p + j, v[j]);
  }
}

// A source's flow gradient (x, y): one 8-byte (f32) or 4-byte (bf16, f16)
// store where the two channels are adjacent and aligned, else two stores.
template <typename TF>
__device__ __forceinline__ void store_flow(TF* p, int64_t stride_c, float gx,
                                           float gy) {
  if (stride_c == 1 &&
      (reinterpret_cast<uintptr_t>(p) & (2 * sizeof(TF) - 1)) == 0) {
    const float v[2] = {gx, gy};
    store_vec<2>(p, v);
  } else {
    store_f32(p, gx);
    store_f32(p + stride_c, gy);
  }
}

// a / d for non-negative a, d: a 32-bit division where both fit (every
// practical frame), a 64-bit one otherwise
__device__ __forceinline__ int64_t div_index(int64_t a, int64_t d) {
  return ((a | d) >> 32) == 0
             ? static_cast<int64_t>(static_cast<uint32_t>(a) / static_cast<uint32_t>(d))
             : a / d;
}

// The input's gradient of `n` <= 4 channels from the output's gradient at
// the four corners (0 where a corner is dropped), in corner order.
template <int N>
__device__ __forceinline__ void gather_in_grad(const float (&g)[4][N],
                                               const float (&weight)[4],
                                               int mask, float (&gi)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (mask & (1 << k)) acc = __fadd_rn(acc, __fmul_rn(g[k][j], weight[k]));
    }
    gi[j] = acc;
  }
}

// Each corner's sum over N channels of in * g, added to `sk` in channel
// order.
template <int N>
__device__ __forceinline__ void add_corner_sums(const float (&v)[N],
                                                const float (&g)[4][N],
                                                float (&sk)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int j = 0; j < N; ++j) sk[k] = __fadd_rn(sk[k], __fmul_rn(v[j], g[k][j]));
  }
}

// The flow's gradient from the four corners' sums and the source's
// bilinear weights: (d/dfx, d/dfy).
__device__ __forceinline__ float2 flow_grad(const float (&sk)[4], float wx0,
                                            float wx1, float wy0, float wy1) {
  return make_float2(
      __fadd_rn(__fmul_rn(__fsub_rn(sk[1], sk[0]), wy0),
                __fmul_rn(__fsub_rn(sk[3], sk[2]), wy1)),
      __fadd_rn(__fmul_rn(__fsub_rn(sk[2], sk[0]), wx0),
                __fmul_rn(__fsub_rn(sk[3], sk[1]), wx1)));
}

// the most sources a spread block stages
constexpr int kBwdSources = 256;
// the (source, vector) pairs a spread block covers: up to kBwdPairs (8 a
// thread; the size of its table of corner sums, a multiple of kThreads),
// fewer where that would leave fewer than kBwdMinBlocks blocks (2 on each
// of the H100's 132 SMs), but at least one a thread
constexpr int kBwdPairs = 2048;
constexpr int64_t kBwdMinBlocks = 264;
// at most this many lanes sum one corner of one source's table (four
// corners' lanes then sit in one warp)
constexpr int kBwdMaxLanes = 8;

struct BackwardArgs {
  const void* in;
  const void* flow;
  const float* grad_out;
  void* grad_in;  // null: the input's gradient is not computed
  void* grad_flow;
  int64_t nhw, c, h, w;
  Strides si, sf, sg, sgi, sgf;
  int vecs;           // spread: vectors per source
  int block_sources;  // sources a block takes
  int log2_lanes;     // spread: lanes per (source, corner) sum
};

// A source's flat index q (row-major over n, h, w) as (b, y, x).
__device__ __forceinline__ void source_at(int64_t q, int64_t h, int64_t w,
                                          int64_t& b, int64_t& y, int64_t& x) {
  const int64_t row = div_index(q, w);
  x = q - row * w;
  b = div_index(row, h);
  y = row - b * h;
}

// A source per thread, its channels 4 at a time: for sources of up to 8
// channels and for inputs whose channels are not contiguous, where a warp
// then reads 32 neighbouring pixels of one channel.
template <typename TI, typename TF, int K>
__global__ void __launch_bounds__(kThreads)
    softsplat_backward_kernel(const BackwardArgs a) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= a.nhw) return;
  int64_t b, y, x;
  source_at(q, a.h, a.w, b, y, x);
  float fx, fy;
  load_flow(static_cast<const TF*>(a.flow) + b * a.sf.n + y * a.sf.h + x * a.sf.w,
            a.sf.c, fx, fy);
  const Corners cn = splat_corners(x, y, a.w, a.h, fx, fy);
  const int mask = (cn.valid[0] ? 1 : 0) | (cn.valid[1] ? 2 : 0) |
                   (cn.valid[2] ? 4 : 0) | (cn.valid[3] ? 8 : 0);
  const float* gb = a.grad_out + b * a.sg.n + cn.iy0 * a.sg.h + cn.ix0 * a.sg.w;
  const TI* src = static_cast<const TI*>(a.in) + b * a.si.n + y * a.si.h + x * a.si.w;
  TI* dst = a.grad_in == nullptr
                ? nullptr
                : static_cast<TI*>(a.grad_in) + b * a.sgi.n + y * a.sgi.h + x * a.sgi.w;
  float sk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int64_t ch = 0; ch < a.c; ch += 4) {
    const int nch = static_cast<int>(a.c - ch < 4 ? a.c - ch : 4);
    float g[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (mask & (1 << k)) {
        load_run<K>(gb + (k >> 1) * a.sg.h + (k & 1) * a.sg.w + ch * a.sg.c, a.sg.c, nch, g[k]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) g[k][j] = 0.0f;
      }
    }
    if (dst != nullptr) {
      float gi[4];
      gather_in_grad(g, cn.weight, mask, gi);
      store_run<K>(dst + ch * a.sgi.c, a.sgi.c, nch, gi);
    }
    if (cn.live) {
      float v[4];
      load_run<K>(src + ch * a.si.c, a.si.c, nch, v);
      add_corner_sums(v, g, sk);
    }
  }
  const float2 gf = flow_grad(sk, cn.wx0, cn.wx1, cn.wy0, cn.wy1);
  store_flow(static_cast<TF*>(a.grad_flow) + b * a.sgf.n + y * a.sgf.h + x * a.sgf.w,
             a.sgf.c, gf.x, gf.y);
}

// A staged source of a spread block (48 bytes).
struct alignas(16) StagedSource {
  float4 wxy;     // wx0, wx1, wy0, wy1
  int64_t g;      // the output gradient's offset of corner y0x0
  int64_t in, gi;  // the source's offsets in in and grad_in
  int mask;       // bits 0-3: the corners kept; bit 4: a finite target
};

// Channel-contiguous sources of several vectors (K channels each): a block
// takes a flat run of sources. A thread per source loads its flow, computes
// its corners and stages them; then the block's lanes cover the run's
// (source, vector) pairs in order, each pair writing its input gradient and
// its four corner sums (a slot of a table in shared memory); then lanes per
// (source, corner) add the table in a fixed order, and a source's flow
// gradient is stored by one lane.
template <typename TI, typename TF, int K>
__global__ void __launch_bounds__(kThreads)
    softsplat_backward_kernel_spread(const BackwardArgs a) {
  constexpr int kUnroll = K == 4 ? 2 : 4;
  __shared__ StagedSource staged[kBwdSources];
  __shared__ float4 sums[kBwdPairs];

  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * a.block_sources;
  const int ns = static_cast<int>(a.nhw - q0 < a.block_sources ? a.nhw - q0 : a.block_sources);
  const int vecs = a.vecs;

  // 1. a thread per source: one flow load, the corners, staged
  for (int i = threadIdx.x; i < ns; i += kThreads) {
    int64_t b, y, x;
    source_at(q0 + i, a.h, a.w, b, y, x);
    float fx, fy;
    load_flow(static_cast<const TF*>(a.flow) + b * a.sf.n + y * a.sf.h + x * a.sf.w,
              a.sf.c, fx, fy);
    const Corners cn = splat_corners(x, y, a.w, a.h, fx, fy);
    StagedSource s;
    s.wxy = make_float4(cn.wx0, cn.wx1, cn.wy0, cn.wy1);
    s.g = b * a.sg.n + cn.iy0 * a.sg.h + cn.ix0 * a.sg.w;
    s.in = b * a.si.n + y * a.si.h + x * a.si.w;
    s.gi = b * a.sgi.n + y * a.sgi.h + x * a.sgi.w;
    s.mask = (cn.valid[0] ? 1 : 0) | (cn.valid[1] ? 2 : 0) | (cn.valid[2] ? 4 : 0) |
             (cn.valid[3] ? 8 : 0) | (cn.live ? 16 : 0);
    staged[i] = s;
  }
  __syncthreads();

  // 2. the lanes cover the (source, vector) pairs in order, so a warp reads
  // each corner and writes the input's gradient as contiguous runs; kUnroll
  // pairs a thread, all their loads issued before the first sum. Pair q is
  // source q / vecs, vector q % vecs, stepped without a division.
  const TI* in = static_cast<const TI*>(a.in);
  TI* grad_in = static_cast<TI*>(a.grad_in);
  const int total = ns * vecs;
  const int step_p = kThreads / vecs;
  const int step_v = kThreads - step_p * vecs;
  int p = static_cast<int>(threadIdx.x) / vecs;
  int v = static_cast<int>(threadIdx.x) - p * vecs;
  for (int q = threadIdx.x; q < total; q += kUnroll * kThreads) {
    float g[kUnroll][4][K], val[kUnroll][K];
    int pu[kUnroll], nu[kUnroll];
    int64_t cu[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      pu[u] = p;
      cu[u] = static_cast<int64_t>(v) * K;
      nu[u] = static_cast<int>(a.c - cu[u] < K ? a.c - cu[u] : K);
      if (q + u * kThreads < total) {
        const int mask = staged[p].mask;
        const int64_t go = staged[p].g + cu[u];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (mask & (1 << k)) {
            load_n<K>(a.grad_out + go + (k >> 1) * a.sg.h + (k & 1) * a.sg.w, nu[u], g[u][k]);
          } else {
#pragma unroll
            for (int j = 0; j < K; ++j) g[u][k][j] = 0.0f;
          }
        }
        if (mask & 16) {
          load_n<K>(in + staged[p].in + cu[u], nu[u], val[u]);
        } else {
#pragma unroll
          for (int j = 0; j < K; ++j) val[u][j] = 0.0f;
        }
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
      const int pair = q + u * kThreads;
      if (pair < total) {
        const int mask = staged[pu[u]].mask;
        if (grad_in != nullptr) {
          // the corners' weights, as splat_corners multiplies them
          const float4 w = staged[pu[u]].wxy;
          const float weight[4] = {__fmul_rn(w.x, w.z), __fmul_rn(w.y, w.z), __fmul_rn(w.x, w.w),
                                   __fmul_rn(w.y, w.w)};
          float gi[K];
          gather_in_grad(g[u], weight, mask, gi);
          store_n<K>(grad_in + staged[pu[u]].gi + cu[u], nu[u], gi);
        }
        float sk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (mask & 16) add_corner_sums(val[u], g[u], sk);
        const float4 s4 = make_float4(sk[0], sk[1], sk[2], sk[3]);
        // a pair past the table adds into the slot of the pair kBwdPairs
        // before it, which the same thread wrote (a block of one source)
        if (pair < kBwdPairs) {
          sums[pair] = s4;
        } else {
          float4& t = sums[pair % kBwdPairs];
          t = make_float4(__fadd_rn(t.x, s4.x), __fadd_rn(t.y, s4.y), __fadd_rn(t.z, s4.z),
                          __fadd_rn(t.w, s4.w));
        }
      }
    }
  }
  __syncthreads();

  // 3. the flow's gradient: 2^log2_lanes lanes per (source, corner) add
  // that corner's slots (lane j those j, j + lanes, ..., into four sums
  // in turn, which meet at the end), the lanes' sums meet by shuffles, and
  // the four corners' sums by shuffles at the lane of corner 0, which
  // stores the source's gradient. Every lane of the block runs the same
  // rounds.
  const int lanes = 1 << a.log2_lanes;
  const int slots = vecs < kBwdPairs ? vecs : kBwdPairs;
  for (int base = 0; base < 4 * ns * lanes; base += kThreads) {
    const int idx = base + static_cast<int>(threadIdx.x);
    const int j = idx & (lanes - 1);
    const int k = (idx >> a.log2_lanes) & 3;
    const int s = idx >> (a.log2_lanes + 2);
    float acc = 0.0f;
    if (s < ns) {
      const float* col = reinterpret_cast<const float*>(sums + s * vecs) + k;
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int e = j;
      for (; e + 3 * lanes < slots; e += 4 * lanes) {
#pragma unroll
        for (int i = 0; i < 4; ++i) part[i] = __fadd_rn(part[i], col[4 * (e + i * lanes)]);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (e + i * lanes < slots) part[i] = __fadd_rn(part[i], col[4 * (e + i * lanes)]);
      }
      acc = __fadd_rn(__fadd_rn(part[0], part[1]), __fadd_rn(part[2], part[3]));
    }
    for (int off = lanes >> 1; off > 0; off >>= 1) {
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
    float sk[4];
    sk[0] = acc;
    sk[1] = __shfl_down_sync(0xffffffffu, acc, lanes);
    sk[2] = __shfl_down_sync(0xffffffffu, acc, 2 * lanes);
    sk[3] = __shfl_down_sync(0xffffffffu, acc, 3 * lanes);
    if (s < ns && k == 0 && j == 0) {
      const float4 w = staged[s].wxy;
      const float2 gf = flow_grad(sk, w.x, w.y, w.z, w.w);
      int64_t b, y, x;
      source_at(q0 + s, a.h, a.w, b, y, x);
      store_flow(static_cast<TF*>(a.grad_flow) + b * a.sgf.n + y * a.sgf.h + x * a.sgf.w,
                 a.sgf.c, gf.x, gf.y);
    }
  }
}

// Whether every pixel of a tensor at `p` with element strides `st` and
// elements of `isz` bytes starts on k elements with its channels
// contiguous.
bool pixels_fit(const void* p, const Strides& st, int64_t c, int64_t isz, int64_t k) {
  if (c > 1 && st.c != 1) return false;
  const uint64_t bits = static_cast<uint64_t>(reinterpret_cast<uintptr_t>(p)) |
                        static_cast<uint64_t>(st.n * isz) |
                        static_cast<uint64_t>(st.h * isz) |
                        static_cast<uint64_t>(st.w * isz);
  return bits % static_cast<uint64_t>(k * isz) == 0;
}

template <typename TI, typename TF, int K>
void launch_backward_k(BackwardArgs a, bool spread, cudaStream_t stream) {
  if (!spread) {
    const dim3 blocks(static_cast<unsigned int>((a.nhw + kThreads - 1) / kThreads));
    softsplat_backward_kernel<TI, TF, K><<<blocks, kThreads, 0, stream>>>(a);
    return;
  }
  const int64_t vecs = (a.c + K - 1) / K;
  int64_t pairs = a.nhw * vecs / kBwdMinBlocks;
  pairs = pairs < kThreads ? kThreads : (pairs > kBwdPairs ? kBwdPairs : pairs);
  const int64_t per_block = pairs / vecs;
  a.vecs = static_cast<int>(vecs);
  a.block_sources = static_cast<int>(
      per_block < 1 ? 1 : (per_block > kBwdSources ? kBwdSources : per_block));
  a.log2_lanes = 0;
  while (2 * (1 << a.log2_lanes) <= kBwdMaxLanes &&
         4 * a.block_sources * (2 << a.log2_lanes) <= kThreads &&
         (1 << a.log2_lanes) < vecs) {
    ++a.log2_lanes;
  }
  const dim3 blocks(static_cast<unsigned int>((a.nhw + a.block_sources - 1) / a.block_sources));
  softsplat_backward_kernel_spread<TI, TF, K><<<blocks, kThreads, 0, stream>>>(a);
}

// The channels per vector: the largest k of 4 and 2 for which in, grad_out
// and grad_in (where computed) have contiguous channels and every pixel
// starting on k elements of its own dtype, else 1. Sources of up to 8
// channels, and inputs whose channels are not contiguous, take a thread per
// source; the rest spread over (source, vector) pairs.
template <typename TI, typename TF>
void launch_backward_typed(const BackwardArgs& a, cudaStream_t stream) {
  constexpr int64_t isz = sizeof(TI);
  auto fits = [&](int64_t k) {
    return pixels_fit(a.in, a.si, a.c, isz, k) &&
           pixels_fit(a.grad_out, a.sg, a.c, sizeof(float), k) &&
           (a.grad_in == nullptr || pixels_fit(a.grad_in, a.sgi, a.c, isz, k));
  };
  const bool contiguous = fits(1);
  const int k = fits(4) ? 4 : fits(2) ? 2 : 1;
  const bool spread = contiguous && a.c > 8;
  if (k == 4) {
    launch_backward_k<TI, TF, 4>(a, spread, stream);
  } else if (k == 2) {
    launch_backward_k<TI, TF, 2>(a, spread, stream);
  } else {
    launch_backward_k<TI, TF, 1>(a, spread, stream);
  }
}

template <typename TI>
int launch_backward_flow(const BackwardArgs& a, int flow_dtype,
                         cudaStream_t stream) {
  switch (flow_dtype) {
    case kF32:
      launch_backward_typed<TI, float>(a, stream);
      return 0;
    case kBF16:
      launch_backward_typed<TI, __nv_bfloat16>(a, stream);
      return 0;
    case kF16:
      launch_backward_typed<TI, __half>(a, stream);
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
// n * h * w or c exceeds what the grid and the kernel's indices hold, -3
// when `grad_flow` is null. Launches on `stream` and does not synchronise.
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
  if (n * h * w > 0x7fffffff || c > (int64_t{1} << 28)) return -2;
  BackwardArgs a;
  a.in = in;
  a.flow = flow;
  a.grad_out = static_cast<const float*>(grad_out);
  a.grad_in = grad_in;
  a.grad_flow = grad_flow;
  a.nhw = n * h * w;
  a.c = c;
  a.h = h;
  a.w = w;
  a.si = Strides{si_n, si_c, si_h, si_w};
  a.sf = Strides{sf_n, sf_c, sf_h, sf_w};
  a.sg = Strides{sg_n, sg_c, sg_h, sg_w};
  a.sgi = Strides{sgi_n, sgi_c, sgi_h, sgi_w};
  a.sgf = Strides{sgf_n, sgf_c, sgf_h, sgf_w};
  a.vecs = 1;
  a.block_sources = kThreads;
  a.log2_lanes = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (in_dtype) {
    case kF32:
      rc = launch_backward_flow<float>(a, flow_dtype, s);
      break;
    case kBF16:
      rc = launch_backward_flow<__nv_bfloat16>(a, flow_dtype, s);
      break;
    case kF16:
      rc = launch_backward_flow<__half>(a, flow_dtype, s);
      break;
    default:
      rc = -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
