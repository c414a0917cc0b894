// Scatter helpers shared by the hand-written kernels that add bilinear
// contributions into an f32 buffer with atomics: the forward splat
// (softsplat.cu, K2) and the warp's backward (warp.cu), whose image gradient
// is a splat of the output's gradient at the sample coordinates.
//
// Both run a block per tile of kTileH x kTileW pixels, a warp per tile row
// and a thread per pixel. Each thread holds sums for its four corners (taps)
// 0 .. 3 = (y0, x0), (y0, x1), (y1, x0), (y1, x1). Before any atomic,
// merge_corners hands a sum to a neighbour whose corner is the same pixel:
//   rows: a thread's lower corners go to the thread below when they are that
//     thread's upper corners (plain stores and loads in shared memory,
//     between two barriers);
//   columns: a lane's right corners go to the next lane when they are its
//     left corners (warp shuffles); the lower pair only where neither lane's
//     lower corners went down.
// A merge is decided by the corners' coordinates alone, so it is exact for
// any flow; rough flow only merges less. For smooth flow every thread but
// the tile's last row and column hands its lower and right corners on, and
// about 1.16 corners a pixel are left. Each corner left takes one atomic:
// add_sums issues a float4 atomic per aligned group of 4 channels where the
// buffer's channels are contiguous (Hopper has native global atomicAdd on
// float2 and float4).
// A shared-memory box of f32 sums filled with shared atomics is not used:
// Hopper has no native shared-memory f32 atomic add (nvcc emits a
// compare-and-swap loop, ATOMS.CAST.SPIN in the SASS), and that design was
// slower than the direct vector atomics on the H100.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace scatter {

constexpr int kTileW = 32;  // one warp per tile row
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;

// dst[ch * so_c] += value(ch) for ch < c: one float4 or float2 atomic per
// aligned group of channels where the channel stride is 1, scalar otherwise.
template <typename F>
__device__ __forceinline__ void add_pixel(float* dst, int64_t c, int64_t so_c,
                                          F value) {
  int64_t ch = 0;
  if (so_c == 1) {
    for (; ch + 4 <= c && (reinterpret_cast<uintptr_t>(dst + ch) & 15) == 0;
         ch += 4) {
      atomicAdd(reinterpret_cast<float4*>(dst + ch),
                make_float4(value(ch), value(ch + 1), value(ch + 2),
                            value(ch + 3)));
    }
    for (; ch + 2 <= c && (reinterpret_cast<uintptr_t>(dst + ch) & 7) == 0;
         ch += 2) {
      atomicAdd(reinterpret_cast<float2*>(dst + ch),
                make_float2(value(ch), value(ch + 1)));
    }
  }
  for (; ch < c; ++ch) atomicAdd(dst + ch * so_c, value(ch));
}

// dst[ch * so_c] += s[ch] for ch < c <= S: a float4 atomic per group of 4
// where the channel stride is 1, c a multiple of 4 and dst 16 bytes aligned;
// float2 ones where c is even and dst 8 bytes aligned; else scalar ones.
template <int S>
__device__ __forceinline__ void add_sums(float* dst, int c, int64_t so_c,
                                         const float (&s)[S]) {
  static_assert(S % 4 == 0, "sums come in groups of 4");
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if (so_c == 1 && c % 4 == 0 && (a & 15) == 0) {
#pragma unroll
    for (int i = 0; i < S; i += 4) {
      if (i < c) {
        atomicAdd(reinterpret_cast<float4*>(dst + i),
                  make_float4(s[i], s[i + 1], s[i + 2], s[i + 3]));
      }
    }
  } else if (so_c == 1 && c % 2 == 0 && (a & 7) == 0) {
#pragma unroll
    for (int i = 0; i < S; i += 2) {
      if (i < c) {
        atomicAdd(reinterpret_cast<float2*>(dst + i),
                  make_float2(s[i], s[i + 1]));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (i < c) atomicAdd(dst + i * so_c, s[i]);
    }
  }
}

// What a thread does with its corners' sums: merge_corners decides it once
// per tile, merge_more applies it to the sums of further channels.
struct MergePlan {
  bool from_above;  // the upper corners take the lower sums of the thread above
  bool give_upper;  // the upper right corner goes to the next lane
  bool give_lower;  // the lower right corner goes to the next lane
  bool take_upper;  // the upper left corner takes the previous lane's
  bool take_lower;  // the lower left corner takes the previous lane's
};

// The tile's shared memory: each thread's lower corners (columns, row,
// which of them is live, their sums of S channels) for the thread below,
// and whether that thread took them.
template <int S>
struct MergeTile {
  int x0[kTileH][kTileW];
  int x1[kTileH][kTileW];
  int y1[kTileH][kTileW];
  float low[kTileH][2][S][kTileW];
  unsigned char low_live[kTileH][kTileW];
  bool taken[kTileH][kTileW];
};

template <int S>
__device__ __forceinline__ void publish_lower(MergeTile<S>& t,
                                              const float (&sum)[4][S]) {
#pragma unroll
  for (int i = 0; i < S; ++i) {
    t.low[threadIdx.y][0][i][threadIdx.x] = sum[2][i];
    t.low[threadIdx.y][1][i][threadIdx.x] = sum[3][i];
  }
}

template <int S>
__device__ __forceinline__ void take_from_above(const MergeTile<S>& t,
                                                float (&sum)[4][S]) {
#pragma unroll
  for (int i = 0; i < S; ++i) {
    sum[0][i] = __fadd_rn(sum[0][i], t.low[threadIdx.y - 1][0][i][threadIdx.x]);
    sum[1][i] = __fadd_rn(sum[1][i], t.low[threadIdx.y - 1][1][i][threadIdx.x]);
  }
}

// Every lane of the warp calls this (the shuffles take the full mask).
template <int S>
__device__ __forceinline__ void merge_columns(const MergePlan& p,
                                              float (&sum)[4][S]) {
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float up = __shfl_up_sync(0xffffffffu, sum[1][i], 1);
    const float low = __shfl_up_sync(0xffffffffu, sum[3][i], 1);
    if (p.take_upper) sum[0][i] = __fadd_rn(sum[0][i], up);
    if (p.take_lower) sum[2][i] = __fadd_rn(sum[2][i], low);
  }
}

// Merge the first S channels' sums of this thread's corners, at columns x0,
// x1 and rows y0, y1, with its neighbours' (see the head of this file), and
// update which corners are live: a corner that takes a live one becomes
// live, a corner handed on stops being. A thread that is not `keyed` (off
// the frame, or a source that lands nowhere) takes part in no merge; its
// sums must be 0. Every thread of the block calls this (two barriers).
template <int S>
__device__ __forceinline__ MergePlan merge_corners(MergeTile<S>& t, int x0,
                                                   int x1, int y0, int y1,
                                                   bool keyed,
                                                   float (&sum)[4][S],
                                                   bool (&live)[4]) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int key = keyed ? x0 : INT_MIN;
  t.x0[ty][tx] = key;
  t.x1[ty][tx] = x1;
  t.y1[ty][tx] = y1;
  t.low_live[ty][tx] = (live[2] ? 1 : 0) | (live[3] ? 2 : 0);
  t.taken[ty][tx] = false;
  publish_lower(t, sum);
  __syncthreads();
  MergePlan p;
  // rows: the lower corners of the thread above are this thread's upper ones
  p.from_above = ty > 0 && keyed && t.x0[ty - 1][tx] == x0 &&
                 t.x1[ty - 1][tx] == x1 && t.y1[ty - 1][tx] == y0;
  if (p.from_above) {
    take_from_above(t, sum);
    live[0] = live[0] || (t.low_live[ty - 1][tx] & 1) != 0;
    live[1] = live[1] || (t.low_live[ty - 1][tx] & 2) != 0;
    t.taken[ty - 1][tx] = true;
  }
  __syncthreads();
  const bool lower_taken = t.taken[ty][tx];
  if (lower_taken) live[2] = live[3] = false;
  // columns: this lane's right corners are the next lane's left ones
  const unsigned int full = 0xffffffffu;
  const int next_x0 = __shfl_down_sync(full, key, 1);
  const int next_y0 = __shfl_down_sync(full, y0, 1);
  const int next_y1 = __shfl_down_sync(full, y1, 1);
  const bool next_lower_taken =
      __shfl_down_sync(full, static_cast<int>(lower_taken), 1) != 0;
  const bool meets = tx < kTileW - 1 && keyed && next_x0 != INT_MIN &&
                     next_x0 == x1 && next_y0 == y0 && next_y1 == y1;
  p.give_upper = meets;
  p.give_lower = meets && !lower_taken && !next_lower_taken;
  p.take_upper =
      __shfl_up_sync(full, static_cast<int>(p.give_upper), 1) != 0 && tx > 0;
  p.take_lower =
      __shfl_up_sync(full, static_cast<int>(p.give_lower), 1) != 0 && tx > 0;
  const bool prev_upper_live =
      __shfl_up_sync(full, static_cast<int>(live[1]), 1) != 0;
  const bool prev_lower_live =
      __shfl_up_sync(full, static_cast<int>(live[3]), 1) != 0;
  merge_columns(p, sum);
  if (p.take_upper) live[0] = live[0] || prev_upper_live;
  if (p.take_lower) live[2] = live[2] || prev_lower_live;
  if (p.give_upper) live[1] = false;
  if (p.give_lower) live[3] = false;
  return p;
}

// merge_corners' plan applied to the sums of a further group of S channels.
// Every thread of the block calls this (two barriers).
template <int S>
__device__ __forceinline__ void merge_more(MergeTile<S>& t, const MergePlan& p,
                                           float (&sum)[4][S]) {
  __syncthreads();  // the thread below has read the previous group's sums
  publish_lower(t, sum);
  __syncthreads();
  if (p.from_above) take_from_above(t, sum);
  merge_columns(p, sum);
}

}  // namespace scatter
