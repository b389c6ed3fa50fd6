// The segment reduction over the hybrid layout's COO spill, as the
// persistent kernels run it inside a round: the entries, not the heavy
// rows, spread evenly over the warps (a hub row of Powerlaw_1M holds 24,065
// of them), each warp's partials combined into [H] scratch with one atomic
// per chunk and segment.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "grid.cuh"

namespace repro_torch {

// a 32-bit word moved between the lanes of a full warp; a kernel whose
// partials are wider overloads these two for its own type
__device__ __forceinline__ uint32_t lane_up(uint32_t x, int o) {
  return __shfl_up_sync(kFull, x, o);
}

__device__ __forceinline__ uint32_t lane_of(uint32_t x, int src) {
  return __shfl_sync(kFull, x, src);
}

// this warp's chunk [lo, hi) of n entries: the warps' chunks, a multiple of
// 32 entries each, cover [0, n) in order
__device__ __forceinline__ void warp_chunk(int64_t n, int64_t& lo,
                                           int64_t& hi) {
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t per = ((n + warps - 1) / warps + 31) & ~int64_t{31};
  lo = warp * per < n ? warp * per : n;
  hi = lo + per < n ? lo + per : n;
}

// Each warp reduces its chunk of the e entries by segment (seg_of[i], sorted
// ascending) with `op`, 32 entries a step: an inclusive segmented scan by
// shuffles, the run at lane 31 carried to the next step.  Each (segment,
// partial) reaches `flush` once per chunk, on one lane.  `val(i, seg)`:
// entry i's term, or `identity`.  Every lane of the warp must call it (the
// loop bounds are the warp's).
template <typename T, typename Op, typename Val, typename Flush>
__device__ __forceinline__ void segment_reduce_warp(const int32_t* seg_of,
                                                    int64_t e, T identity,
                                                    Op op, Val val,
                                                    Flush flush) {
  int64_t lo, hi;
  warp_chunk(e, lo, hi);
  const int lane = threadIdx.x & 31;
  int32_t cseg = -1;
  T cval = identity;
  for (int64_t base = lo; base < hi; base += 32) {       // warp-uniform
    const int64_t i = base + lane;
    const bool valid = i < hi;
    const int32_t sg = valid ? seg_of[i] : -1;
    T x = valid ? val(i, sg) : identity;
    if (lane == 0 && cseg >= 0) {
      if (sg == cseg) {
        x = op(x, cval);
      } else {
        flush(cseg, cval);
      }
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = lane_up(x, o);
      const int32_t ys = __shfl_up_sync(kFull, sg, o);
      if (lane >= o && ys == sg) x = op(x, y);
    }
    const int32_t next = __shfl_down_sync(kFull, sg, 1);
    if (valid && lane < 31 && next != sg) flush(sg, x);
    cseg = __shfl_sync(kFull, sg, 31);
    cval = lane_of(x, 31);
  }
  if (lane == 0 && cseg >= 0) flush(cseg, cval);
}

}  // namespace repro_torch
