// The ordered compaction of a worklist over itself, in a persistent
// kernel: what the previous list's slots keep, in their order, then the
// sentinel up to the slots the buffer held live before -- slot for slot
// the cumsum compaction of the kept rows over [V] (core/mis2.py:
// compact_worklist), without a [V] scan.  Each block filters a contiguous
// chunk of the previous list and counts what it keeps (count_kept); after
// a grid sync each block sums the counts of the blocks before it and
// writes its survivors from there (write_kept).  `keep` is evaluated once
// a slot in each half, by the same thread, so it may settle the row's
// state on the first evaluation as long as the second gives the same
// answer.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "grid.cuh"

namespace repro_torch {

// this block's contiguous chunk [lo, hi) of n list slots
__device__ __forceinline__ void block_chunk(int64_t n, int64_t& lo,
                                            int64_t& hi) {
  const int64_t per = (n + gridDim.x - 1) / gridDim.x;
  lo = per * blockIdx.x < n ? per * blockIdx.x : n;
  hi = lo + per < n ? lo + per : n;
}

// the row at slot i of a previous list (`prev` null: the identity, row i)
__device__ __forceinline__ int32_t list_row(const int32_t* prev, int64_t i) {
  return prev != nullptr ? state_load<kCoherent>(prev + i)
                         : static_cast<int32_t>(i);
}

// Compaction, first half: the rows this block keeps (`keep(row)`) of its
// chunk of the previous list's n slots, to bc[blockIdx.x]
template <typename Keep>
__device__ __forceinline__ void count_kept(const int32_t* prev, int64_t n,
                                           Keep keep, int32_t* bc,
                                           int32_t* words) {
  int64_t lo, hi;
  block_chunk(n, lo, hi);
  int32_t c = 0;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    c += keep(list_row(prev, i)) ? 1 : 0;
  }
  c = block_sum(c, words);
  if (threadIdx.x == 0) bc[blockIdx.x] = c;
}

// Compaction, second half (after a grid sync): this block's kept rows, in
// order, at the sum of the earlier blocks' counts in `next`; the sentinel
// from the new count up to `stale`, the slots `next` held live before; the
// new count to *count
template <typename Keep>
__device__ __forceinline__ void write_kept(const int32_t* prev, int64_t n,
                                           Keep keep, const int32_t* bc,
                                           int32_t* next, int32_t* count,
                                           int64_t stale, int32_t sentinel,
                                           int32_t* words) {
  int32_t before = 0, total = 0;
  for (int j = threadIdx.x; j < static_cast<int>(gridDim.x); j += kThreads) {
    const int32_t c = state_load<kCoherent>(bc + j);
    total += c;
    before += j < static_cast<int>(blockIdx.x) ? c : 0;
  }
  int64_t pos = block_sum(before, words);
  total = block_sum(total, words);
  int64_t lo, hi;
  block_chunk(n, lo, hi);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int64_t base = lo; base < hi; base += kThreads) {  // block-uniform
    const int64_t i = base + threadIdx.x;
    const int32_t row = i < hi ? list_row(prev, i) : 0;
    const bool kp = i < hi && keep(row);
    const uint32_t bits = __ballot_sync(kFull, kp);
    if (lane == 0) words[warp] = __popc(bits);
    __syncthreads();
    int32_t at = 0, tile = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? words[w] : 0;
      tile += words[w];
    }
    __syncthreads();
    if (kp) next[pos + at + __popc(bits & ((1u << lane) - 1u))] = row;
    pos += tile;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = total + static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       i < stale; i += stride) {
    next[i] = sentinel;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *count = total;
}

}  // namespace repro_torch
