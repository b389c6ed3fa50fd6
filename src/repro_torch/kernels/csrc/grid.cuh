// Grids sized to the card, for the kernels that stride over their work:
// at most the blocks of a kernel that fit on the card at once; and the
// helpers the persistent kernels share (coherent state loads, a block sum,
// a warp's or a block's append to a list, a lane group's min and ballot
// bits, the lanes a row takes).
#pragma once

#include <cstdint>
#include <mutex>
#include <type_traits>
#include <unordered_map>

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kThreads = 256;  // threads a block
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kFull = 0xFFFFFFFFu;  // every lane of a warp

template <int N>
using Int = std::integral_constant<int, N>;

// How a body reads the round state (T, M, the scratch, worklists, counts):
// plainly in a standalone pass, where nothing in the launch writes what it
// reads, so the compiler may take the read-only path; through L2 in a
// persistent kernel, where other blocks wrote it before the last grid sync
// (a volatile asm, so no load is cached or moved across a sync)
constexpr bool kPlain = false;
constexpr bool kCoherent = true;

template <bool kCoh, typename T>
__device__ __forceinline__ T state_load(const T* p) {
  static_assert(sizeof(T) == 4, "32-bit state words");
  if constexpr (kCoh) {
    uint32_t x;
    asm volatile("ld.global.cg.b32 %0, [%1];" : "=r"(x) : "l"(p));
    return static_cast<T>(x);
  } else {
    return *p;
  }
}

// x summed over the block's threads, on every thread; `words` is the
// block's shared [kWarps], free on entry and on return
__device__ __forceinline__ int32_t block_sum(int32_t x, int32_t* words) {
  x = __reduce_add_sync(kFull, x);
  if ((threadIdx.x & 31) == 0) words[threadIdx.x >> 5] = x;
  __syncthreads();
  int32_t s = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) s += words[k];
  __syncthreads();
  return s;
}

// x's minimum over the G lanes of its group (groups of G neighbouring
// lanes, G a power of two), on every lane of the group
template <int G>
__device__ __forceinline__ uint32_t group_min(uint32_t x) {
  if constexpr (G == 32) {
    return __reduce_min_sync(kFull, x);
  } else {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      const uint32_t y = __shfl_xor_sync(kFull, x, o);
      x = y < x ? y : x;
    }
    return x;
  }
}

// row appended to `list` (its length at *count) where `keep`: one
// atomicAdd a warp for its kept rows, which land side by side in lane
// order; every lane of the warp calls it
__device__ __forceinline__ void warp_append(bool keep, int32_t row,
                                            int32_t* list, int32_t* count) {
  const int lane = threadIdx.x & 31;
  const uint32_t bits = __ballot_sync(kFull, keep);
  int32_t pos = 0;
  if (lane == 0 && bits != 0u) pos = atomicAdd(count, __popc(bits));
  pos = __shfl_sync(kFull, pos, 0);
  if (keep) list[pos + __popc(bits & ((1u << lane) - 1u))] = row;
}

// row appended to `list` (its length at *count) where `keep`: one
// atomicAdd a block for its kept rows, which land side by side in thread
// order; every thread of the block calls it, `words` the block's shared
// [kWarps + 1], free on entry and on return
__device__ __forceinline__ void block_append(bool keep, int32_t row,
                                             int32_t* list, int32_t* count,
                                             int32_t* words) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t bits = __ballot_sync(kFull, keep);
  if (lane == 0) words[warp] = __popc(bits);
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = words[w];
      words[w] = total;
      total += c;
    }
    words[kWarps] = total != 0 ? atomicAdd(count, total) : 0;
  }
  __syncthreads();
  if (keep) {
    list[words[kWarps] + words[warp] + __popc(bits & ((1u << lane) - 1u))] =
        row;
  }
  __syncthreads();
}

// the ballot bits of group grp's lanes
template <int G>
__device__ __forceinline__ uint32_t group_bits(int grp) {
  if constexpr (G == 32) {
    return kFull;
  } else {
    return ((1u << G) - 1u) << (grp * G);
  }
}

// G, the lanes a row of d slots takes: the smallest power of two, at most
// 32, that leaves a lane at most `lane_slots` of them
inline int row_lanes(int d, int lane_slots) {
  int g = 1;
  while (g < 32 && g * lane_slots < d) g <<= 1;
  return g;
}

// G for a map of r such rows: doubled from row_lanes while r * G is short
// of `fill_lanes` and each lane keeps two slots of a row at least
inline int filled_row_lanes(int d, int64_t r, int lane_slots,
                            int64_t fill_lanes) {
  int g = row_lanes(d, lane_slots);
  while (g < 32 && 4 * g <= d && r * g < fill_lanes) g <<= 1;
  return g;
}

// f(Int<G>{}) for g lanes a row (a power of two, at most 32)
template <typename F>
__device__ __forceinline__ void with_lanes(int g, F&& f) {
  switch (g) {
    case 1: return f(Int<1>{});
    case 2: return f(Int<2>{});
    case 4: return f(Int<4>{});
    case 8: return f(Int<8>{});
    case 16: return f(Int<16>{});
    default: return f(Int<32>{});
  }
}

// the blocks of `kernel` that fit on the current card at once, asked once
template <typename Kernel>
int resident_blocks(Kernel kernel) {
  static std::mutex mu;
  static std::unordered_map<const void*, int> cache;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) return hit->second;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  cache.emplace(key, blocks);
  return blocks;
}

// blocks for `slots` worklist slots or vertices, `per_block` of them a
// block, at most the blocks that fit on the card (the rest are strided
// over)
template <typename Kernel>
int grid_for(Kernel kernel, int64_t slots, int64_t per_block) {
  const int64_t need = (slots + per_block - 1) / per_block;
  const int fit = resident_blocks(kernel);
  return need < fit ? static_cast<int>(need) : fit;
}

}  // namespace repro_torch
