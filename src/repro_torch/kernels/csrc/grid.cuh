// Grids sized to the card, for the kernels that stride over their work:
// at most the blocks of a kernel that fit on the card at once.
#pragma once

#include <cstdint>
#include <mutex>
#include <unordered_map>

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kThreads = 256;  // threads a block

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
