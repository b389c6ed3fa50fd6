// Per-round priorities of the Luby coloring: xorshift64* of each id,
// packed with the id into one status word.
//
// Replaces repro/kernels/hash_priority/kernel.py:hash_pack_pallas.  The TPU
// kernel emulated the 64-bit hash on uint32 limb pairs; Hopper has native
// 64-bit integers, and the math is the one the fused MIS-2 kernels inline
// (hash.cuh).  ids and out are uint32 words (torch stores them as int32
// bit patterns); the round number lives on the device, so the coloring
// loop needs no host value to launch.
//
// Bound: memory (4 B read and 4 B written per id; the hash is ~20 integer
// operations, far below the card's integer rate per byte).  One thread per
// id, coalesced.
#include <cstdint>

#include <cuda_runtime.h>

#include "hash.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

__global__ void hash_pack_kernel(const uint32_t* __restrict__ ids,
                                 const uint32_t* __restrict__ it_ptr,
                                 uint32_t* __restrict__ out, int64_t n,
                                 int b) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t v = ids[i];
  out[i] = pack_tuple(priority_hash(kXorshiftStar, *it_ptr, v), v, b);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

int hash_pack(const void* ids, const void* it, void* out, int64_t n, int b,
              void* stream) {
  using namespace repro_torch;
  if (n > 0) {
    hash_pack_kernel<<<static_cast<int>((n + kThreads - 1) / kThreads),
                       kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(ids), static_cast<const uint32_t*>(it),
        static_cast<uint32_t*>(out), n, b);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
