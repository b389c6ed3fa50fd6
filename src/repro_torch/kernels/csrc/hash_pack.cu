// Per-round priorities of the Luby coloring: xorshift64* of each id,
// packed with the id into one status word.
//
// Replaces repro/kernels/hash_priority/kernel.py:hash_pack_pallas.  The TPU
// kernel emulated the 64-bit hash on uint32 limb pairs; Hopper has native
// 64-bit integers, and the math is the one the fused MIS-2 kernels inline
// (hash.cuh).  The round number lives on the device, so the coloring loop
// needs no host value to launch.
//
// One body, two forms fixed at compile time:
// - hash_pack: the TPU kernel's signature, ids read, uint32 words written
//   (stored by torch as int32 bit patterns);
// - round_priorities (kIota): the coloring's, the id is the index i itself
//   (nothing read), and the word is written zero-extended to int64, the
//   widened form the coloring's round compares, so no widening pass
//   follows.
//
// Bound: memory, barely.  Per id 4 B read (none in the iota form) and 4 or
// 8 B written; the tuple is 33 SASS instructions once the round's f(it + 1)
// is hoisted out of the loop (RoundPriority), which at V = 1M is 2.0 us of
// the card's INT32 issue against 2.4 us for the 8 MB of either form.  So
// the design spends no instruction it can drop: f(it + 1) once a thread, a
// grid sized to the card (grid_for, grid.cuh), and 4 ids a step of its
// grid-stride loop with 16-byte loads and stores.  The steps need the
// pointers 16-byte aligned (ids and out; out alone in the iota form);
// where they are not (a slice such as ids[1:]), every id is taken one at
// a time, as are the ids past the last whole step.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "grid.cuh"
#include "hash.cuh"

namespace repro_torch {
namespace {

constexpr int kStep = 4;               // ids a thread takes a step
constexpr int kWarpStep = 32 * kStep;  // ids a warp takes a step

template <bool kIota>
using Word = std::conditional_t<kIota, uint64_t, uint32_t>;

// out[i] = pack(h(it, id), id, b), id = ids[i] (or i, kIota).  With
// `vector`, whole steps of kStep ids first: in the word form 4 consecutive
// ids (one 16-byte load and store); in the iota form two pairs 64 ids apart
// in the warp's kWarpStep, so that each of its two 16-byte stores covers
// 512 contiguous bytes of the warp (4 consecutive int64 words a thread
// would leave every store instruction writing half of each sector).
template <bool kIota>
__global__ void __launch_bounds__(kThreads) hash_pack_kernel(
    const uint32_t* __restrict__ ids, const uint32_t* __restrict__ it_ptr,
    Word<kIota>* __restrict__ out, int64_t n, int b, bool vector) {
  const RoundPriority<kXorshiftStar> round(*it_ptr);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  // the stride is whole warps, so step s is taken by lane s % 32
  const int64_t steps = !vector ? 0 : kIota ? n / kWarpStep * 32 : n / kStep;
  for (int64_t s = t; s < steps; s += stride) {
    // __stwb: one 16-byte store with the default write-back policy (an
    // assigned uint4 compiled to four 4-byte stores)
    if constexpr (kIota) {
      const int64_t i = (s >> 5) * kWarpStep + 2 * (s & 31);
      const int64_t j = i + kWarpStep / 2;  // the second pair
      const auto v = static_cast<uint32_t>(i);
      const auto w = static_cast<uint32_t>(j);
      __stwb(reinterpret_cast<ulonglong2*>(out + i),
             make_ulonglong2(round.tuple(v, b), round.tuple(v + 1, b)));
      __stwb(reinterpret_cast<ulonglong2*>(out + j),
             make_ulonglong2(round.tuple(w, b), round.tuple(w + 1, b)));
    } else {
      const int64_t i = s * kStep;
      const uint4 v = *reinterpret_cast<const uint4*>(ids + i);
      __stwb(reinterpret_cast<uint4*>(out + i),
             make_uint4(round.tuple(v.x, b), round.tuple(v.y, b),
                        round.tuple(v.z, b), round.tuple(v.w, b)));
    }
  }
  // the ids past the last whole step (every id without `vector`)
  const int64_t done = kIota ? steps / 32 * kWarpStep : steps * kStep;
  for (int64_t i = done + t; i < n; i += stride) {
    out[i] = round.tuple(kIota ? static_cast<uint32_t>(i) : ids[i], b);
  }
}

template <bool kIota>
int launch(const void* ids, const void* it, void* out, int64_t n, int b,
           void* stream) {
  if (n > 0) {
    auto k = hash_pack_kernel<kIota>;
    const auto bits = reinterpret_cast<uintptr_t>(out) |
                      (kIota ? 0 : reinterpret_cast<uintptr_t>(ids));
    const bool vector = bits % 16 == 0;
    // a thread a step, or an id
    const int64_t units = vector ? (n + kStep - 1) / kStep : n;
    k<<<grid_for(k, units, kThreads), kThreads, 0,
        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(ids), static_cast<const uint32_t*>(it),
        static_cast<Word<kIota>*>(out), n, b, vector);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// out[i] = pack(h(it, ids[i]), ids[i], b) as uint32 words: the TPU
// kernel's signature
int hash_pack(const void* ids, const void* it, void* out, int64_t n, int b,
              void* stream) {
  return repro_torch::launch<false>(ids, it, out, n, b, stream);
}

// out[i] = pack(h(it, i), i, b) as int64 words (the uint32 word
// zero-extended), i in [0, n): the coloring's round, nothing read
int round_priorities(const void* it, void* out, int64_t n, int b,
                     void* stream) {
  return repro_torch::launch<true>(nullptr, it, out, n, b, stream);
}

}  // extern "C"
