// Per-round priorities of the Luby coloring: xorshift64* of each id,
// packed with the id into one status word.
//
// Replaces repro/kernels/hash_priority/kernel.py:hash_pack_pallas.  The TPU
// kernel emulated the 64-bit hash on uint32 limb pairs; Hopper has native
// 64-bit integers, and the math is the one the fused MIS-2 kernels inline
// (hash.cuh).  The round number lives on the device, so the coloring loop
// needs no host value to launch.
//
// One body, three forms fixed at compile time:
// - hash_pack (kWords): the TPU kernel's signature, ids read, uint32 words
//   written (stored by torch as int32 bit patterns);
// - round_priorities (kIota): the coloring's, the id is the index i itself
//   (nothing read), and the word is written zero-extended to int64, the
//   widened form the coloring's round compares, so no widening pass
//   follows;
// - round_priorities_batched (kBatched): the batched coloring's, a bucket
//   of B graphs of `rows` (a power of two) rows each laid end to end: index
//   i is member i >> log_rows's vertex i & (rows - 1), packed with that
//   member's own id bits (bits[i >> log_rows], read from a [B] array that
//   stays in L1), the round shared.  The iota form's words, member by
//   member.
//
// Bound: memory, barely.  Per id 4 B read (none in the iota form) and 4 or
// 8 B written; the tuple is 33 SASS instructions once the round's f(it + 1)
// is hoisted out of the loop (RoundPriority), which at V = 1M is 2.0 us of
// the card's INT32 issue against 2.4 us for the 8 MB of either form.  So
// the design spends no instruction it can drop: f(it + 1) once a thread, a
// grid sized to the card (grid_for, grid.cuh), and 4 ids a step of its
// grid-stride loop with 16-byte loads and stores.  The steps need the
// pointers 16-byte aligned (ids and out; out alone in the int64 forms);
// where they are not (a slice such as ids[1:]), every id is taken one at
// a time, as are the ids past the last whole step.  The batched form's
// steps also need rows >= 2, so that each pair (i, i + 1), i even, lies in
// one member and takes one member's bits.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "grid.cuh"
#include "hash.cuh"

namespace repro_torch {
namespace {

constexpr int kStep = 4;               // ids a thread takes a step
constexpr int kWarpStep = 32 * kStep;  // ids a warp takes a step

enum Form { kWords, kIota, kBatched };

template <int F>
using Word = std::conditional_t<F == kWords, uint32_t, uint64_t>;

// The id hashed at index i and its id bits in the int64 forms: i and the
// kernel's b (kIota), or member i >> log_rows's local id and bits
// (kBatched).
template <int F>
struct IndexIds {
  const uint32_t* bits;  // kBatched: [B]
  int log_rows;          // kBatched: log2(rows)

  __device__ __forceinline__ uint32_t id(int64_t i) const {
    if constexpr (F == kBatched) {
      return static_cast<uint32_t>(i & ((int64_t{1} << log_rows) - 1));
    }
    return static_cast<uint32_t>(i);
  }
  __device__ __forceinline__ int id_bits(int64_t i, int b) const {
    if constexpr (F == kBatched) return static_cast<int>(bits[i >> log_rows]);
    return b;
  }
};

// out[i] = pack(h(it, id), id, b), id = ids[i] (kWords) or as IndexIds
// gives it.  With `vector`, whole steps of kStep ids first: in the word
// form 4 consecutive ids (one 16-byte load and store); in the int64 forms
// two pairs 64 ids apart in the warp's kWarpStep, so that each of its two
// 16-byte stores covers 512 contiguous bytes of the warp (4 consecutive
// int64 words a thread would leave every store instruction writing half of
// each sector).
template <int F>
__global__ void __launch_bounds__(kThreads) hash_pack_kernel(
    const uint32_t* __restrict__ ids, const uint32_t* __restrict__ it_ptr,
    Word<F>* __restrict__ out, int64_t n, int b, bool vector,
    IndexIds<F> index) {
  const RoundPriority<kXorshiftStar> round(*it_ptr);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  // the stride is whole warps, so step s is taken by lane s % 32
  const int64_t steps =
      !vector ? 0 : F != kWords ? n / kWarpStep * 32 : n / kStep;
  for (int64_t s = t; s < steps; s += stride) {
    // __stwb: one 16-byte store with the default write-back policy (an
    // assigned uint4 compiled to four 4-byte stores)
    if constexpr (F != kWords) {
      const int64_t i = (s >> 5) * kWarpStep + 2 * (s & 31);
      const int64_t j = i + kWarpStep / 2;  // the second pair
      const uint32_t v = index.id(i);
      const uint32_t w = index.id(j);
      const int bv = index.id_bits(i, b);
      const int bw = index.id_bits(j, b);
      __stwb(reinterpret_cast<ulonglong2*>(out + i),
             make_ulonglong2(round.tuple(v, bv), round.tuple(v + 1, bv)));
      __stwb(reinterpret_cast<ulonglong2*>(out + j),
             make_ulonglong2(round.tuple(w, bw), round.tuple(w + 1, bw)));
    } else {
      const int64_t i = s * kStep;
      const uint4 v = *reinterpret_cast<const uint4*>(ids + i);
      __stwb(reinterpret_cast<uint4*>(out + i),
             make_uint4(round.tuple(v.x, b), round.tuple(v.y, b),
                        round.tuple(v.z, b), round.tuple(v.w, b)));
    }
  }
  // the ids past the last whole step (every id without `vector`)
  const int64_t done = F != kWords ? steps / 32 * kWarpStep : steps * kStep;
  for (int64_t i = done + t; i < n; i += stride) {
    if constexpr (F == kWords) {
      out[i] = round.tuple(ids[i], b);
    } else {
      out[i] = round.tuple(index.id(i), index.id_bits(i, b));
    }
  }
}

// `id_bits` and `log_rows`: the members' [B] bits and log2(rows) of the
// batched form (null and 0 in the others, which pack with b)
template <int F>
int launch(const void* ids, const void* it, void* out, int64_t n, int b,
           const void* id_bits, int log_rows, void* stream) {
  if (n > 0) {
    auto k = hash_pack_kernel<F>;
    const auto addr = reinterpret_cast<uintptr_t>(out) |
                      (F == kWords ? reinterpret_cast<uintptr_t>(ids) : 0);
    const bool vector =
        addr % 16 == 0 && (F != kBatched || log_rows >= 1);
    // a thread a step, or an id
    const int64_t units = vector ? (n + kStep - 1) / kStep : n;
    const IndexIds<F> index{static_cast<const uint32_t*>(id_bits), log_rows};
    k<<<grid_for(k, units, kThreads), kThreads, 0,
        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(ids), static_cast<const uint32_t*>(it),
        static_cast<Word<F>*>(out), n, b, vector, index);
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
  return repro_torch::launch<repro_torch::kWords>(ids, it, out, n, b,
                                                  nullptr, 0, stream);
}

// out[i] = pack(h(it, i), i, b) as int64 words (the uint32 word
// zero-extended), i in [0, n): the coloring's round, nothing read
int round_priorities(const void* it, void* out, int64_t n, int b,
                     void* stream) {
  return repro_torch::launch<repro_torch::kIota>(nullptr, it, out, n, b,
                                                 nullptr, 0, stream);
}

// out[i] = pack(h(it, i & (rows - 1)), i & (rows - 1), bits[i >> log_rows])
// as int64 words, rows = 1 << log_rows, i in [0, n): the batched coloring's
// round, round_priorities of each member of a bucket laid end to end
int round_priorities_batched(const void* bits, const void* it, void* out,
                             int64_t n, int log_rows, void* stream) {
  return repro_torch::launch<repro_torch::kBatched>(nullptr, it, out, n, 0,
                                                    bits, log_rows, stream);
}

}  // extern "C"
