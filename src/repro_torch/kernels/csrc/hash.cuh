// Status-tuple packing and the §V-A priority hash, as device functions.
//
// Port of repro/core/hashing.py and repro/core/tuples.py (and of the
// Pallas kernel repro/kernels/hash_priority/kernel.py:hash_pack_pallas,
// whose math the fused MIS-2 kernels inline).  The TPU emulated the
// 64-bit words on uint32 limb pairs; Hopper has native 64-bit integers.
#pragma once

#include <cstdint>

namespace repro_torch {

constexpr uint32_t kIn = 0u;
constexpr uint32_t kOut = 0xFFFFFFFFu;

// priority kinds, as PRIORITY_CODES in core/hashing.py
constexpr int kXorshiftStar = 0;
constexpr int kXorshift = 1;
constexpr int kFixed = 2;

__device__ __forceinline__ uint64_t xorshift64(uint64_t x) {
  x ^= x << 13;
  x ^= x >> 7;
  x ^= x << 17;
  return x;
}

__device__ __forceinline__ uint64_t xorshift64_star(uint64_t x) {
  x ^= x >> 12;
  x ^= x << 25;
  x ^= x >> 27;
  return x * 0x2545F4914F6CDD1DULL;
}

// h(it, v) = f(f(it + 1) ^ f(v + 1)), high 32 bits
__device__ __forceinline__ uint32_t priority_hash(int kind, uint32_t it,
                                                  uint32_t v) {
  const uint64_t a = static_cast<uint32_t>((kind == kFixed ? 0u : it) + 1u);
  const uint64_t x = static_cast<uint32_t>(v + 1u);
  const uint64_t h = kind == kXorshift
      ? xorshift64(xorshift64(a) ^ xorshift64(x))
      : xorshift64_star(xorshift64_star(a) ^ xorshift64_star(x));
  return static_cast<uint32_t>(h >> 32);
}

// (priority' << b) | (id + 1), priority' = the high 32 - b hash bits; b < 32
__device__ __forceinline__ uint32_t pack_tuple(uint32_t priority, uint32_t v,
                                               int b) {
  return ((priority >> b) << b) | (v + 1u);
}

__device__ __forceinline__ bool is_undecided(uint32_t t) {
  return t != kIn && t != kOut;
}

// the §V-A row refresh: an undecided tuple takes this round's priority
__device__ __forceinline__ uint32_t refresh(uint32_t t, uint32_t v, int kind,
                                            uint32_t it, int b) {
  return is_undecided(t) ? pack_tuple(priority_hash(kind, it, v), v, b) : t;
}

template <int Kind>
__device__ __forceinline__ uint64_t mix(uint64_t x) {
  return Kind == kXorshift ? xorshift64(x) : xorshift64_star(x);
}

// One round's §V-A tuples for one priority kind, fixed at compile time:
// f(it + 1) is computed once, so a tuple costs two f's, not three.
// tuple(v, b) == pack_tuple(priority_hash(Kind, it, v), v, b).  The kind
// argument is read only by the kAnyKind form below.
template <int Kind>
struct RoundPriority {
  uint64_t fa;

  __device__ __forceinline__ explicit RoundPriority(uint32_t it, int = Kind)
      : fa(mix<Kind>(static_cast<uint32_t>((Kind == kFixed ? 0u : it) + 1u))) {}

  __device__ __forceinline__ uint32_t tuple(uint32_t v, int b) const {
    const uint64_t h = mix<Kind>(fa ^ mix<Kind>(static_cast<uint32_t>(v + 1u)));
    return pack_tuple(static_cast<uint32_t>(h >> 32), v, b);
  }
};

// The same tuples with the kind read at run time, for a kernel that serves
// every kind from one instance: each f is a branch on a value every thread
// shares, so one kind's code runs.
constexpr int kAnyKind = -1;

__device__ __forceinline__ uint64_t mix_any(int kind, uint64_t x) {
  return kind == kXorshift ? xorshift64(x) : xorshift64_star(x);
}

template <>
struct RoundPriority<kAnyKind> {
  uint64_t fa;
  int kind;

  __device__ __forceinline__ RoundPriority(uint32_t it, int k)
      : fa(mix_any(k, static_cast<uint32_t>((k == kFixed ? 0u : it) + 1u))),
        kind(k) {}

  __device__ __forceinline__ uint32_t tuple(uint32_t v, int b) const {
    const uint64_t h =
        mix_any(kind, fa ^ mix_any(kind, static_cast<uint32_t>(v + 1u)));
    return pack_tuple(static_cast<uint32_t>(h >> 32), v, b);
  }
};

// this round's tuple of an undecided vertex v, the kind read at run time
// (a branch on a value every thread shares, so one kind's code runs)
__device__ __forceinline__ uint32_t fresh_tuple(int kind, uint32_t it,
                                                uint32_t v, int b) {
  switch (kind) {
    case kXorshift:
      return RoundPriority<kXorshift>(it).tuple(v, b);
    case kFixed:
      return RoundPriority<kFixed>(it).tuple(v, b);
    default:
      return RoundPriority<kXorshiftStar>(it).tuple(v, b);
  }
}

// A bucket of graphs laid end to end, each over `1 << shift` rows: vertex
// v is member v >> shift's local id v & (rows - 1), hashed and packed with
// that member's bits[v >> shift] (its own id_bits), so every member's
// tuples are its single-graph ones.  `bits` null: one graph, each vertex
// its own id packed with the kernel's b (a branch on a value every thread
// shares; with the default argument it folds away).
struct Members {
  const int32_t* bits = nullptr;
  int shift = 0;
};

template <class P>
__device__ __forceinline__ uint32_t tuple_of(const P& prio, uint32_t v, int b,
                                             const Members& mem) {
  if (mem.bits == nullptr) return prio.tuple(v, b);
  return prio.tuple(v & ((1u << mem.shift) - 1u), mem.bits[v >> mem.shift]);
}

__device__ __forceinline__ uint32_t fresh_of(int kind, uint32_t it,
                                             uint32_t v, int b,
                                             const Members& mem) {
  if (mem.bits == nullptr) return fresh_tuple(kind, it, v, b);
  return fresh_tuple(kind, it, v & ((1u << mem.shift) - 1u),
                     mem.bits[v >> mem.shift]);
}

}  // namespace repro_torch
