// The Luby distance-1 coloring's whole round loop in one cooperative
// launch, over the padded ELL or over the hybrid layout (sliced ELL slabs
// and the COO spill).
//
// It replaces the reference's two jitted lax.while_loops,
// repro/core/coloring.py:_color_fixed_point and
// :_color_fixed_point_hybrid (no Pallas kernel of their own: XLA ran the
// rowwise round, and the priorities are hash_pack_pallas's arithmetic,
// repro/kernels/hash_priority/kernel.py:31), which the port ran as one
// hash-pack launch, a plain-torch round (with one OR launch a slot, torch
// having no OR reduction) and a blocking read of a flag a round.  Their
// do-while shape is kept: one round at least, then on while a vertex is
// uncolored and fewer than max_rounds rounds ran; the round lives in a
// register and the host reads nothing until the loop ends.
//
// A round, for every row still in play: the row is a contender minimum if
// its packed priority is below every uncolored real neighbour's (real:
// mask set and not the row itself; compared as uint32), and then takes the
// smallest color no colored real neighbour holds (a 64-bit forbidden mask,
// two words, kept in registers).  Where all 64 colors are forbidden the
// reference's float32-exponent lowest-set-bit gives -127 + 32 = -95, and
// so does this kernel: the row is written -95 and stays uncolored.  Round
// rnd's priority of vertex i is pack(xorshift64*(rnd, i), i, id_bits(V)),
// hash.cuh's RoundPriority, bit for bit hash_pack.cu's round_priorities.
//
// Every read comes from the round-start colors: two [V] buffers, the round
// reading one and writing the other.  Each slab keeps a worklist of the
// rows uncolored at the start of the previous round (round 0: every row,
// no list read): a row colored in round r is still on round r + 1's list,
// which copies its color into the other buffer, and leaves it after; a row
// colored before gives its own color, so skipping it changes no bit.  The
// list is compacted in the same pass (a warp reserves its slots with one
// atomicAdd; the order of a list changes nothing), and the uncolored rows
// are counted into a per-round counter, three of each rotating by round so
// that a counter is reset a round before it is used.  The spill's heavy
// rows are reduced over their entries as the MIS-2 kernel reduces them
// (spill.cuh: the contender minimum with atomicMin, the two forbidden words
// with atomicOr into [H] scratch), then finished per heavy row after a grid
// sync.  One grid sync a round, two with a spill; at the end the colors are
// copied into buffer 0 if the last round wrote buffer 1.
//
// A bucket of graphs (the batched coloring: it replaces the host loop of
// src/repro/batch/pipeline.py:123-161, which reads the colors back every
// round) is one padded ELL of member after member, block-diagonal: each
// row hashes its member-local id with
// its member's bits (hash.cuh's Members), the padded rows enter colored 0
// (never contenders, nobody's neighbour), and the round is shared, as the
// reference's vmapped round takes it.  Member j's done round, the round
// after which its rows were all colored (-1 if it never was), is the
// largest round + 1 in which one of its rows took a color: the rows a warp
// colors in a round are grouped by member (__match_any_sync) and each
// group's leader takes an atomicMax, one a member a warp at most; after
// the loop every row still uncolored sets its member's to -1.  The bucket
// is an instance of its own (kBucket), so the single-graph loops pay no
// branch for the member map (on an H100 the branch cost the E60 loop 6%,
// tools/bench_resident.py against a build without the map in one call).
//
// Priorities are hashed inline, one hash per uncolored real neighbour slot
// and one per row: on an H100 that beat hashing every row in play once a
// round into a [V] scratch, by a pass and a grid sync before the round, on
// every graph measured (PERF.md).
//
// Bound: memory.  A row in play reads its list slot, its own color, its D
// ids and mask bytes and the color of every real neighbour (an L2 sector
// each at a power-law graph's random ids), and writes its color.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "grid.cuh"
#include "hash.cuh"
#include "spill.cuh"

namespace repro_torch {
namespace {

namespace cg = cooperative_groups;

// Tuning constants (tools/bench_resident.py builds variants of them).
constexpr int kLaneSlots = 16;       // a row's slots a lane may take (picks G)
// lanes a slab's rows should reach, G raised until R * G does
constexpr int64_t kFillLanes = 1048576;
constexpr int kLubyMinBlocks = 4;    // blocks an SM must hold (register cap)

constexpr uint32_t kNoContender = 0xFFFFFFFFu;  // no packed priority is this
constexpr int32_t kAllForbidden = -127 + 32;    // the reference's -95

// One row map, a row of the [S, 7] int64 table the wrapper builds once per
// layout: a slab's global row ids (0 for the padded ELL, whose row is its
// vertex), its [R * D] ids and mask bytes (device pointers), R, D, its G
// lanes a row (luby_lanes) and the offset of its list's two buffers ([R]
// each) in the solve's list storage
struct LubyMap {
  int64_t rows;
  int64_t nbrs;
  int64_t mask;
  int64_t r;
  int64_t d;
  int64_t g;
  int64_t wl;
};

struct MapView {
  const int32_t* rows;
  const int32_t* nbrs;
  const uint8_t* mask;
  int32_t* wl[2];
  int64_t r;
  int d;
  int g;
};

// The solve's buffers.  colors: [2 * V], the two buffers; hmin, hforb: [H]
// and [2 * H] per heavy row, the contender minimum and the forbidden words;
// counts[3 * s + k]: map s's list length, k = round % 3 (the list a round
// reads), (round + 1) % 3 (the one it writes); uncolored[k]: the rows left
// uncolored by round k - 1; out: the rounds run.  A bucket (mem.bits
// set) also has its rows' valid bytes and writes done[members].
struct Luby {
  const LubyMap* maps;
  int32_t* lists;
  const int32_t* spill_rows;
  const int32_t* spill_seg;
  const int32_t* spill_cols;
  int32_t* colors;
  uint32_t* hmin;
  uint32_t* hforb;
  int32_t* counts;
  int32_t* uncolored;
  int32_t* out;
  int64_t v;
  int64_t h;
  int64_t e;
  int num_maps;
  int b;
  int max_rounds;
  Members mem;
  const uint8_t* valid;        // [V], null: every row (a bucket's padding)
  int32_t* done;               // [members], a bucket's done rounds
  int64_t members;
};

__device__ __forceinline__ MapView map_view(const Luby& r, int s) {
  const LubyMap& x = r.maps[s];
  MapView m;
  m.rows = reinterpret_cast<const int32_t*>(x.rows);
  m.nbrs = reinterpret_cast<const int32_t*>(x.nbrs);
  m.mask = reinterpret_cast<const uint8_t*>(x.mask);
  m.r = x.r;
  m.d = static_cast<int>(x.d);
  m.g = static_cast<int>(x.g);
  m.wl[0] = r.lists + x.wl;
  m.wl[1] = r.lists + x.wl + x.r;
  return m;
}

// G: the smallest power of two, at most 32, that leaves a lane at most
// kLaneSlots of a row's d slots, doubled while R * G is short of
// kFillLanes and each lane keeps two slots of a row at least
int luby_lanes(int d, int64_t r) {
  return filled_row_lanes(d, r, kLaneSlots, kFillLanes);
}

// the smallest color clear in the forbidden words, -95 where none is
__device__ __forceinline__ int32_t smallest_free(uint32_t lo, uint32_t hi) {
  if (~lo != 0u) return __ffs(static_cast<int>(~lo)) - 1;
  if (~hi != 0u) return __ffs(static_cast<int>(~hi)) - 1 + 32;
  return kAllForbidden;
}

// the round's view of a heavy or slab row's state: the contender minimum
// and the forbidden words, reduced over the row's slots or entries
struct Term {
  uint32_t pmin;
  uint32_t lo;
  uint32_t hi;
};

__device__ __forceinline__ Term lane_up(Term x, int o) {
  return {__shfl_up_sync(kFull, x.pmin, o), __shfl_up_sync(kFull, x.lo, o),
          __shfl_up_sync(kFull, x.hi, o)};
}

__device__ __forceinline__ Term lane_of(Term x, int src) {
  return {__shfl_sync(kFull, x.pmin, src), __shfl_sync(kFull, x.lo, src),
          __shfl_sync(kFull, x.hi, src)};
}

__device__ __forceinline__ Term combine(Term a, Term b) {
  return {a.pmin < b.pmin ? a.pmin : b.pmin, a.lo | b.lo, a.hi | b.hi};
}

// vertex v's priority this round: its own id packed with b, or in a bucket
// (kBucket, an instance of its own, so the single-graph loop pays no
// branch) its member-local one
template <bool kBucket>
__device__ __forceinline__ uint32_t luby_tuple(
    const Luby& r, const RoundPriority<kXorshiftStar>& prio, int32_t v) {
  if constexpr (kBucket) {
    return tuple_of(prio, static_cast<uint32_t>(v), r.b, r.mem);
  } else {
    return prio.tuple(static_cast<uint32_t>(v), r.b);
  }
}

// neighbour j's share of a row's term: a contender's priority if j is
// uncolored, its color's bit if not
template <bool kBucket>
__device__ __forceinline__ void add_neighbour(
    Term& x, const Luby& r, const RoundPriority<kXorshiftStar>& prio,
    const int32_t* cur, int32_t j) {
  const int32_t c = state_load<kCoherent>(cur + j);
  if (c < 0) {
    const uint32_t p = luby_tuple<kBucket>(r, prio, j);
    x.pmin = p < x.pmin ? p : x.pmin;
  } else if (c < 32) {
    x.lo |= 1u << c;
  } else {
    x.hi |= 1u << (c - 32);
  }
}

template <int G>
__device__ __forceinline__ Term group_reduce(Term x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    x = combine(x, {__shfl_xor_sync(kFull, x.pmin, o),
                    __shfl_xor_sync(kFull, x.lo, o),
                    __shfl_xor_sync(kFull, x.hi, o)});
  }
  return x;
}

// One round over the n rows of map m's list `wl` (null: the identity, row
// i), G lanes a row, 32 / G rows a warp step: each row's new color to
// `nxt`, the rows uncolored at the round's start appended to `next` (its
// length at *next_count), the rows left uncolored counted into `left`
template <int G, bool kBucket>
__device__ __forceinline__ void luby_rows(const Luby& r, const MapView& m,
                                          const int32_t* wl, int64_t n,
                                          const int32_t* cur, int32_t* nxt,
                                          uint32_t rnd, int32_t* next,
                                          int32_t* next_count, int32_t& left) {
  constexpr int kRows = 32 / G;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const int grp = lane / G;
  const RoundPriority<kXorshiftStar> prio(rnd);
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t base = warp * kRows; base < n; base += warps * kRows) {
    const int64_t slot = base + grp;
    int32_t row = -1;
    if (slot < n) {
      row = wl != nullptr ? state_load<kCoherent>(wl + slot)
                          : static_cast<int32_t>(slot);
    }
    const int32_t vid = row < 0 ? -1 : m.rows != nullptr ? m.rows[row] : row;
    const int32_t own = vid < 0 ? 0 : state_load<kCoherent>(cur + vid);
    const bool work = vid >= 0 && own < 0;
    Term x{kNoContender, 0u, 0u};
    if (__any_sync(kFull, work)) {
      if (work) {
        const int64_t at = static_cast<int64_t>(row) * m.d;
        for (int j = sub; j < m.d; j += G) {
          const int32_t nb = m.nbrs[at + j];
          if (m.mask[at + j] != 0 && nb != vid) {
            add_neighbour<kBucket>(x, r, prio, cur, nb);
          }
        }
      }
      x = group_reduce<G>(x);
    }
    bool colored = false;
    if (sub == 0 && vid >= 0) {
      int32_t res = own;
      if (work) {
        if (luby_tuple<kBucket>(r, prio, vid) < x.pmin) {
          res = smallest_free(x.lo, x.hi);
        }
        left += res < 0 ? 1 : 0;
        colored = res >= 0;
      }
      nxt[vid] = res;
    }
    const bool keep = sub == 0 && work;
    const uint32_t bits = __ballot_sync(kFull, keep);
    int32_t pos = 0;
    if (lane == 0 && bits != 0u) pos = atomicAdd(next_count, __popc(bits));
    pos = __shfl_sync(kFull, pos, 0);
    if (keep) next[pos + __popc(bits & ((1u << lane) - 1u))] = row;
    if constexpr (kBucket) {     // the members' done rounds
      const int32_t j = colored ? vid >> r.mem.shift : -1;
      const uint32_t peers = __match_any_sync(kFull, j);
      if (j >= 0 && lane == __ffs(static_cast<int>(peers)) - 1) {
        atomicMax(r.done + j, static_cast<int32_t>(rnd + 1));
      }
    }
  }
}

// the spill's entries: each heavy row's contender minimum and forbidden
// words into hmin / hforb (rows colored at the round's start skipped)
__device__ __forceinline__ void spill_terms(const Luby& r, const int32_t* cur,
                                            uint32_t rnd) {
  const RoundPriority<kXorshiftStar> prio(rnd);
  segment_reduce_warp(
      r.spill_seg, r.e, Term{kNoContender, 0u, 0u},
      [](Term a, Term b) { return combine(a, b); },
      [&](int64_t i, int32_t sg) -> Term {
        Term x{kNoContender, 0u, 0u};
        const int32_t row = r.spill_rows[sg];
        const int32_t col = r.spill_cols[i];
        if (col != row && state_load<kCoherent>(cur + row) < 0) {
          add_neighbour<false>(x, r, prio, cur, col);
        }
        return x;
      },
      [&](int32_t sg, Term x) {
        if (x.pmin != kNoContender) atomicMin(r.hmin + sg, x.pmin);
        if (x.lo != 0u) atomicOr(r.hforb + 2 * sg, x.lo);
        if (x.hi != 0u) atomicOr(r.hforb + 2 * sg + 1, x.hi);
      });
}

// ... finished per heavy row after a grid sync, the scratch reset
__device__ __forceinline__ void spill_finish(const Luby& r, const int32_t* cur,
                                             int32_t* nxt, uint32_t rnd,
                                             int32_t& left) {
  const RoundPriority<kXorshiftStar> prio(rnd);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t h = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       h < r.h; h += stride) {
    const int32_t row = r.spill_rows[h];
    const int32_t own = state_load<kCoherent>(cur + row);
    int32_t res = own;
    if (own < 0) {
      const uint32_t pmin = state_load<kCoherent>(r.hmin + h);
      if (prio.tuple(static_cast<uint32_t>(row), r.b) < pmin) {
        res = smallest_free(state_load<kCoherent>(r.hforb + 2 * h),
                            state_load<kCoherent>(r.hforb + 2 * h + 1));
      }
      left += res < 0 ? 1 : 0;
    }
    nxt[row] = res;
    r.hmin[h] = kNoContender;
    r.hforb[2 * h] = r.hforb[2 * h + 1] = 0u;
  }
}

// kBucket: a bucket of graphs (no spill there)
template <bool kBucket>
__global__ void __launch_bounds__(kThreads, kLubyMinBlocks)
luby_fixed_point_kernel(const __grid_constant__ Luby r) {
  __shared__ int32_t words[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  for (int64_t i = tid; i < 2 * r.v; i += stride) {
    const int64_t row = i < r.v ? i : i - r.v;
    r.colors[i] = r.valid == nullptr || r.valid[row] != 0 ? -1 : 0;
  }
  // a member whose rows are all colored in round 0 (or that has none) is
  // done after it
  for (int64_t j = tid; j < r.members; j += stride) r.done[j] = 1;
  for (int64_t h = tid; h < r.h; h += stride) {
    r.hmin[h] = kNoContender;
    r.hforb[2 * h] = r.hforb[2 * h + 1] = 0u;
  }
  if (tid == 0) {
    for (int s = 0; s < r.num_maps; ++s) {
      r.counts[3 * s] = static_cast<int32_t>(r.maps[s].r);
      r.counts[3 * s + 1] = 0;
    }
    r.uncolored[1] = 0;
  }
  grid.sync();
  uint32_t rnd = 0;
  for (;;) {
    if (rnd > 0) {       // the do-while: round 0 always runs
      if (rnd >= static_cast<uint32_t>(r.max_rounds)) break;
      if (state_load<kCoherent>(r.uncolored + rnd % 3) == 0) break;
    }
    const int32_t* cur = r.colors + (rnd & 1) * r.v;
    int32_t* nxt = r.colors + ((rnd + 1) & 1) * r.v;
    if (tid == 0) {      // the counters round rnd + 1 fills
      r.uncolored[(rnd + 2) % 3] = 0;
      for (int s = 0; s < r.num_maps; ++s) r.counts[3 * s + (rnd + 2) % 3] = 0;
    }
    int32_t left = 0;
    for (int s = 0; s < r.num_maps; ++s) {
      const MapView m = map_view(r, s);
      const int64_t n = state_load<kCoherent>(r.counts + 3 * s + rnd % 3);
      const int32_t* wl = rnd == 0 ? nullptr : m.wl[rnd & 1];
      with_lanes(m.g, [&](auto gg) {
        luby_rows<decltype(gg)::value, kBucket>(r, m, wl, n, cur, nxt, rnd,
                                       m.wl[(rnd + 1) & 1],
                                       r.counts + 3 * s + (rnd + 1) % 3, left);
      });
    }
    if (r.h > 0) {
      spill_terms(r, cur, rnd);
      grid.sync();
      spill_finish(r, cur, nxt, rnd, left);
    }
    left = block_sum(left, words);
    if (threadIdx.x == 0 && left != 0) {
      atomicAdd(r.uncolored + (rnd + 1) % 3, left);
    }
    grid.sync();
    ++rnd;
  }
  if constexpr (kBucket) {     // a member left with an uncolored row
    const int32_t* last = r.colors + (rnd & 1) * r.v;
    for (int64_t i = tid; i < r.v; i += stride) {
      if (state_load<kCoherent>(last + i) < 0) r.done[i >> r.mem.shift] = -1;
    }
  }
  if (rnd & 1) {         // the last round wrote buffer 1
    for (int64_t i = tid; i < r.v; i += stride) {
      r.colors[i] = state_load<kCoherent>(r.colors + r.v + i);
    }
  }
  if (tid == 0) r.out[0] = static_cast<int32_t>(rnd);
}

// One cooperative launch of the loop over `r`
int launch_luby(const Luby& r, int64_t aux_len, void* stream) {
  int dev = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (coop == 0) return static_cast<int>(cudaErrorNotSupported);
  if (3 * static_cast<int64_t>(r.num_maps) + 4 > aux_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto fn = r.mem.bits != nullptr ? luby_fixed_point_kernel<true>
                                  : luby_fixed_point_kernel<false>;
  const int grid = resident_blocks(fn);
  Luby arg = r;
  void* args[] = {&arg};
  const cudaError_t status = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fn), dim3(grid), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (status != cudaSuccess) return static_cast<int>(status);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// G, the lanes a row of a map of r rows of d slots takes
int luby_lanes(int d, int64_t r) { return repro_torch::luby_lanes(d, r); }

// The Luby loop in one cooperative launch.  maps: the [S, 7] int64 table
// on the card (LubyMap); lists: int32 [2 * sum R]; the spill's rows [H],
// seg and cols [E] (H = 0 for the padded ELL); colors: int32 [2 * V],
// written (buffer 0 holds the result); heavy: [3 * H] words of scratch;
// aux: aux_len int32 words, 3 counts a map, 3 uncolored counts and 1
// output, the rounds run.  Returns
// cudaErrorNotSupported where the card has no cooperative launch,
// cudaErrorInvalidValue where aux is short, and the launch's error
// (cudaErrorCooperativeLaunchTooLarge among them).
int luby_fixed_point(const void* maps, int num_maps, void* lists,
                     const void* spill_rows, const void* spill_seg,
                     const void* spill_cols, int64_t h, int64_t e,
                     void* colors, void* heavy, void* aux,
                     int64_t aux_len, int64_t v, int b, int max_rounds,
                     void* stream) {
  using namespace repro_torch;
  auto* hw = static_cast<uint32_t*>(heavy);
  auto* x = static_cast<int32_t*>(aux);
  return launch_luby(
      Luby{static_cast<const LubyMap*>(maps), static_cast<int32_t*>(lists),
           static_cast<const int32_t*>(spill_rows),
           static_cast<const int32_t*>(spill_seg),
           static_cast<const int32_t*>(spill_cols),
           static_cast<int32_t*>(colors), hw, hw + h, x + 4, x + 1, x, v, h,
           e, num_maps, b, max_rounds, Members{}, nullptr, nullptr, 0},
      aux_len, stream);
}

// The same over a bucket of graphs, one padded ELL map of V = members *
// (1 << shift) rows and no spill: bits, the members' id bits, int32
// [members]; valid: [V] bytes, the real rows; done: int32 [members],
// written, each member's done round (-1: not done).  Returns as
// luby_fixed_point.
int luby_fixed_point_batched(const void* maps, void* lists, void* colors,
                             void* aux, int64_t aux_len, int64_t v,
                             const void* bits, int shift, const void* valid,
                             void* done, int64_t members, int max_rounds,
                             void* stream) {
  using namespace repro_torch;
  auto* x = static_cast<int32_t*>(aux);
  return launch_luby(
      Luby{static_cast<const LubyMap*>(maps), static_cast<int32_t*>(lists),
           nullptr, nullptr, nullptr, static_cast<int32_t*>(colors), nullptr,
           nullptr, x + 4, x + 1, x, v, 0, 0, 1, 1, max_rounds,
           Members{static_cast<const int32_t*>(bits), shift},
           static_cast<const uint8_t*>(valid), static_cast<int32_t*>(done),
           members},
      aux_len, stream);
}

}  // extern "C"
