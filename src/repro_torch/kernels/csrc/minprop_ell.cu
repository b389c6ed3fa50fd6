// The two passes of one MIS-2 round: fused over padded ELL and over one
// slab of the degree-aware hybrid layout (the device-resident drivers), and
// unfused over pre-gathered worklist rows (the host-driven driver).
//
// The fused and sliced passes replace
// repro/kernels/minprop_ell/kernel.py:fused_refresh_columns_pallas,
// :fused_decide_pallas, :sliced_refresh_columns_pallas and
// :sliced_decide_pallas, each followed by the scatter
// `x.at[gids].set(out, mode="drop")` of repro/kernels/minprop_ell/ops.py:
// here the kernel writes its row in place and skips dead slots, so there
// is no [W] output and no separate scatter.
//
// The unfused passes replace :refresh_columns_pallas and :decide_pallas
// as they are: rows [W, D] gathered outside the kernel in, a [W] output
// out, every slot at or past `count` written with OUT (refresh) or the
// row's own tuple (decide), as repro/kernels/minprop_ell/ref.py defines.
// The §V-A row refresh has run before them, so they hash nothing.
//
// Layout: T, M are [V] uint32 words (stored by torch as int32 bit
// patterns).  The fused passes read the flat self-padded ELL adjacency
// [V * D] int32 and a [W] worklist of global rows (sentinel V).  The
// sliced passes read one hybrid slab [R * D] int32 of global neighbour
// ids, its global row ids slab_rows [R], and a worklist of slab-local rows
// (sentinel R); the global id g = slab_rows[wl[i]] keys the T read, the
// refresh and the write, as `gids` does in the TPU kernel.  The first
// *count slots of a worklist are live; count and it live on the device, so
// the host never reads them.
//
// Bound: memory.  Per live slot a pass reads wl, the row's D neighbour
// ids (contiguous) and one 4-byte word per neighbour at a data-dependent
// address (T in refresh; M and the active byte in decide), and writes one
// word; at D = 81 the ids are nearly all of it.  At the slabs of a skewed
// graph the neighbour words are the cost: the ids of a power-law graph
// have no locality, so each word opens a 32-byte sector of its own (T and
// M are 4 MB at V = 1M and stay in L2 after the first touch, so these are
// L2 sector reads).  The §V-A refresh is integer work on top: a tuple is
// two xorshift64* (64-bit shifts and xors of two 32-bit instructions
// each, a 64-bit multiply) and the packing once the round's f(it + 1) is
// hoisted, 33 SASS instructions (tools/bench_minprop.py --sass).  The TPU
// kernels inline it per neighbour slot, to keep a refreshed T out of HBM:
// D hashes per vertex a round, V * D = 52.5M at Elasticity3D_60 round 0,
// about 100 us of this card's integer issue against a 65 us bytes bound.
//
// The three share one body per pass (refresh_group_kernel,
// decide_group_kernel) over a row map: a worklist entry is a row of the
// adjacency, whose vertex keys T, M and the hash -- the row itself in the
// padded ELL (kPadded), slab_rows[row] in a slab (kSlab), loaded once by
// the lane that owns the slot; the unfused passes' map (kCopy) is below.
// Their shapes were picked by timing variants with tools/bench_minprop.py,
// round 0 and every round of a solve (Laplace3D_100 and Elasticity3D_60
// for the fused and unfused passes, the four slabs of Powerlaw_1M for the
// sliced ones; PERF.md):
// - A group of G lanes per worklist row.  A lane loads a chunk of C of its
//   slots' ids, then all C words they point at, before it uses any (C a
//   power of two up to kChunk, covering its turns where it can): no
//   per-slot branch stops the loads.  Refresh reduces with a group min,
//   decide with two ballots (an active M that is OUT; an active M unequal
//   to the row's tuple).  Integer min, any and all are exact in any order,
//   so the bits are the twins'.  A chunk of 16 holds the registers of 4
//   blocks an SM, a smaller one those of 8 (__launch_bounds__).
// - A warp takes a batch of B worklist slots at a time.  Lane L loads slot
//   L's row, and in decide its T and its fresh tuple: one hash per row,
//   not one per lane of its group.  The groups take the rows from the
//   lanes by shuffles, and each result goes back to its slot's lane, which
//   writes it.
// - The fused passes: G the smallest power of two that leaves a lane at
//   most kLaneSlots of the row's D slots (1 lane at D = 7, 8 at D = 81),
//   B = 32 slots (S = G steps of 32 / G rows).
// - The sliced passes: a slab is short (17,077 rows at Powerlaw_1M's 64-wide
//   one), so G is also raised from the slab's row count R, known on the
//   host, until R * G reaches kSlabFillLanes or a lane would keep fewer
//   than two slots of a row (G = 2, 8, 16, 32 at widths 8, 16, 32, 64), and
//   a warp takes one row a group, B = 32 / G: the grid grows with G (one
//   thread a row would give that slab 67 blocks of 64 dependent steps).
// - Decide takes a null `active` (the hybrid loop without a mask): then a
//   neighbour is active where its M is not IN, one gather a slot where the
//   mask costs a second sector (M never holds IN: refresh maps IN to OUT).
//   With a mask both gathers stay: a [V] pass building the word `active ?
//   M : IN` each round costs more over a solve than the gather it saves.
// - Each vertex is hashed once a round where fused rows are wide (D >=
//   kHashOnceMinD): refresh first runs a pass over T that writes every
//   vertex's refreshed tuple (the undecided ones hashed) to a [V] scratch
//   the wrapper allocates, and the column min reads that instead of T.
//   The pass moves 8 * V bytes more (2% of the pass's bytes at D = 81) in
//   a second launch of the same C call.  At short rows and in the slabs
//   the hash stays inline, f(it + 1) hoisted and the priority kind a
//   template, behind a real branch for decided neighbours: there the pass,
//   streaming all V every round while the worklists shrink, costs more
//   over a solve than the D hashes a vertex.  refresh writes only M either
//   way.
// - A grid sized to the card: the blocks that fit on it at once, each warp
//   striding over batches up to *count (read on the device), so a late
//   round with a short worklist costs a few hundred idle blocks, not one
//   block per 256 slots of the whole capacity.
//
// The unfused passes are a third row map of the same two bodies (kCopy):
// slot i is row i of the [W, D] copy gathered outside (one more movement
// of each live row than the fused passes), live below the host's count,
// which the launch passes where the other maps pass their row count; the
// result goes to slot i of a [W] output, and refresh reads T with no hash
// (the §V-A row refresh has run before it), as the kOnce instance reads
// its scratch.  So they get what the fused passes got from the shape: no
// per-slot `continue` or early return between a row's loads (on an H100
// the one thread a slot that looped over its row took 297.6 us for E60's
// decide at round 0, 2.8x the group's).  A warp visits every slot up to W, not
// only the live ones: the output's dead slots take OUT (refresh) or their
// own tuple (decide) from the lane that owns them, and a batch wholly past
// the count loads no row.  The fused and sliced instances compile to the
// same instructions as before the third map (tools/bench_minprop.py
// --sass).  At short rows (G = 1) a lane loads its own row directly: a
// warp's 32 rows are one contiguous span of the copy, but staging it in
// shared memory with 16-byte loads first (tools/bench_minprop.py
// --variant staged) lost at every register cap tried.
//
// In place is safe: refresh writes only M and reads only T (or its
// scratch); decide reads T only at its own row and writes that row.  The
// slabs of the hybrid layout hold disjoint rows, and every refresh of a
// round is enqueued before the first decide on the same stream.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "grid.cuh"
#include "hash.cuh"

namespace repro_torch {
namespace {

// ---------------------------------------------------------------------------
// the round passes: a group of G lanes per worklist row
// ---------------------------------------------------------------------------

// Tuning constants (tools/bench_minprop.py builds variants of them).
constexpr int kLaneSlots = 16;      // a row's slots a lane may take (picks G)
constexpr int kChunk = 16;          // slots a lane loads at once, at most
constexpr int kHashOnceMinD = 16;   // fused refresh: one hash a vertex from D
// sliced passes: lanes a slab's rows should reach, G raised until R * G
// does (2^20: four times the 270,336 threads the card holds at once)
constexpr int64_t kSlabFillLanes = 1048576;
// blocks an SM must hold (a register cap): for chunks of up to 8 slots,
// and for wider ones, whose loads in flight need the registers
constexpr int kMinBlocks = 8;
constexpr int kMinBlocksWide = 4;

template <int C>
constexpr int min_blocks() {
  return C > 8 ? kMinBlocksWide : kMinBlocks;
}

constexpr uint32_t kFull = 0xFFFFFFFFu;

// The row maps of the two bodies: what the row of a worklist slot is, and
// which vertex keys its T, M and hash
constexpr int kPadded = 0;  // wl[slot], a row of the padded ELL: its vertex
constexpr int kSlab = 1;    // wl[slot], a slab row: vertex slab_rows[row]
constexpr int kCopy = 2;    // row `slot` of a pre-gathered copy; the result
                            // goes to slot `slot` of a [W] output

// G: the smallest power of two, at most 32, that leaves a lane at most
// kLaneSlots of a row's d slots
int group_lanes(int d) {
  int g = 1;
  while (g < 32 && g * kLaneSlots < d) g <<= 1;
  return g;
}

// G for a slab of r rows: doubled from group_lanes while R * G is short
// of kSlabFillLanes and each lane keeps two slots of a row at least
int slab_group_lanes(int d, int64_t r) {
  int g = group_lanes(d);
  while (g < 32 && 4 * g <= d && r * g < kSlabFillLanes) g <<= 1;
  return g;
}

// C: the slots a lane loads at once, a power of two <= kChunk covering its
// turns where it can
int chunk_slots(int g, int d) {
  const int turns = (d + g - 1) / g;
  int c = 1;
  while (c < kChunk && c < turns) c <<= 1;
  return c;
}

__device__ __forceinline__ int64_t live_slots(const int32_t* count,
                                              int64_t w) {
  const int64_t n = *count;
  return n < w ? n : w;
}

// the slots the warps visit: the live ones, or all W of a copy, whose dead
// slots are written too
template <int Map>
__device__ __forceinline__ int64_t visited_slots(const int32_t* count,
                                                 int64_t w) {
  if constexpr (Map == kCopy) {
    return w;
  } else {
    return live_slots(count, w);
  }
}

// the round the priorities hash (none for a copy: it reads T as given)
template <int Map>
__device__ __forceinline__ uint32_t round_of(const uint32_t* it_ptr) {
  if constexpr (Map == kCopy) {
    return 0u;
  } else {
    return *it_ptr;
  }
}

// the row of worklist slot `slot`, or -1 for a dead or sentinel slot
__device__ __forceinline__ int32_t slot_row(const int32_t* __restrict__ wl,
                                            int64_t slot, int64_t n,
                                            int64_t rows) {
  if (slot >= n) return -1;
  const int32_t row = wl[slot];
  return row >= 0 && row < rows ? row : -1;
}

// the row of a warp's batch slot `lane` (B slots a batch), or -1; in a
// copy the slot itself, live below `rows` (there the host's count)
template <int B, int Map>
__device__ __forceinline__ int32_t batch_row(const int32_t* __restrict__ wl,
                                             int64_t base, int lane,
                                             int64_t n, int64_t rows) {
  if constexpr (B < 32) {
    if (lane >= B) return -1;
  }
  if constexpr (Map == kCopy) {
    const int64_t slot = base + lane;
    return slot < n && slot < rows ? static_cast<int32_t>(slot) : -1;
  } else {
    return slot_row(wl, base + lane, n, rows);
  }
}

// the vertex of adjacency row `row` (-1 for none): the row itself in the
// padded ELL, slab_rows[row] in a slab (a copy's rows key no vertex)
template <int Map>
__device__ __forceinline__ int32_t vertex_of(
    int32_t row, const int32_t* __restrict__ slab_rows) {
  if constexpr (Map == kSlab) {
    return row >= 0 ? slab_rows[row] : -1;
  } else {
    return row;
  }
}

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

// the ballot bits of group grp's lanes
template <int G>
__device__ __forceinline__ uint32_t group_bits(int grp) {
  if constexpr (G == 32) {
    return kFull;
  } else {
    return ((1u << G) - 1u) << (grp * G);
  }
}

// A warp's step s hands slot s + q of its batch to group q.  Returns, on
// the lane that owns that slot, its group's result x, and `res` on every
// other lane.
template <int G>
__device__ __forceinline__ uint32_t to_owner(uint32_t res, uint32_t x, int s,
                                             int lane) {
  const int q = lane - s;
  const bool mine = q >= 0 && q < 32 / G;
  const uint32_t y = __shfl_sync(kFull, x, (mine ? q : 0) * G);
  return mine ? y : res;
}

// The ids of a lane's slots k0 .. k0 + C - 1 of row r (turns of G lanes;
// -1 past the row's end or for a dead row), loaded together
template <int G, int C>
__device__ __forceinline__ void load_ids(int32_t (&nb)[C],
                                         const int32_t* __restrict__ nbrs,
                                         int32_t r, int k0, int sub, int d) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = (k0 + c) * G + sub;
    nb[c] = r >= 0 && j < d ? nbrs[static_cast<int64_t>(r) * d + j] : -1;
  }
}

// One round's refreshed tuple of every vertex: h[i] = T[i], or T[i]'s fresh
// tuple where it is undecided
template <int Kind>
__global__ void __launch_bounds__(kThreads) refreshed_tuples_kernel(
    const uint32_t* __restrict__ t, uint32_t* __restrict__ h,
    const uint32_t* __restrict__ it_ptr, int64_t v, int b) {
  const RoundPriority<Kind> prio(*it_ptr);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < v; i += stride) {
    uint32_t x = t[i];
    if (is_undecided(x)) x = prio.tuple(static_cast<uint32_t>(i), b);
    h[i] = x;
  }
}

// M at the vertex of every live worklist row: the min over the row's ids
// of the refreshed tuples, IN -> OUT.  `src` holds them already (kOnce) or
// is T, refreshed here per slot.  A warp takes B = S * 32 / G worklist
// slots a batch: S = G (32 slots) in the padded ELL and a copy, S = 1 in a
// slab.  `rows`: the adjacency's rows, or a copy's live count; a copy's
// M goes to m[slot], OUT at a dead slot.
template <int G, int S, int C, bool kOnce, int Kind, int Map>
__global__ void __launch_bounds__(kThreads, min_blocks<C>())
refresh_group_kernel(
    const uint32_t* __restrict__ src, uint32_t* __restrict__ m,
    const int32_t* __restrict__ nbrs, const int32_t* __restrict__ wl,
    const int32_t* __restrict__ count, const uint32_t* __restrict__ it_ptr,
    int64_t rows, int64_t w, int d, int b,
    const int32_t* __restrict__ slab_rows) {
  constexpr int kBatch = S * (32 / G);
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const int grp = lane / G;
  const int turns = (d + G - 1) / G;
  const int64_t n = visited_slots<Map>(count, w);
  const RoundPriority<Kind> prio(kOnce ? 0u : *it_ptr);
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  for (int64_t base = warp * kBatch; base < n; base += warps * kBatch) {
    if constexpr (Map == kCopy) {
      if (base >= rows) {          // a batch of dead slots: OUT, no loads
        if (base + lane < w) m[base + lane] = kOut;
        continue;
      }
    }
    const int32_t row = batch_row<kBatch, Map>(wl, base, lane, n, rows);
    const int32_t vid = vertex_of<Map>(row, slab_rows);
    uint32_t res = kOut;
    for (int s = 0; s < kBatch; s += 32 / G) {
      const int32_t r = __shfl_sync(kFull, row, s + grp);
      uint32_t mn = kOut;
      for (int k0 = 0; k0 < turns; k0 += C) {
        int32_t nb[C];
        uint32_t x[C];
        load_ids<G, C>(nb, nbrs, r, k0, sub, d);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          x[c] = nb[c] >= 0 ? src[nb[c]] : kOut;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (!kOnce && nb[c] >= 0 && is_undecided(x[c])) {
            x[c] = prio.tuple(static_cast<uint32_t>(nb[c]), b);
          }
          mn = x[c] < mn ? x[c] : mn;
        }
      }
      res = to_owner<G>(res, group_min<G>(mn), s, lane);
    }
    if constexpr (Map == kCopy) {
      if (base + lane < w) m[base + lane] = res == kIn ? kOut : res;
    } else {
      if (row >= 0) m[vid] = res == kIn ? kOut : res;
    }
  }
}

// T at the vertex of every live undecided worklist row <- OUT if an active
// neighbour's M is OUT, else IN if every active neighbour's M equals the
// row's refreshed tuple, else that tuple; decided rows are left as they
// are.  Reads T only at its own vertex.  Without `active` (kGated false) a
// neighbour is active where its M is not IN, one gather a slot.  Batches
// as refresh_group_kernel.  A copy takes each row's tuple from t_rows[slot]
// as it is, and writes the result to t[slot]: the tuple itself at a dead
// slot or a decided row.
template <int G, int S, int C, bool kGated, int Map>
__global__ void __launch_bounds__(kThreads, min_blocks<C>())
decide_group_kernel(
    uint32_t* __restrict__ t, const uint32_t* __restrict__ m,
    const uint8_t* __restrict__ active, const int32_t* __restrict__ nbrs,
    const int32_t* __restrict__ wl, const int32_t* __restrict__ count,
    const uint32_t* __restrict__ it_ptr, int64_t rows, int64_t w, int d,
    int b, int kind, const int32_t* __restrict__ slab_rows,
    const uint32_t* __restrict__ t_rows) {
  constexpr int kBatch = S * (32 / G);
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const int grp = lane / G;
  const int turns = (d + G - 1) / G;
  const uint32_t gbits = group_bits<G>(grp);
  const int64_t n = visited_slots<Map>(count, w);
  const uint32_t it = round_of<Map>(it_ptr);
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  for (int64_t base = warp * kBatch; base < n; base += warps * kBatch) {
    if constexpr (Map == kCopy) {
      if (base >= rows) {          // a batch of dead slots keeps its tuples
        if (base + lane < w) t[base + lane] = t_rows[base + lane];
        continue;
      }
    }
    int32_t row = batch_row<kBatch, Map>(wl, base, lane, n, rows);
    const int32_t vid = vertex_of<Map>(row, slab_rows);
    uint32_t tv = 0;
    if constexpr (Map == kCopy) {
      tv = base + lane < w ? t_rows[base + lane] : 0u;
      if (!is_undecided(tv)) row = -1;
    } else {
      // in the padded ELL a row is its vertex: `row` alone keys T there
      if (row >= 0) {
        if (is_undecided(t[Map == kSlab ? vid : row])) {
          tv = fresh_tuple(kind, it,
                           static_cast<uint32_t>(Map == kSlab ? vid : row), b);
        } else {
          row = -1;
        }
      }
    }
    uint32_t res = 0;
    for (int s = 0; s < kBatch; s += 32 / G) {
      const int32_t r = __shfl_sync(kFull, row, s + grp);
      const uint32_t tr = __shfl_sync(kFull, tv, s + grp);
      bool out = false, neq = false;
      for (int k0 = 0; k0 < turns; k0 += C) {
        int32_t nb[C];
        uint32_t mv[C], av[C];
        load_ids<G, C>(nb, nbrs, r, k0, sub, d);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if constexpr (kGated) {
            mv[c] = nb[c] >= 0 ? m[nb[c]] : 0u;
            av[c] = nb[c] >= 0 ? active[nb[c]] : 0u;
          } else {
            mv[c] = nb[c] >= 0 ? m[nb[c]] : kIn;
          }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if constexpr (kGated) {
            const bool a = av[c] != 0;
            out |= a & (mv[c] == kOut);
            neq |= a & (mv[c] != tr);
          } else {
            out |= mv[c] == kOut;
            neq |= (mv[c] != kIn) & (mv[c] != tr);
          }
        }
      }
      const bool any_out = (__ballot_sync(kFull, out) & gbits) != 0;
      const bool all_eq = (__ballot_sync(kFull, neq) & gbits) == 0;
      res = to_owner<G>(res, any_out ? kOut : all_eq ? kIn : tr, s, lane);
    }
    if constexpr (Map == kCopy) {
      if (base + lane < w) t[base + lane] = row >= 0 ? res : tv;
    } else {
      if (row >= 0) t[Map == kSlab ? vid : row] = res;
    }
  }
}

template <int N>
using Int = std::integral_constant<int, N>;

template <int G, typename F>
void with_chunk(int c, F&& f) {
  if constexpr (kChunk >= 16) {
    if (c == 16) return f(Int<G>{}, Int<16>{});
  }
  if constexpr (kChunk >= 8) {
    if (c == 8) return f(Int<G>{}, Int<8>{});
  }
  switch (c) {
    case 1: return f(Int<G>{}, Int<1>{});
    case 2: return f(Int<G>{}, Int<2>{});
    default: return f(Int<G>{}, Int<4>{});
  }
}

// f(Int<G>, Int<C>) for G lanes a row: C = chunk_slots(G, d) slots a lane
// loads at once
template <typename F>
void with_group_shape(int g, int d, F&& f) {
  const int c = chunk_slots(g, d);
  switch (g) {
    case 1: return with_chunk<1>(c, f);
    case 2: return with_chunk<2>(c, f);
    case 4: return with_chunk<4>(c, f);
    case 8: return with_chunk<8>(c, f);
    case 16: return with_chunk<16>(c, f);
    default: return with_chunk<32>(c, f);
  }
}

// f(Int<Kind>) for the priority kind code `kind`
template <typename F>
void with_kind(int kind, F&& f) {
  switch (kind) {
    case kXorshift: return f(Int<kXorshift>{});
    case kFixed: return f(Int<kFixed>{});
    default: return f(Int<kXorshiftStar>{});
  }
}

// One refresh pass over `rows` adjacency rows in G lanes a row: the
// padded ELL's or a copy's (S = G), or a slab's (S = 1)
template <int Map, bool kOnce, int Kind>
void launch_refresh(int g, const uint32_t* src, uint32_t* m,
                    const int32_t* nbrs, const int32_t* wl,
                    const int32_t* count, const uint32_t* it, int64_t rows,
                    int64_t w, int d, int b, const int32_t* slab_rows,
                    cudaStream_t stream) {
  with_group_shape(g, d, [&](auto gg, auto cc) {
    constexpr int kG = decltype(gg)::value, kC = decltype(cc)::value;
    constexpr int kS = Map == kSlab ? 1 : kG;
    auto k = refresh_group_kernel<kG, kS, kC, kOnce, Kind, Map>;
    k<<<grid_for(k, w, kS * kThreads / kG), kThreads, 0, stream>>>(
        src, m, nbrs, wl, count, it, rows, w, d, b, slab_rows);
  });
}

// One decide pass, shaped as launch_refresh
template <int Map, bool kGated>
void launch_decide(int g, uint32_t* t, const uint32_t* m,
                   const uint8_t* active, const int32_t* nbrs,
                   const int32_t* wl, const int32_t* count,
                   const uint32_t* it, int64_t rows, int64_t w, int d, int b,
                   int kind, const int32_t* slab_rows, const uint32_t* t_rows,
                   cudaStream_t stream) {
  with_group_shape(g, d, [&](auto gg, auto cc) {
    constexpr int kG = decltype(gg)::value, kC = decltype(cc)::value;
    constexpr int kS = Map == kSlab ? 1 : kG;
    auto k = decide_group_kernel<kG, kS, kC, kGated, Map>;
    k<<<grid_for(k, w, kS * kThreads / kG), kThreads, 0, stream>>>(
        t, m, active, nbrs, wl, count, it, rows, w, d, b, kind, slab_rows,
        t_rows);
  });
}

template <int Kind>
void launch_refreshed_tuples(const uint32_t* t, uint32_t* h,
                             const uint32_t* it, int64_t v, int b,
                             cudaStream_t stream) {
  auto pre = refreshed_tuples_kernel<Kind>;
  pre<<<grid_for(pre, v, kThreads), kThreads, 0, stream>>>(t, h, it, v, b);
}

template <int Kind>
void launch_fused_refresh(const uint32_t* t, uint32_t* m, uint32_t* h,
                          const int32_t* nbrs, const int32_t* wl,
                          const int32_t* count, const uint32_t* it, int64_t v,
                          int64_t w, int d, int b, cudaStream_t stream) {
  const int g = group_lanes(d);
  if (d >= kHashOnceMinD) {
    launch_refreshed_tuples<Kind>(t, h, it, v, b, stream);
    launch_refresh<kPadded, true, kXorshiftStar>(g, h, m, nbrs, wl, count,
                                                 it, v, w, d, b, nullptr,
                                                 stream);
  } else {
    launch_refresh<kPadded, false, Kind>(g, t, m, nbrs, wl, count, it, v, w,
                                         d, b, nullptr, stream);
  }
}

}  // namespace
}  // namespace repro_torch

extern "C" {

int fused_refresh_columns(const void* t, void* m, void* scratch,
                          const void* nbrs, const void* wl, const void* count,
                          const void* it, int64_t v, int64_t w, int d, int b,
                          int kind, void* stream) {
  using namespace repro_torch;
  if (w > 0) {
    with_kind(kind, [&](auto k) {
      launch_fused_refresh<decltype(k)::value>(
          static_cast<const uint32_t*>(t), static_cast<uint32_t*>(m),
          static_cast<uint32_t*>(scratch), static_cast<const int32_t*>(nbrs),
          static_cast<const int32_t*>(wl), static_cast<const int32_t*>(count),
          static_cast<const uint32_t*>(it), v, w, d, b,
          static_cast<cudaStream_t>(stream));
    });
  }
  return static_cast<int>(cudaGetLastError());
}

int fused_decide(void* t, const void* m, const void* active, const void* nbrs,
                 const void* wl, const void* count, const void* it, int64_t v,
                 int64_t w, int d, int b, int kind, void* stream) {
  using namespace repro_torch;
  if (w > 0) {
    launch_decide<kPadded, true>(
        group_lanes(d), static_cast<uint32_t*>(t),
        static_cast<const uint32_t*>(m), static_cast<const uint8_t*>(active),
        static_cast<const int32_t*>(nbrs), static_cast<const int32_t*>(wl),
        static_cast<const int32_t*>(count), static_cast<const uint32_t*>(it),
        v, w, d, b, kind, nullptr, nullptr,
        static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

int sliced_refresh_columns(const void* t, void* m, const void* slab_rows,
                           const void* nbrs, const void* wl, const void* count,
                           const void* it, int64_t r, int64_t w, int d, int b,
                           int kind, void* stream) {
  using namespace repro_torch;
  if (w > 0) {
    with_kind(kind, [&](auto k) {
      launch_refresh<kSlab, false, decltype(k)::value>(
          slab_group_lanes(d, r), static_cast<const uint32_t*>(t),
          static_cast<uint32_t*>(m), static_cast<const int32_t*>(nbrs),
          static_cast<const int32_t*>(wl), static_cast<const int32_t*>(count),
          static_cast<const uint32_t*>(it), r, w, d, b,
          static_cast<const int32_t*>(slab_rows),
          static_cast<cudaStream_t>(stream));
    });
  }
  return static_cast<int>(cudaGetLastError());
}

// `active` null: a neighbour is active where its M is not IN
int sliced_decide(void* t, const void* m, const void* active,
                  const void* slab_rows, const void* nbrs, const void* wl,
                  const void* count, const void* it, int64_t r, int64_t w,
                  int d, int b, int kind, void* stream) {
  using namespace repro_torch;
  if (w > 0) {
    const int g = slab_group_lanes(d, r);
    auto* tt = static_cast<uint32_t*>(t);
    const auto* mm = static_cast<const uint32_t*>(m);
    const auto* aa = static_cast<const uint8_t*>(active);
    const auto* sr = static_cast<const int32_t*>(slab_rows);
    const auto* nb = static_cast<const int32_t*>(nbrs);
    const auto* ww = static_cast<const int32_t*>(wl);
    const auto* cc = static_cast<const int32_t*>(count);
    const auto* ii = static_cast<const uint32_t*>(it);
    const auto s = static_cast<cudaStream_t>(stream);
    if (active == nullptr) {
      launch_decide<kSlab, false>(g, tt, mm, aa, nb, ww, cc, ii, r, w, d, b,
                                  kind, sr, nullptr, s);
    } else {
      launch_decide<kSlab, true>(g, tt, mm, aa, nb, ww, cc, ii, r, w, d, b,
                                 kind, sr, nullptr, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The unfused passes: `rows` the [W, D] copy, `count` its live rows (a
// host value, passed where the other maps pass their row count)
int refresh_columns(const void* t, const void* rows, void* out, int64_t w,
                    int d, int64_t count, void* stream) {
  using namespace repro_torch;
  if (w > 0) {
    launch_refresh<kCopy, true, kXorshiftStar>(
        group_lanes(d), static_cast<const uint32_t*>(t),
        static_cast<uint32_t*>(out), static_cast<const int32_t*>(rows),
        nullptr, nullptr, nullptr, count, w, d, 0, nullptr,
        static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

int decide(const void* t_rows, const void* m, const void* active,
           const void* rows, void* out, int64_t w, int d, int64_t count,
           void* stream) {
  using namespace repro_torch;
  if (w > 0) {
    launch_decide<kCopy, true>(
        group_lanes(d), static_cast<uint32_t*>(out),
        static_cast<const uint32_t*>(m), static_cast<const uint8_t*>(active),
        static_cast<const int32_t*>(rows), nullptr, nullptr, nullptr, count,
        w, d, 0, 0, nullptr, static_cast<const uint32_t*>(t_rows),
        static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
