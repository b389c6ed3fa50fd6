// The coarsening's label joins (paper Algorithms 2 and 3), each in one
// cooperative launch, over the padded ELL or over the hybrid layout (sliced
// ELL slabs and the COO spill).
//
// They replace the reference's jitted joins, repro/core/aggregation.py (no
// Pallas kernel of their own: XLA ran the rowwise bodies):
//
//   root_join           _labels_from_roots + _join_adjacent_root (:144-158,
//                       :64-79; hybrid _hybrid_join_jit :246-278), and with
//                       rounds > 0 the Alg. 2 cleanup _cleanup_join_resident
//                       (:161-181; hybrid :281-301); without roots the
//                       cleanup alone, from given labels
//   phase2_join         _phase2_join_resident (:184-200; hybrid :304-329)
//   phase3_fixed_point  _phase3_resident (:203-229; hybrid :371-402 with
//                       _phase3_spill :332-368)
//
// which the port ran as plain-torch loops reading a host flag a round.  No
// kernel reads anything from the host until it returns: the aggregate
// count, the loop's exit and the lists are device words.
//
// Row maps.  A device table of [S, 7] int64 (JoinMap), built once per
// layout by the wrapper, gives each map's global row ids (0 for the padded
// ELL, whose row is its vertex), its [R * D] ids and mask bytes, R, D, its
// G lanes a row and the offset of its share of the list storage.  A group
// of G lanes takes a row, 32 / G rows a warp step.  The spill's heavy rows
// are reduced over their entries as the MIS-2 and Luby kernels reduce them
// (spill.cuh: entries spread over the warps, one atomic per chunk and
// segment into [H] scratch), then finished per heavy row after a grid sync.
//
// Aggregate ids are a grid-wide exclusive scan of the roots (each block
// sums its chunk, a grid sync, each block adds the sums before it and
// scans its chunk by tiles).  The min joins take the minimum over every
// slot of a row, mask or not, as the reference does: the padding slots
// hold the row's own id, its closed neighborhood.
//
// The rounds (the cleanup, phase 3) read the labels at the round's start:
// a round computes each listed row's new label into a slot of `fresh`, a
// grid sync, then commits them and keeps the rows still unlabeled on the
// next list (a warp reserves its slots with one atomicAdd, in phase 3 a
// block; the order of a list changes nothing, each row reading frozen
// labels and writing only its own), counting them for the loop's exit, two
// grid syncs a round.  Only
// the unlabeled rows are on a list: the reference evaluates every row and
// keeps the labeled ones as they were.
//
// Phase 3.  The aggregate sizes are a [V + 1] histogram built once, a
// warp's 32 labels at a time with one atomicAdd a distinct label
// (__match_any_sync); a row joining a label adds 1 to it at the commit, a
// warp's joins grouped the same way, which is the reference's bincount of
// the next round's labels (integer adds are exact in any order).  A slab
// row's coupling of slot j is the count of valid slots holding j's label
// (valid: mask set, not the row itself, labeled).  Each lane loads its at
// most kJoinLaneSlots slots' labels once into registers (the slice-16
// design reloaded every slot's id, mask byte and label for each of the
// lane's slots: ceil(D/G)^2 loads a lane, 121 at Elasticity3D_60's D = 81,
// G = 8, against 11); then the group takes the row's distinct labels one a
// turn, smallest first, and counts the slots holding each by one compare a
// register and a group sum (comparing the slots pairwise through shuffles
// instead, ceil(D/G)^2 * G compares a lane, spilled and took longer than the
// reloads at D = 81).  The pick is the lexicographic minimum of (-coupling,
// size, label); a label's size is gathered once, and only where its coupling
// can still win.  On distinct labels that order is strict and equal labels
// carry equal coupling and size, so the pick does not depend on slot order
// and equals the reference's slot-ordered scan (a row joins only at
// coupling > 0, i.e. with a valid slot).  A map whose lanes keep more slots
// than that (D > 32 * kJoinLaneSlots) takes the slice-16 design's
// reloading count.  A heavy row (a hub of up to 24,065 entries on
// Powerlaw_1M) is taken by one block: its valid labels are counted in an
// open-addressing hash table (capacity twice the row's entries, so every
// insert ends; linear probing, one atomicCAS a probe and an atomicAdd a
// hit), in the block's shared memory where that capacity is at most
// kHeavySlots, else in the row's own span of [2 E] scratch; then the block
// reduces the table's (count, size, label) to the same minimum: exact for
// any input, O(entries) expected a row.  The rows a coarsening leaves to
// phase 3 are mostly short: Powerlaw_1M's two-phase coarsening leaves 16
// heavy rows of 1,200 entries in all (each table in shared memory) against
// 397,750 slab rows.
//
// Bound: memory.  A listed row reads its list slot, its D ids and mask
// bytes and the labels they point at (an L2 sector each at random ids) and
// writes its label and phase byte; the root join reads every row once.
// Phase 3 on an H100 80GB HBM3 at 700 W, at the state a two-phase
// coarsening leaves (one round runs): 71.6 / 111.9 / 188.1 us on
// Laplace3D_100 / Elasticity3D_60 / Powerlaw_1M against the slice-16
// design's 130.8 / 479.2 / 802.6 us in the same call, of which the
// prologue (the histogram, the lists) 30.1 / 21.6 / 57.2 us
// (tools/bench_resident.py --kernels phase3 --caps, PERF.md section 6).

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "grid.cuh"
#include "spill.cuh"

namespace repro_torch {
namespace {

namespace cg = cooperative_groups;

// Tuning constants (tools/bench_resident.py builds variants of them).
constexpr int kJoinLaneSlots = 16;   // a row's slots a lane may take (picks G)
constexpr int kJoinMinBlocks = 4;    // blocks an SM must hold (register cap)
// room for the scan's block sums: an H100 holds at most 132 x 8 blocks of
// kThreads at once, and a cooperative launch no more
constexpr int kMaxBlocks = 2048;

constexpr int32_t kNone = 0x7FFFFFFF;   // INT32_MAX: no root label
// phase 3: the slots of a heavy row's hash table held in shared memory
// (twice the row's entries; a larger row's table is in global memory)
constexpr uint32_t kHeavySlots = 2048;

// One row map (see the header): a row of the wrapper's [S, 7] int64 table
struct JoinMap {
  int64_t rows;
  int64_t nbrs;
  int64_t mask;
  int64_t r;
  int64_t d;
  int64_t g;
  int64_t off;   // sum of the R of the maps before it
};

struct MapView {
  const int32_t* rows;
  const int32_t* nbrs;
  const uint8_t* mask;
  int64_t r;
  int64_t off;
  int d;
  int g;
};

// The words of a launch's int32 scratch, in this order: ctl [4 + 2 S]
// (rows left unlabeled [2], the heavy list's length [2], each map's list
// length [2], by round parity), sums [kMaxBlocks] (the scan's block sums),
// vert [V + 1] (root labels, or phase 3's aggregate sizes), lists [2 (sum R
// + H)] (each map's two lists, then the heavy rows'), fresh [sum R + H] (a
// round's new labels by list slot), heavy [H] (a heavy row's segment min
// or count), hoff [H + 1] (phase 3: each heavy row's first entry), keys
// and cnts [2 E] each (phase 3: the heavy rows' hash tables)
struct ScratchLayout {
  int64_t sums;
  int64_t vert;
  int64_t lists;
  int64_t fresh;
  int64_t heavy;
  int64_t hoff;
  int64_t keys;
  int64_t cnts;
  int64_t total;
};

ScratchLayout scratch_layout(int num_maps, int64_t sum_r, int64_t h,
                             int64_t e, int64_t v, bool table) {
  ScratchLayout x;
  x.sums = 4 + 2 * static_cast<int64_t>(num_maps);
  x.vert = x.sums + kMaxBlocks;
  x.lists = x.vert + v + 1;
  x.fresh = x.lists + 2 * (sum_r + h);
  x.heavy = x.fresh + sum_r + h;
  x.hoff = x.heavy + h;
  x.keys = x.hoff + h + 1;
  x.cnts = x.keys + (table ? 2 * e : 0);
  x.total = x.cnts + (table ? 2 * e : 0);
  return x;
}

// Everything a join launch reads and writes.  Inputs (written before the
// launch) are read plainly; what the launch writes and another block reads
// goes through state_load<kCoherent>.
struct Join {
  const JoinMap* maps;
  const int32_t* spill_rows;
  const int32_t* spill_seg;
  const int32_t* spill_cols;
  const uint8_t* roots;       // root_join: the MIS-2 roots, or null
  const uint8_t* in_set2;     // phase2_join: the second MIS-2's set
  const int32_t* nagg_in;     // phase2_join: the aggregates so far [1]
  const int32_t* labels_in;   // [V], or null (root_join from roots)
  const uint8_t* phase_in;    // [V], or null
  int32_t* labels;            // [V], written
  uint8_t* phase;             // [V], written
  uint8_t* roots2;            // phase2_join: [V], written
  int32_t* out;               // root_join: nagg, unlabeled; phase2: nagg
  int32_t* ctl;
  int32_t* sums;
  int32_t* vert;
  int32_t* lists;
  int32_t* fresh;
  uint32_t* heavy;
  int32_t* hoff;
  int32_t* keys;
  int32_t* cnts;
  int64_t v;
  int64_t h;
  int64_t e;
  int64_t sum_r;
  int num_maps;
  int rounds;
  int min_secondary;
};

__device__ __forceinline__ MapView map_view(const Join& r, int s) {
  const JoinMap& x = r.maps[s];
  MapView m;
  m.rows = reinterpret_cast<const int32_t*>(x.rows);
  m.nbrs = reinterpret_cast<const int32_t*>(x.nbrs);
  m.mask = reinterpret_cast<const uint8_t*>(x.mask);
  m.r = x.r;
  m.off = x.off;
  m.d = static_cast<int>(x.d);
  m.g = static_cast<int>(x.g);
  return m;
}

// map s's list of parity p, its length, and the heavy rows' ([H] each)
__device__ __forceinline__ int32_t* map_list(const Join& r, const MapView& m,
                                             int p) {
  return r.lists + 2 * m.off + p * m.r;
}

__device__ __forceinline__ int32_t* map_count(const Join& r, int s, int p) {
  return r.ctl + 4 + 2 * s + p;
}

__device__ __forceinline__ int32_t* heavy_list(const Join& r, int p) {
  return r.lists + 2 * r.sum_r + p * r.h;
}

__device__ __forceinline__ int64_t global_tid() {
  return static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
}

__device__ __forceinline__ int64_t global_stride() {
  return static_cast<int64_t>(gridDim.x) * kThreads;
}

// G, the lanes a row of d slots takes
int join_lanes(int d) { return row_lanes(d, kJoinLaneSlots); }

// f(Int<G>{}, slot, row, vid) for each of the n slots of map m's list `wl`
// (null: rows 0..n-1), G lanes a row, 32 / G rows a warp step; every lane
// of a warp makes the same calls (past n: row and vid -1), so f may
// shuffle
template <int G, bool kByBlock = false, typename F>
__device__ __forceinline__ void rows_loop(const MapView& m, const int32_t* wl,
                                          int64_t n, F&& f) {
  constexpr int kRows = 32 / G;
  const int grp = (threadIdx.x & 31) / G;
  const int64_t warp = global_tid() >> 5;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  // kByBlock: every warp of a block takes the same turns, so that f may
  // sync the block (a turn past n holds no row)
  const int64_t end = kByBlock ? n + (warp & (kWarps - 1)) * kRows : n;
  for (int64_t base = warp * kRows; base < end; base += warps * kRows) {
    const int64_t slot = base + grp;
    int32_t row = -1;
    if (slot < n) {
      row = wl != nullptr ? state_load<kCoherent>(wl + slot)
                          : static_cast<int32_t>(slot);
    }
    const int32_t vid = row < 0 ? -1 : m.rows != nullptr ? m.rows[row] : row;
    f(Int<G>{}, slot, row, vid);
  }
}

// rows_loop at the map's own G
template <typename F>
__device__ __forceinline__ void for_rows(const MapView& m, const int32_t* wl,
                                         int64_t n, F&& f) {
  with_lanes(m.g, [&](auto gg) {
    rows_loop<decltype(gg)::value>(m, wl, n, f);
  });
}

struct MinOp {
  __device__ __forceinline__ uint32_t operator()(uint32_t a,
                                                 uint32_t b) const {
    return a < b ? a : b;
  }
};

struct AddOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const {
    return a + b;
  }
};

// x reduced over each group of G lanes by `op`, on every lane of the group
template <int G, typename T, typename Op>
__device__ __forceinline__ T group_reduce(T x, Op op) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x = op(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// the min over a row's slots of val(neighbour id), the group's lanes
// splitting the slots; every lane of the warp calls it
template <int G, typename Val>
__device__ __forceinline__ uint32_t row_min(const MapView& m, int32_t row,
                                            bool work, Val val) {
  uint32_t x = kNone;
  if (work) {
    const int64_t at = static_cast<int64_t>(row) * m.d;
    for (int j = threadIdx.x & (G - 1); j < m.d; j += G) {
      x = MinOp{}(x, val(m.nbrs[at + j]));
    }
  }
  return group_reduce<G>(x, MinOp{});
}

// x's exclusive prefix over the block's threads; *tile gets the block's
// sum; `words` is the block's shared [kWarps]
__device__ __forceinline__ int32_t block_exclusive(int32_t x, int32_t* words,
                                                   int32_t* tile) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  int32_t inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) words[w] = inc;
  __syncthreads();
  int32_t before = 0, all = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    before += k < w ? words[k] : 0;
    all += words[k];
  }
  __syncthreads();
  *tile = all;
  return before + inc - x;
}

// this block's chunk [lo, hi) of n items in a grid scan
__device__ __forceinline__ void block_chunk(int64_t n, int64_t& lo,
                                            int64_t& hi) {
  const int64_t per = (n + gridDim.x - 1) / gridDim.x;
  lo = static_cast<int64_t>(blockIdx.x) * per < n
           ? static_cast<int64_t>(blockIdx.x) * per : n;
  hi = lo + per < n ? lo + per : n;
}

// The grid-wide exclusive scan of pred(i) over [0, n), in two steps with a
// grid sync between them: scan_sums puts each block's chunk sum into sums;
// scan_emit calls emit(i, pred(i), first + the count of j < i with pred(j))
// for every i and returns the count over [0, n), on every thread
template <typename Pred>
__device__ __forceinline__ void scan_sums(int64_t n, Pred pred, int32_t* sums,
                                          int32_t* words) {
  int64_t lo, hi;
  block_chunk(n, lo, hi);
  int32_t x = 0;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) x += pred(i);
  x = block_sum(x, words);
  if (threadIdx.x == 0) sums[blockIdx.x] = x;
}

template <typename Pred, typename Emit>
__device__ __forceinline__ int32_t scan_emit(int64_t n, Pred pred,
                                             const int32_t* sums,
                                             int32_t* words, int32_t first,
                                             Emit emit) {
  int32_t before = 0, all = 0;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) {
    const int32_t s = state_load<kCoherent>(sums + b);
    before += b < static_cast<int>(blockIdx.x) ? s : 0;
    all += s;
  }
  int32_t offset = first + block_sum(before, words);
  all = block_sum(all, words);
  int64_t lo, hi;
  block_chunk(n, lo, hi);
  for (int64_t t0 = lo; t0 < hi; t0 += kThreads) {       // block-uniform
    const int64_t i = t0 + threadIdx.x;
    const int32_t x = i < hi ? pred(i) : 0;
    int32_t tile = 0;
    const int32_t ex = block_exclusive(x, words, &tile);
    if (i < hi) emit(i, x, offset + ex);
    offset += tile;
  }
  return all;
}

// `left` summed over the block and added to *counter (the rows a pass
// left unlabeled); every thread of the block calls it
__device__ __forceinline__ void add_left(int32_t left, int32_t* counter,
                                         int32_t* words) {
  left = block_sum(left, words);
  if (threadIdx.x == 0 && left != 0) atomicAdd(counter, left);
}

// The spill's entries reduced by heavy row into r.heavy by min, val(i, row)
// being entry i's term (kNone for none); every thread calls it
template <typename Val>
__device__ __forceinline__ void spill_min(const Join& r, Val val) {
  segment_reduce_warp(
      r.spill_seg, r.e, static_cast<uint32_t>(kNone), MinOp{},
      [&](int64_t i, int32_t sg) -> uint32_t {
        return val(i, r.spill_rows[sg]);
      },
      [&](int32_t sg, uint32_t x) {
        if (x != static_cast<uint32_t>(kNone)) atomicMin(r.heavy + sg, x);
      });
}

// a label read back in the launch, as the min joins take it: the label,
// or kNone where the vertex is unlabeled
__device__ __forceinline__ uint32_t joined_label(const int32_t* labels,
                                                 int32_t u) {
  const int32_t l = state_load<kCoherent>(labels + u);
  return l >= 0 ? static_cast<uint32_t>(l) : static_cast<uint32_t>(kNone);
}

// One cleanup round of the listed rows (the lists of parity `cur`) and the
// heavy rows: each row's min over its closed neighbourhood of the labels,
// committed after a grid sync, the rows still unlabeled listed and counted
// into ctl[nxt]
__device__ __forceinline__ void cleanup_round(const Join& r, int cur,
                                              cg::grid_group& grid,
                                              int32_t* words) {
  const int nxt = cur ^ 1;
  if (global_tid() == 0) {      // the counters this round fills
    r.ctl[nxt] = 0;
    for (int s = 0; s < r.num_maps; ++s) *map_count(r, s, nxt) = 0;
  }
  for (int s = 0; s < r.num_maps; ++s) {
    const MapView m = map_view(r, s);
    const int64_t n = state_load<kCoherent>(map_count(r, s, cur));
    for_rows(m, map_list(r, m, cur), n,
             [&](auto gg, int64_t slot, int32_t row, int32_t vid) {
      constexpr int G = decltype(gg)::value;
      const uint32_t x = row_min<G>(m, row, vid >= 0, [&](int32_t u) {
        return joined_label(r.labels, u);
      });
      if ((threadIdx.x & (G - 1)) == 0 && vid >= 0) {
        r.fresh[m.off + slot] = static_cast<int32_t>(x);
      }
    });
  }
  if (r.h > 0) {
    spill_min(r, [&](int64_t i, int32_t row) -> uint32_t {
      if (state_load<kCoherent>(r.labels + row) >= 0) return kNone;
      return joined_label(r.labels, r.spill_cols[i]);
    });
  }
  grid.sync();
  int32_t left = 0;
  for (int s = 0; s < r.num_maps; ++s) {
    const MapView m = map_view(r, s);
    const int64_t n = state_load<kCoherent>(map_count(r, s, cur));
    int32_t* next = map_list(r, m, nxt);
    int32_t* next_count = map_count(r, s, nxt);
    rows_loop<1>(m, map_list(r, m, cur), n,
                 [&](auto, int64_t slot, int32_t row, int32_t vid) {
      bool keep = false;
      if (vid >= 0) {
        const int32_t x = state_load<kCoherent>(r.fresh + m.off + slot);
        if (x != kNone) {
          r.labels[vid] = x;
          r.phase[vid] = 3;
        } else {
          keep = true;
          ++left;
        }
      }
      warp_append(keep, row, next, next_count);
    });
  }
  for (int64_t h = global_tid(); h < r.h; h += global_stride()) {
    const int32_t row = r.spill_rows[h];
    if (state_load<kCoherent>(r.labels + row) < 0) {
      const uint32_t x = state_load<kCoherent>(r.heavy + h);
      if (x != static_cast<uint32_t>(kNone)) {
        r.labels[row] = static_cast<int32_t>(x);
        r.phase[row] = 3;
      } else {
        ++left;
      }
    }
    r.heavy[h] = kNone;
  }
  add_left(left, r.ctl + nxt, words);
  grid.sync();
}

__global__ void __launch_bounds__(kThreads, kJoinMinBlocks)
root_join_kernel(const __grid_constant__ Join r) {
  __shared__ int32_t words[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = global_tid();
  const int64_t stride = global_stride();
  if (tid == 0) {
    r.ctl[0] = r.ctl[1] = 0;
    for (int s = 0; s < r.num_maps; ++s) {
      *map_count(r, s, 0) = *map_count(r, s, 1) = 0;
    }
  }
  for (int64_t h = tid; h < r.h; h += stride) r.heavy[h] = kNone;
  int32_t left = 0;
  if (r.roots != nullptr) {
    // aggregate ids: the roots' exclusive scan, kNone on the other rows
    const auto is_root = [&](int64_t i) -> int32_t {
      return r.roots[i] != 0 ? 1 : 0;
    };
    scan_sums(r.v, is_root, r.sums, words);
    grid.sync();
    const int32_t nagg = scan_emit(
        r.v, is_root, r.sums, words, 0,
        [&](int64_t i, int32_t x, int32_t id) { r.vert[i] = x ? id : kNone; });
    if (tid == 0) r.out[0] = nagg;
    grid.sync();
    // every row joins the root of its closed neighbourhood, if any
    for (int s = 0; s < r.num_maps; ++s) {
      const MapView m = map_view(r, s);
      for_rows(m, nullptr, m.r,
               [&](auto gg, int64_t, int32_t row, int32_t vid) {
        constexpr int G = decltype(gg)::value;
        const uint32_t x = row_min<G>(m, row, vid >= 0, [&](int32_t u) {
          return static_cast<uint32_t>(state_load<kCoherent>(r.vert + u));
        });
        bool keep = false;
        if ((threadIdx.x & (G - 1)) == 0 && vid >= 0) {
          const bool joined = x != static_cast<uint32_t>(kNone);
          r.labels[vid] = joined ? static_cast<int32_t>(x) : -1;
          r.phase[vid] = joined ? 1 : 0;
          keep = !joined;
          left += keep ? 1 : 0;
        }
        warp_append(keep, row, map_list(r, m, 0), map_count(r, s, 0));
      });
    }
    if (r.h > 0) {
      spill_min(r, [&](int64_t i, int32_t) -> uint32_t {
        return static_cast<uint32_t>(
            state_load<kCoherent>(r.vert + r.spill_cols[i]));
      });
    }
    grid.sync();
    for (int64_t h = tid; h < r.h; h += stride) {
      const int32_t row = r.spill_rows[h];
      const uint32_t x =
          MinOp{}(state_load<kCoherent>(r.heavy + h),
                  static_cast<uint32_t>(state_load<kCoherent>(r.vert + row)));
      const bool joined = x != static_cast<uint32_t>(kNone);
      r.labels[row] = joined ? static_cast<int32_t>(x) : -1;
      r.phase[row] = joined ? 1 : 0;
      left += joined ? 0 : 1;
      r.heavy[h] = kNone;
    }
  } else {
    // the cleanup alone: the given labels and marks, the unlabeled listed
    if (tid == 0) r.out[0] = 0;
    grid.sync();                  // the counters zeroed
    for (int64_t i = tid; i < r.v; i += stride) {
      r.labels[i] = r.labels_in[i];
      r.phase[i] = r.phase_in[i];
    }
    for (int s = 0; s < r.num_maps; ++s) {
      const MapView m = map_view(r, s);
      rows_loop<1>(m, nullptr, m.r,
                 [&](auto, int64_t, int32_t row, int32_t vid) {
        const bool keep = vid >= 0 && r.labels_in[vid] < 0;
        left += keep ? 1 : 0;
        warp_append(keep, row, map_list(r, m, 0), map_count(r, s, 0));
      });
    }
    for (int64_t h = tid; h < r.h; h += stride) {
      left += r.labels_in[r.spill_rows[h]] < 0 ? 1 : 0;
    }
  }
  add_left(left, r.ctl, words);
  grid.sync();
  int rnd = 0;
  for (; rnd < r.rounds; ++rnd) {
    if (state_load<kCoherent>(r.ctl + (rnd & 1)) == 0) break;
    cleanup_round(r, rnd & 1, grid, words);
  }
  if (tid == 0) r.out[1] = state_load<kCoherent>(r.ctl + (rnd & 1));
}

__global__ void __launch_bounds__(kThreads, kJoinMinBlocks)
phase2_join_kernel(const __grid_constant__ Join r) {
  __shared__ int32_t words[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = global_tid();
  const int64_t stride = global_stride();
  for (int64_t h = tid; h < r.h; h += stride) r.heavy[h] = 0;
  grid.sync();
  // the second set's rows with enough unaggregated real neighbours: the
  // secondary roots, 0 or 1 into vert
  for (int s = 0; s < r.num_maps; ++s) {
    const MapView m = map_view(r, s);
    for_rows(m, nullptr, m.r,
             [&](auto gg, int64_t, int32_t row, int32_t vid) {
      constexpr int G = decltype(gg)::value;
      const bool work = vid >= 0 && r.in_set2[vid] != 0;
      int32_t n = 0;
      if (work) {
        const int64_t at = static_cast<int64_t>(row) * m.d;
        for (int j = threadIdx.x & (G - 1); j < m.d; j += G) {
          const int32_t u = m.nbrs[at + j];
          n += m.mask[at + j] != 0 && u != vid && r.labels_in[u] < 0;
        }
      }
      n = group_reduce<G>(n, AddOp{});
      if ((threadIdx.x & (G - 1)) == 0 && vid >= 0) {
        r.vert[vid] = work && n >= r.min_secondary ? 1 : 0;
      }
    });
  }
  if (r.h > 0) {
    segment_reduce_warp(
        r.spill_seg, r.e, 0u, AddOp{},
        [&](int64_t i, int32_t sg) -> uint32_t {
          const int32_t row = r.spill_rows[sg];
          const int32_t u = r.spill_cols[i];
          return r.in_set2[row] != 0 && u != row && r.labels_in[u] < 0
                     ? 1u : 0u;
        },
        [&](int32_t sg, uint32_t x) {
          if (x != 0u) atomicAdd(r.heavy + sg, x);
        });
  }
  grid.sync();
  for (int64_t h = tid; h < r.h; h += stride) {
    const int32_t row = r.spill_rows[h];
    const auto n = static_cast<int32_t>(state_load<kCoherent>(r.heavy + h));
    r.vert[row] = r.in_set2[row] != 0 && n >= r.min_secondary ? 1 : 0;
    r.heavy[h] = kNone;
  }
  grid.sync();
  // their ids, nagg on, in row order
  const auto is_root = [&](int64_t i) -> int32_t {
    return state_load<kCoherent>(r.vert + i);
  };
  scan_sums(r.v, is_root, r.sums, words);
  grid.sync();
  const int32_t nagg = r.nagg_in[0];
  const int32_t more = scan_emit(
      r.v, is_root, r.sums, words, nagg,
      [&](int64_t i, int32_t x, int32_t id) {
        r.vert[i] = x ? id : kNone;
        r.roots2[i] = x ? 1 : 0;
      });
  if (tid == 0) r.out[0] = nagg + more;
  grid.sync();
  // the unlabeled rows join a secondary root of their closed neighbourhood
  for (int s = 0; s < r.num_maps; ++s) {
    const MapView m = map_view(r, s);
    for_rows(m, nullptr, m.r,
             [&](auto gg, int64_t, int32_t row, int32_t vid) {
      constexpr int G = decltype(gg)::value;
      const int32_t own = vid >= 0 ? r.labels_in[vid] : 0;
      const uint32_t x = row_min<G>(m, row, vid >= 0 && own < 0,
                                    [&](int32_t u) {
        return static_cast<uint32_t>(state_load<kCoherent>(r.vert + u));
      });
      if ((threadIdx.x & (G - 1)) == 0 && vid >= 0) {
        const bool joined = own < 0 && x != static_cast<uint32_t>(kNone);
        r.labels[vid] = joined ? static_cast<int32_t>(x) : own;
        r.phase[vid] = joined ? 2 : r.phase_in[vid];
      }
    });
  }
  if (r.h > 0) {
    spill_min(r, [&](int64_t i, int32_t row) -> uint32_t {
      if (r.labels_in[row] >= 0) return kNone;
      return static_cast<uint32_t>(
          state_load<kCoherent>(r.vert + r.spill_cols[i]));
    });
  }
  grid.sync();
  for (int64_t h = tid; h < r.h; h += stride) {
    const int32_t row = r.spill_rows[h];
    const int32_t own = r.labels_in[row];
    const uint32_t x =
        MinOp{}(state_load<kCoherent>(r.heavy + h),
                static_cast<uint32_t>(state_load<kCoherent>(r.vert + row)));
    const bool joined = own < 0 && x != static_cast<uint32_t>(kNone);
    r.labels[row] = joined ? static_cast<int32_t>(x) : own;
    r.phase[row] = joined ? 2 : r.phase_in[row];
  }
}

// phase 3's pick: the most coupled label, then the smallest aggregate,
// then the smallest label; c = 0 is no pick
struct Pick {
  int32_t c;
  int32_t s;
  int32_t l;
};

__device__ __forceinline__ Pick better_of(Pick a, Pick b) {
  const bool a_wins =
      a.c > b.c || (a.c == b.c && (a.s < b.s || (a.s == b.s && a.l < b.l)));
  return a_wins ? a : b;
}

__device__ __forceinline__ Pick shfl_xor_pick(Pick x, int o) {
  return {__shfl_xor_sync(kFull, x.c, o), __shfl_xor_sync(kFull, x.s, o),
          __shfl_xor_sync(kFull, x.l, o)};
}

template <int G>
__device__ __forceinline__ Pick group_pick(Pick x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x = better_of(x, shfl_xor_pick(x, o));
  return x;
}

// the label of slot `at` of a row of vertex vid where the slot is valid
// (mask set, not the row itself, labeled), else -1
__device__ __forceinline__ int32_t slot_label(const Join& r, const MapView& m,
                                              int64_t at, int32_t vid) {
  const int32_t u = m.nbrs[at];
  if (m.mask[at] == 0 || u == vid) return -1;
  const int32_t l = state_load<kCoherent>(r.labels + u);
  return l >= 0 ? l : -1;
}

__device__ __forceinline__ int32_t aggregate_size(const Join& r, int32_t l) {
  return state_load<kCoherent>(r.vert + (l < r.v ? l : r.v));
}

// 1 added to the size of label l (none where l < 0) for every lane of the
// warp: one atomicAdd a distinct label; every lane of the warp calls it
__device__ __forceinline__ void warp_count(const Join& r, int32_t l) {
  const int32_t key = l < 0 ? -1 : l < r.v ? l : static_cast<int32_t>(r.v);
  const uint32_t peers = __match_any_sync(kFull, key);
  if (key >= 0 && static_cast<int>(threadIdx.x & 31) ==
                      __ffs(static_cast<int>(peers)) - 1) {
    atomicAdd(r.vert + key, __popc(peers));
  }
}

// phase 3 of a listed row of a map whose lanes keep at most kJoinLaneSlots
// slots of a row each (slot j to lane j mod G, turn j / G): each lane loads
// its slots' labels once into registers (kUnlabeled where not valid); then
// the group takes the row's distinct labels one a turn, smallest first
// (the group's minimum), counts the slots holding it (its coupling: each
// lane's matches, summed over the group) and clears them, so a row costs a
// turn a distinct label, not a compare a pair of slots.  A label's size is
// gathered once, and only where its coupling can still win.  The turns
// run while any group of the warp has a label left (every lane shuffles).
// The pick is the same on every lane of the group.
template <int G>
__device__ __forceinline__ Pick row_pick(const Join& r, const MapView& m,
                                         int32_t row, int32_t vid) {
  constexpr int kT = kJoinLaneSlots;
  constexpr uint32_t kUnlabeled = 0xFFFFFFFFu;   // above every label
  const int sub = threadIdx.x & (G - 1);
  const int64_t at = static_cast<int64_t>(row < 0 ? 0 : row) * m.d;
  const int turns = (m.d + G - 1) / G;                   // warp-uniform
  uint32_t lab[kT];
#pragma unroll
  for (int k = 0; k < kT; ++k) {
    const int j = k * G + sub;
    lab[k] = k < turns && vid >= 0 && j < m.d
                 ? static_cast<uint32_t>(slot_label(r, m, at + j, vid))
                 : kUnlabeled;                  // slot_label's -1 too
  }
  Pick best{0, kNone, kNone};
  for (;;) {
    uint32_t mine = kUnlabeled;
#pragma unroll
    for (int k = 0; k < kT; ++k) mine = lab[k] < mine ? lab[k] : mine;
    const uint32_t label = group_min<G>(mine);
    if (__ballot_sync(kFull, label != kUnlabeled) == 0u) break;
    int32_t c = 0;
#pragma unroll
    for (int k = 0; k < kT; ++k) {
      const bool same = lab[k] == label;
      c += same ? 1 : 0;
      lab[k] = same ? kUnlabeled : lab[k];
    }
    c = group_reduce<G>(c, AddOp{});
    if (label != kUnlabeled && c >= best.c) {
      const auto l = static_cast<int32_t>(label);
      best = better_of({c, aggregate_size(r, l), l}, best);
    }
  }
  return best;
}

// row_pick for a map whose lanes keep more than kJoinLaneSlots slots of a
// row (D > 32 * kJoinLaneSlots: a padded ELL of a small graph with a hub):
// each lane counts the valid slots holding the label of each of its own,
// chunk by chunk of G slots through shuffles, loading the labels again
template <int G>
__device__ __forceinline__ Pick row_pick_wide(const Join& r,
                                              const MapView& m, int32_t row,
                                              int32_t vid) {
  const int sub = threadIdx.x & (G - 1);
  const int first = (threadIdx.x & 31) & ~(G - 1);
  const int64_t at = static_cast<int64_t>(row < 0 ? 0 : row) * m.d;
  Pick best{0, kNone, kNone};
  for (int q = 0; q < m.d; q += G) {                     // warp-uniform
    const int32_t lj =
        vid >= 0 && q + sub < m.d ? slot_label(r, m, at + q + sub, vid) : -1;
    int32_t c = 0;
    for (int k0 = 0; k0 < m.d; k0 += G) {
      const int32_t lk = vid >= 0 && k0 + sub < m.d
                             ? slot_label(r, m, at + k0 + sub, vid) : -1;
#pragma unroll
      for (int t = 0; t < G; ++t) {
        c += __shfl_sync(kFull, lk, first + t) == lj ? 1 : 0;
      }
    }
    if (lj >= 0) best = better_of({c, aggregate_size(r, lj), lj}, best);
  }
  return group_pick<G>(best);
}

// a table slot's word: from the block's shared table as it is, from the
// global one through L2
__device__ __forceinline__ int32_t table_load(const int32_t* p, bool shared) {
  return shared ? *p : state_load<kCoherent>(p);
}

// phase 3 of heavy row hh, by the whole block: its valid labels counted in
// a hash table, the block's shared `table` where twice the row's entries
// fit in kHeavySlots, else the row's span of keys / cnts, then the pick
// reduced over the table; the label picked, or -1 (on every thread)
__device__ __forceinline__ int32_t heavy_pick(const Join& r, int32_t hh,
                                              Pick* picks, int32_t* table) {
  const int32_t start = state_load<kCoherent>(r.hoff + hh);
  const int32_t end = state_load<kCoherent>(r.hoff + hh + 1);
  const int32_t row = r.spill_rows[hh];
  const uint32_t cap = 2u * static_cast<uint32_t>(end - start);
  const bool shared = cap <= kHeavySlots;
  int32_t* keys = shared ? table : r.keys + 2 * static_cast<int64_t>(start);
  int32_t* cnts = shared ? table + kHeavySlots
                         : r.cnts + 2 * static_cast<int64_t>(start);
  for (uint32_t t = threadIdx.x; t < cap; t += kThreads) {
    keys[t] = -1;
    cnts[t] = 0;
  }
  __syncthreads();
  for (int32_t i = start + threadIdx.x; i < end; i += kThreads) {
    const int32_t u = r.spill_cols[i];
    if (u == row) continue;
    const int32_t l = state_load<kCoherent>(r.labels + u);
    if (l < 0) continue;
    uint32_t t = (static_cast<uint32_t>(l) * 2654435761u) % cap;
    for (;;) {
      const int32_t prev = atomicCAS(keys + t, -1, l);
      if (prev == -1 || prev == l) {
        atomicAdd(cnts + t, 1);
        break;
      }
      t = t + 1 == cap ? 0 : t + 1;
    }
  }
  __syncthreads();
  Pick best{0, kNone, kNone};
  for (uint32_t t = threadIdx.x; t < cap; t += kThreads) {
    const int32_t l = table_load(keys + t, shared);
    if (l >= 0) {
      best = better_of({table_load(cnts + t, shared), aggregate_size(r, l), l},
                       best);
    }
  }
  best = group_pick<32>(best);
  if ((threadIdx.x & 31) == 0) picks[threadIdx.x >> 5] = best;
  __syncthreads();
  for (int k = 0; k < kWarps; ++k) best = better_of(picks[k], best);
  __syncthreads();
  return best.c > 0 ? best.l : -1;
}

__global__ void __launch_bounds__(kThreads, kJoinMinBlocks)
phase3_fixed_point_kernel(const __grid_constant__ Join r) {
  __shared__ int32_t words[kWarps + 1];
  __shared__ Pick picks[kWarps];
  __shared__ int32_t table[2 * kHeavySlots];
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = global_tid();
  const int64_t stride = global_stride();
  if (tid == 0) {
    for (int k = 0; k < 4; ++k) r.ctl[k] = 0;
    for (int s = 0; s < r.num_maps; ++s) {
      *map_count(r, s, 0) = *map_count(r, s, 1) = 0;
    }
  }
  for (int64_t i = tid; i <= r.v; i += stride) r.vert[i] = 0;
  for (int64_t i = tid; i < r.v; i += stride) {
    r.labels[i] = r.labels_in[i];
    r.phase[i] = r.phase_in[i];
  }
  // heavy row k's entries start at hoff[k] (hoff[H] = E), empty rows too
  for (int64_t i = tid; i <= r.e; i += stride) {
    const int64_t lo = i == 0 ? 0 : r.spill_seg[i - 1] + 1;
    const int64_t hi = i == r.e ? r.h : r.spill_seg[i];
    for (int64_t k = lo; k <= hi; ++k) r.hoff[k] = static_cast<int32_t>(i);
  }
  grid.sync();
  // the aggregate sizes, a warp's 32 rows at a time, and the unlabeled
  // rows listed
  int32_t left = 0;
  for (int64_t i0 = tid - (threadIdx.x & 31); i0 < r.v; i0 += stride) {
    const int64_t i = i0 + (threadIdx.x & 31);
    warp_count(r, i < r.v ? r.labels_in[i] : -1);
  }
  for (int s = 0; s < r.num_maps; ++s) {
    const MapView m = map_view(r, s);
    rows_loop<1, true>(m, nullptr, m.r,
                       [&](auto, int64_t, int32_t row, int32_t vid) {
      const bool keep = vid >= 0 && r.labels_in[vid] < 0;
      left += keep ? 1 : 0;
      block_append(keep, row, map_list(r, m, 0), map_count(r, s, 0), words);
    });
  }
  for (int64_t h = tid; h < r.h; h += stride) {
    if (r.labels_in[r.spill_rows[h]] < 0) {
      heavy_list(r, 0)[atomicAdd(r.ctl + 2, 1)] = static_cast<int32_t>(h);
      ++left;
    }
  }
  add_left(left, r.ctl, words);
  grid.sync();
  for (int rnd = 0; rnd < r.rounds; ++rnd) {
    const int cur = rnd & 1;
    const int nxt = cur ^ 1;
    if (state_load<kCoherent>(r.ctl + cur) == 0) break;
    if (tid == 0) {      // the counters this round fills
      r.ctl[nxt] = r.ctl[2 + nxt] = 0;
      for (int s = 0; s < r.num_maps; ++s) *map_count(r, s, nxt) = 0;
    }
    // each listed row's pick against the round-start labels and sizes
    for (int s = 0; s < r.num_maps; ++s) {
      const MapView m = map_view(r, s);
      const int64_t n = state_load<kCoherent>(map_count(r, s, cur));
      for_rows(m, map_list(r, m, cur), n,
               [&](auto gg, int64_t slot, int32_t row, int32_t vid) {
        constexpr int G = decltype(gg)::value;
        const Pick p = m.d <= G * kJoinLaneSlots
                           ? row_pick<G>(r, m, row, vid)
                           : row_pick_wide<G>(r, m, row, vid);
        if ((threadIdx.x & (G - 1)) == 0 && vid >= 0) {
          r.fresh[m.off + slot] = p.c > 0 ? p.l : -1;
        }
      });
    }
    const int32_t nh = state_load<kCoherent>(r.ctl + 2 + cur);
    for (int32_t i = blockIdx.x; i < nh; i += gridDim.x) {   // block-uniform
      const int32_t l = heavy_pick(
          r, state_load<kCoherent>(heavy_list(r, cur) + i), picks, table);
      if (threadIdx.x == 0) r.fresh[r.sum_r + i] = l;
    }
    grid.sync();
    // commit: labels, marks and sizes; the rows still unlabeled listed
    left = 0;
    for (int s = 0; s < r.num_maps; ++s) {
      const MapView m = map_view(r, s);
      const int64_t n = state_load<kCoherent>(map_count(r, s, cur));
      rows_loop<1, true>(m, map_list(r, m, cur), n,
                         [&](auto, int64_t slot, int32_t row, int32_t vid) {
        bool keep = false;
        int32_t joined = -1;
        if (vid >= 0) {
          const int32_t l = state_load<kCoherent>(r.fresh + m.off + slot);
          if (l >= 0) {
            r.labels[vid] = l;
            r.phase[vid] = 3;
            joined = l;
          } else {
            keep = true;
            ++left;
          }
        }
        warp_count(r, joined);
        block_append(keep, row, map_list(r, m, nxt), map_count(r, s, nxt),
                     words);
      });
    }
    for (int64_t i = tid; i < nh; i += stride) {
      const int32_t hh = state_load<kCoherent>(heavy_list(r, cur) + i);
      const int32_t l = state_load<kCoherent>(r.fresh + r.sum_r + i);
      const int32_t row = r.spill_rows[hh];
      if (l >= 0) {
        r.labels[row] = l;
        r.phase[row] = 3;
        atomicAdd(r.vert + (l < r.v ? l : r.v), 1);
      } else {
        heavy_list(r, nxt)[atomicAdd(r.ctl + 2 + nxt, 1)] = hh;
        ++left;
      }
    }
    add_left(left, r.ctl + nxt, words);
    grid.sync();
  }
}

// one cooperative launch of `kernel` on `blocks` blocks (0: every block
// that fits on the card)
template <typename Kernel>
int launch(Kernel kernel, Join& r, int blocks, void* stream) {
  int dev = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (coop == 0) return static_cast<int>(cudaErrorNotSupported);
  const int grid = blocks > 0 ? blocks : resident_blocks(kernel);
  if (grid > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&r};
  const cudaError_t status = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kThreads), args,
      0, static_cast<cudaStream_t>(stream));
  if (status != cudaSuccess) {
    cudaGetLastError();          // a refused launch leaves no error behind
    return static_cast<int>(status);
  }
  return static_cast<int>(cudaGetLastError());
}

Join make_join(const void* maps, int num_maps, const void* spill_rows,
               const void* spill_seg, const void* spill_cols, int64_t h,
               int64_t e, int64_t v, int64_t sum_r, void* scratch,
               bool table) {
  const ScratchLayout x = scratch_layout(num_maps, sum_r, h, e, v, table);
  auto* w = static_cast<int32_t*>(scratch);
  Join r{};
  r.maps = static_cast<const JoinMap*>(maps);
  r.spill_rows = static_cast<const int32_t*>(spill_rows);
  r.spill_seg = static_cast<const int32_t*>(spill_seg);
  r.spill_cols = static_cast<const int32_t*>(spill_cols);
  r.ctl = w;
  r.sums = w + x.sums;
  r.vert = w + x.vert;
  r.lists = w + x.lists;
  r.fresh = w + x.fresh;
  r.heavy = reinterpret_cast<uint32_t*>(w + x.heavy);
  r.hoff = w + x.hoff;
  r.keys = table ? w + x.keys : nullptr;
  r.cnts = table ? w + x.cnts : nullptr;
  r.v = v;
  r.h = h;
  r.e = e;
  r.sum_r = sum_r;
  r.num_maps = num_maps;
  return r;
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// G, the lanes a row of d slots takes in every join
int join_lanes(int d) { return repro_torch::join_lanes(d); }

// int32 words of a join's scratch (table: phase 3's hash tables)
int64_t join_scratch_words(int num_maps, int64_t sum_r, int64_t h, int64_t e,
                           int64_t v, int table) {
  return repro_torch::scratch_layout(num_maps, sum_r, h, e, v, table != 0)
      .total;
}

// Every entry point: maps, the [S, 7] int64 table on the card (JoinMap);
// the spill's rows [H], seg and cols [E] (H = 0 for the padded ELL); v
// vertices, sum_r the maps' rows; scratch: join_scratch_words int32
// words; blocks: the grid (0: every block that fits on the card).
// Returns cudaErrorNotSupported where the card has no cooperative launch,
// cudaErrorInvalidValue for a grid past kMaxBlocks, and the launch's error
// (cudaErrorCooperativeLaunchTooLarge among them).

// Root join (roots: bool [V]) then up to `rounds` cleanup rounds, or (roots
// null) the cleanup alone from labels_in / phase_in.  Writes labels int32
// [V], phase uint8 [V] and out [2]: the aggregates (0 without roots) and
// the rows left unlabeled.
int root_join(const void* maps, int num_maps, const void* spill_rows,
              const void* spill_seg, const void* spill_cols, int64_t h,
              int64_t e, const void* roots, const void* labels_in,
              const void* phase_in, void* labels, void* phase, void* scratch,
              void* out, int64_t v, int64_t sum_r, int rounds, int blocks,
              void* stream) {
  using namespace repro_torch;
  Join r = make_join(maps, num_maps, spill_rows, spill_seg, spill_cols, h, e,
                     v, sum_r, scratch, false);
  r.roots = static_cast<const uint8_t*>(roots);
  r.labels_in = static_cast<const int32_t*>(labels_in);
  r.phase_in = static_cast<const uint8_t*>(phase_in);
  r.labels = static_cast<int32_t*>(labels);
  r.phase = static_cast<uint8_t*>(phase);
  r.out = static_cast<int32_t*>(out);
  r.rounds = rounds;
  return launch(root_join_kernel, r, blocks, stream);
}

// Alg. 3 phase 2: from labels_in / phase_in, the second set in_set2 (bool
// [V]) and the aggregates so far nagg_in [1], writes labels, phase, roots2
// (bool [V]) and out [1], the aggregates after.
int phase2_join(const void* maps, int num_maps, const void* spill_rows,
                const void* spill_seg, const void* spill_cols, int64_t h,
                int64_t e, const void* labels_in, const void* phase_in,
                const void* in_set2, const void* nagg_in, void* labels,
                void* phase, void* roots2, void* scratch, void* out,
                int64_t v, int64_t sum_r, int min_secondary, int blocks,
                void* stream) {
  using namespace repro_torch;
  Join r = make_join(maps, num_maps, spill_rows, spill_seg, spill_cols, h, e,
                     v, sum_r, scratch, false);
  r.labels_in = static_cast<const int32_t*>(labels_in);
  r.phase_in = static_cast<const uint8_t*>(phase_in);
  r.in_set2 = static_cast<const uint8_t*>(in_set2);
  r.nagg_in = static_cast<const int32_t*>(nagg_in);
  r.labels = static_cast<int32_t*>(labels);
  r.phase = static_cast<uint8_t*>(phase);
  r.roots2 = static_cast<uint8_t*>(roots2);
  r.out = static_cast<int32_t*>(out);
  r.min_secondary = min_secondary;
  return launch(phase2_join_kernel, r, blocks, stream);
}

// Alg. 3 phase 3: up to `rounds` max-coupling rounds from labels_in /
// phase_in; writes labels and phase.  scratch: with the hash tables.
int phase3_fixed_point(const void* maps, int num_maps, const void* spill_rows,
                       const void* spill_seg, const void* spill_cols,
                       int64_t h, int64_t e, const void* labels_in,
                       const void* phase_in, void* labels, void* phase,
                       void* scratch, int64_t v, int64_t sum_r, int rounds,
                       int blocks, void* stream) {
  using namespace repro_torch;
  Join r = make_join(maps, num_maps, spill_rows, spill_seg, spill_cols, h, e,
                     v, sum_r, scratch, true);
  r.labels_in = static_cast<const int32_t*>(labels_in);
  r.phase_in = static_cast<const uint8_t*>(phase_in);
  r.labels = static_cast<int32_t*>(labels);
  r.phase = static_cast<uint8_t*>(phase);
  r.rounds = rounds;
  return launch(phase3_fixed_point_kernel, r, blocks, stream);
}

}  // extern "C"
