// The two passes of one MIS-2 round: fused over padded ELL and over one
// slab of the degree-aware hybrid layout (the device-resident drivers), and
// unfused over pre-gathered worklist rows (the host-driven driver); and the
// whole resident fixed point over padded ELL in one cooperative launch.
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
// The three share one body per pass (refresh_group_body,
// decide_group_body) over a row map: a worklist entry is a row of the
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
//
// The resident fixed point (resident_fixed_point_kernel) replaces the
// reference's one jitted lax.while_loop (repro/core/mis2.py:
// _resident_ell_fixed_point with use_pallas: the two fused Pallas passes a
// round and compact_worklist on the device), which the port ran as ~35
// launches and one blocking read of the live count a round.  It is one
// cooperative launch of a grid sized to the work (a block for each 256
// rows, at most the blocks that fit on the card at once): every round runs
// the fused refresh over the M worklist and the fused decide over the
// undecided worklist, a grid sync after each, until no row is undecided or
// max_iters rounds ran; the round lives in a register, and the host reads
// nothing until the solve ends (the rounds run and the last live count go
// to a two-word output).  The passes are the bodies above, instantiated
// with coherent loads (ld.global.cg) of the state other blocks write inside
// the launch -- T, M, h, the worklists and their counts -- where the
// standalone kernels may take the read-only path; the ELL ids and the mask
// keep it.  Every body strides over warps and returns early nowhere, so
// every block reaches every grid sync.
//
// The lists are built by the passes that decide what they hold, so no
// pass of its own re-reads them.  A round's undecided rows are a subset of
// its undecided worklist (a decided row stays decided), and its rows with
// M != OUT a subset of its M worklist (refresh writes only those rows;
// every other row's M was OUT already).  So the refresh appends each row
// whose new M is not OUT to the next M list, and the decide each row it
// leaves undecided to the next undecided list: a block reserves its
// survivors' slots with one atomicAdd and writes them side by side
// (grid.cuh's block_append; a warp's atomic each, 31,250 on one count a pass
// over a million rows, cost more than the compaction passes they replaced),
// every warp of a block taking the same turns.  The order of a list then
// follows the atomics, which changes nothing: every row reads state the
// last grid sync froze and writes only its own words.  Two buffers a list,
// swapped each round; a list's count is zeroed in the phase before the one
// that appends to it, after every block read it.  At wide rows the decide
// also writes each of its rows' refreshed tuple for the next round into h
// (its final T where it was decided; every other row's h holds its final T
// already), so the next refresh reads h as the per-vertex pass's output,
// with no pass over all V and no sync of its own.  The slice-17 design ran
// that per-vertex pass and compacted both lists over themselves in two
// passes of their own, five grid syncs a round at wide rows and four at
// short ones.
//
// The same kernel runs two more fixed points of the reference in one launch
// each.  resident_fixed_point_batched: a bucket of graphs as one
// block-diagonal ELL (src/repro/batch/pipeline.py:60-65, the vmapped dense
// fixed point): no row reaches another member's, so only the hash needs the
// member (hash.cuh's Members: the local id and the member's bits), and each
// member with a row on the round's undecided list takes the round + 1 as its
// count, one atomicMax a warp's group of that member's rows
// (__match_any_sync), as luby_fixed_point_batched counts its done rounds (a
// member that stops never goes on, so the last value is its count).
// resident_fixed_point_seeded: the streaming repair
// (src/repro/core/mis2.py:192-236), from the T it is given, every row
// active, the first undecided list T's undecided rows.  Both are bit for bit
// the reference's dense rounds for the same reason the single-graph solve is:
// a decided row stays decided and an M that is OUT stays OUT.
//
// Bound: memory, the least bytes of the passes at the rounds run (each
// input read once and each output written once a round; chip_smoke.py
// counts them from the twin's live counts), against which a solve also pays
// two grid syncs a round and its prologue (state, the identity M list, the
// first undecided list; two syncs).  One instance per (G, C, priority) the
// width picks: G = 1 and the hash inline below kHashOnceMinD, the group
// shape with chunks of kChunk and the refresh reading h (hashed with its
// kind read at run time) from there.
// The register cap is 4 blocks an SM for every instance.  On an H100 80GB
// HBM3 at 700 W a whole solve took 0.311 ms on Laplace3D_100 and 0.850 ms
// on Elasticity3D_60, against the slice-17 design's 0.449 / 1.335 and 0.439
// / 1.567 at 8 blocks an SM (32 registers, every instance spilled), all in
// one call (tools/bench_resident.py --caps --baseline: each round's cost,
// the prologue's, PERF.md section 6); the least bytes bound them at 0.081 /
// 0.452 ms.

#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "compact.cuh"
#include "grid.cuh"
#include "hash.cuh"
#include "spill.cuh"

namespace repro_torch {
namespace {

namespace cg = cooperative_groups;

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

// The row maps of the two bodies: what the row of a worklist slot is, and
// which vertex keys its T, M and hash
constexpr int kPadded = 0;  // wl[slot], a row of the padded ELL: its vertex
constexpr int kSlab = 1;    // wl[slot], a slab row: vertex slab_rows[row]
constexpr int kCopy = 2;    // row `slot` of a pre-gathered copy; the result
                            // goes to slot `slot` of a [W] output

// G: the smallest power of two, at most 32, that leaves a lane at most
// kLaneSlots of a row's d slots
int group_lanes(int d) { return row_lanes(d, kLaneSlots); }

// G for a slab of r rows: doubled from group_lanes while R * G is short
// of kSlabFillLanes and each lane keeps two slots of a row at least
int slab_group_lanes(int d, int64_t r) {
  return filled_row_lanes(d, r, kLaneSlots, kSlabFillLanes);
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
template <bool kCoh>
__device__ __forceinline__ int32_t slot_row(const int32_t* __restrict__ wl,
                                            int64_t slot, int64_t n,
                                            int64_t rows) {
  if (slot >= n) return -1;
  const int32_t row = state_load<kCoh>(wl + slot);
  return row >= 0 && row < rows ? row : -1;
}

// the row of a warp's batch slot `lane` (B slots a batch), or -1; in a
// copy the slot itself, live below `rows` (there the host's count)
template <int B, int Map, bool kCoh>
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
    return slot_row<kCoh>(wl, base + lane, n, rows);
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

// What a pass does with each row's new word beyond storing it: nothing in
// the standalone kernels; the resident fixed point's sinks list the rows
// that stay live for the next round (every lane of a warp calls it, row -1
// for a slot without a row)
struct NoSink {
  static constexpr bool kByBlock = false;
  __device__ __forceinline__ void operator()(int32_t, uint32_t) const {}
};

// the slot a warp's batch loop stops before: n itself, or for a sink that
// appends a block at a time n plus the warp's lead over its block's first
// warp, so that every warp of a block takes the same turns (a turn past n
// holds no row)
template <class Sink>
__device__ __forceinline__ int64_t batch_end(int64_t n, int64_t warp,
                                             int batch) {
  if constexpr (Sink::kByBlock) {
    return n + (warp & (kWarps - 1)) * batch;
  } else {
    return n;
  }
}

// M at the vertex of every live worklist row: the min over the row's ids
// of the refreshed tuples, IN -> OUT.  `src` holds them already (kOnce) or
// is T, refreshed here per slot (the priority `kind` read at run time where
// Kind is kAnyKind).  A warp takes B = S * 32 / G worklist
// slots a batch: S = G (32 slots) in the padded ELL and a copy, S = 1 in a
// slab.  `n`: the slots visited; `rows`: the adjacency's rows, or a copy's
// live count; a copy's M goes to m[slot], OUT at a dead slot.
template <int G, int S, int C, bool kOnce, int Kind, int Map, bool kCoh,
          class Sink = NoSink>
__device__ __forceinline__ void refresh_group_body(
    const uint32_t* __restrict__ src, uint32_t* __restrict__ m,
    const int32_t* __restrict__ nbrs, const int32_t* __restrict__ wl,
    int64_t n, uint32_t it, int64_t rows, int64_t w, int d, int b,
    const int32_t* __restrict__ slab_rows, int kind = Kind,
    const Members& mem = Members{}, const Sink& sink = Sink{}) {
  constexpr int kBatch = S * (32 / G);
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const int grp = lane / G;
  const int turns = (d + G - 1) / G;
  const RoundPriority<Kind> prio(it, kind);
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  const int64_t end = batch_end<Sink>(n, warp, kBatch);
  for (int64_t base = warp * kBatch; base < end; base += warps * kBatch) {
    if constexpr (Map == kCopy) {
      if (base >= rows) {          // a batch of dead slots: OUT, no loads
        if (base + lane < w) m[base + lane] = kOut;
        continue;
      }
    }
    const int32_t row = batch_row<kBatch, Map, kCoh>(wl, base, lane, n, rows);
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
          x[c] = nb[c] >= 0 ? state_load<kCoh>(src + nb[c]) : kOut;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (!kOnce && nb[c] >= 0 && is_undecided(x[c])) {
            x[c] = tuple_of(prio, static_cast<uint32_t>(nb[c]), b, mem);
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
      sink(row, res == kIn ? kOut : res);
    }
  }
}

template <int G, int S, int C, bool kOnce, int Kind, int Map>
__global__ void __launch_bounds__(kThreads, min_blocks<C>())
refresh_group_kernel(
    const uint32_t* __restrict__ src, uint32_t* __restrict__ m,
    const int32_t* __restrict__ nbrs, const int32_t* __restrict__ wl,
    const int32_t* __restrict__ count, const uint32_t* __restrict__ it_ptr,
    int64_t rows, int64_t w, int d, int b,
    const int32_t* __restrict__ slab_rows) {
  refresh_group_body<G, S, C, kOnce, Kind, Map, kPlain>(
      src, m, nbrs, wl, visited_slots<Map>(count, w), kOnce ? 0u : *it_ptr,
      rows, w, d, b, slab_rows);
}

// T at the vertex of every live undecided worklist row <- OUT if an active
// neighbour's M is OUT, else IN if every active neighbour's M equals the
// row's refreshed tuple, else that tuple; decided rows are left as they
// are.  Reads T only at its own vertex.  Without `active` (kGated false) a
// neighbour is active where its M is not IN, one gather a slot.  Batches
// as refresh_group_body.  A copy takes each row's tuple from t_rows[slot]
// as it is, and writes the result to t[slot]: the tuple itself at a dead
// slot or a decided row.
template <int G, int S, int C, bool kGated, int Map, bool kCoh,
          class Sink = NoSink>
__device__ __forceinline__ void decide_group_body(
    uint32_t* __restrict__ t, const uint32_t* __restrict__ m,
    const uint8_t* __restrict__ active, const int32_t* __restrict__ nbrs,
    const int32_t* __restrict__ wl, int64_t n, uint32_t it, int64_t rows,
    int64_t w, int d, int b, int kind,
    const int32_t* __restrict__ slab_rows,
    const uint32_t* __restrict__ t_rows, const Members& mem = Members{},
    const Sink& sink = Sink{}) {
  constexpr int kBatch = S * (32 / G);
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const int grp = lane / G;
  const int turns = (d + G - 1) / G;
  const uint32_t gbits = group_bits<G>(grp);
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  const int64_t end = batch_end<Sink>(n, warp, kBatch);
  for (int64_t base = warp * kBatch; base < end; base += warps * kBatch) {
    if constexpr (Map == kCopy) {
      if (base >= rows) {          // a batch of dead slots keeps its tuples
        if (base + lane < w) t[base + lane] = t_rows[base + lane];
        continue;
      }
    }
    int32_t row = batch_row<kBatch, Map, kCoh>(wl, base, lane, n, rows);
    const int32_t vid = vertex_of<Map>(row, slab_rows);
    uint32_t tv = 0;
    if constexpr (Map == kCopy) {
      tv = base + lane < w ? t_rows[base + lane] : 0u;
      if (!is_undecided(tv)) row = -1;
    } else {
      // in the padded ELL a row is its vertex: `row` alone keys T there
      if (row >= 0) {
        if (is_undecided(state_load<kCoh>(t + (Map == kSlab ? vid : row)))) {
          tv = fresh_of(kind, it,
                        static_cast<uint32_t>(Map == kSlab ? vid : row), b,
                        mem);
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
            mv[c] = nb[c] >= 0 ? state_load<kCoh>(m + nb[c]) : 0u;
            av[c] = nb[c] >= 0 ? active[nb[c]] : 0u;
          } else {
            mv[c] = nb[c] >= 0 ? state_load<kCoh>(m + nb[c]) : kIn;
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
      sink(row, res);
    }
  }
}

template <int G, int S, int C, bool kGated, int Map>
__global__ void __launch_bounds__(kThreads, min_blocks<C>())
decide_group_kernel(
    uint32_t* __restrict__ t, const uint32_t* __restrict__ m,
    const uint8_t* __restrict__ active, const int32_t* __restrict__ nbrs,
    const int32_t* __restrict__ wl, const int32_t* __restrict__ count,
    const uint32_t* __restrict__ it_ptr, int64_t rows, int64_t w, int d,
    int b, int kind, const int32_t* __restrict__ slab_rows,
    const uint32_t* __restrict__ t_rows) {
  decide_group_body<G, S, C, kGated, Map, kPlain>(
      t, m, active, nbrs, wl, visited_slots<Map>(count, w),
      round_of<Map>(it_ptr), rows, w, d, b, kind, slab_rows, t_rows);
}

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

// ---------------------------------------------------------------------------
// the resident fixed point: every round in one cooperative launch
// ---------------------------------------------------------------------------

// blocks an SM must hold for the persistent kernel (a register cap over
// both passes and their sinks, and the grid each sync waits for)
constexpr int kResidentMinBlocks = 4;
constexpr int kUndecided = 0;  // the lists: undecided rows (wl1) ...
constexpr int kLiveM = 1;      // ... and rows whose M is not OUT (wl2)
// worklist slots a block's warps take in one batch each (B = 32 a warp in
// the padded ELL), which sizes the grid to V
constexpr int64_t kResidentRowsPerBlock = kWarps * 32;

// The solve's buffers.  wl[l][k]: list l's buffer k, [V] int32 each;
// counts[2 * l + k]: its live slots; out: the rounds run and the last live
// count of wl1.  A bucket of graphs (mem.bits set) also writes its[j], the
// rounds in which member j had an undecided row; a seeded solve starts
// from the T it is given instead of from `active`.
struct Resident {
  uint32_t* t;
  uint32_t* m;
  uint32_t* h;                 // the wide rows' refreshed tuples
  const uint8_t* active;
  const int32_t* nbrs;
  int32_t* wl[2][2];
  int32_t* counts;
  int32_t* out;
  int64_t v;
  int d;
  int b;
  int kind;
  int max_iters;
  Members mem;                 // a bucket's members (bits null: one graph)
  int32_t* its;                // [members], a bucket's round counts
  int64_t members;
  int seeded;                  // T given: the first list its undecided rows
};

// buffer k of list L (a select, so the parameter struct is never indexed
// at run time)
template <int L>
__device__ __forceinline__ int32_t* list_buffer(const Resident& r, int k) {
  return k != 0 ? r.wl[L][1] : r.wl[L][0];
}

// The refresh's sink: each row whose new M is not OUT appended to the
// next M list, a block's rows with one atomicAdd (a warp's each took one
// atomic on the one count, 31,250 a pass over a million rows, which cost
// more than the compaction they replaced)
struct LiveMSink {
  static constexpr bool kByBlock = true;
  int32_t* list;
  int32_t* count;
  int32_t* words;

  __device__ __forceinline__ void operator()(int32_t row, uint32_t mv) const {
    block_append(row >= 0 && mv != kOut, row, list, count, words);
  }
};

// The decide's sink: each row still undecided appended to the next
// undecided list; at wide rows (kOnce) h[row] <- the row's tuple of round
// it + 1, or its final T where it was decided (every other row's h holds
// its final T already, so h is the next round's refreshed T); in a bucket,
// each member with a row here takes it + 1 as its rounds, one atomicMax a
// member group of the warp (a member stops for good, so the last is its
// count)
template <bool kOnce>
struct UndecidedSink {
  static constexpr bool kByBlock = true;
  int32_t* list;
  int32_t* count;
  int32_t* words;
  uint32_t* h;
  int32_t* its;
  Members mem;
  uint32_t it;
  int kind;
  int b;

  __device__ __forceinline__ void operator()(int32_t row, uint32_t tv) const {
    const bool keep = row >= 0 && is_undecided(tv);
    block_append(keep, row, list, count, words);
    if constexpr (kOnce) {
      if (row >= 0) {
        h[row] = keep ? fresh_of(kind, it + 1u, static_cast<uint32_t>(row),
                                 b, mem)
                      : tv;
      }
    }
    if (its != nullptr) {
      const int32_t j = row >= 0 ? row >> mem.shift : -1;
      const uint32_t peers = __match_any_sync(kFull, j);
      if (j >= 0 && static_cast<int>(threadIdx.x & 31) ==
                        __ffs(static_cast<int>(peers)) - 1) {
        atomicMax(its + j, static_cast<int32_t>(it + 1u));
      }
    }
  }
};

// The §V-B fixed point over padded ELL, from `active`: round 0's state is
// T = 1 on the active rows and OUT elsewhere (or the seeded T as given),
// M = OUT, wl1 the active rows (the seeded T's undecided ones) and wl2
// every row.  Each round: (a) the fused refresh over wl2, each row whose M
// stays live appended to the next wl2 by its warp; (b) the fused decide over
// wl1, each row still undecided appended to the next wl1 (at wide rows, the
// next round's refreshed tuples into h; a bucket's round counts); a grid
// sync after each.  A list's order changes nothing: every row reads state
// frozen by the last sync and writes only its own words.  A list's count is
// zeroed in the phase before the one that appends to it, after every block
// read it.  A bucket of graphs is one block-diagonal ELL: no row reaches
// another member's, so only the hash needs the member (r.mem).
template <int G, int C, bool kOnce, int Kind>
__global__ void __launch_bounds__(kThreads, kResidentMinBlocks)
resident_fixed_point_kernel(const __grid_constant__ Resident r) {
  __shared__ int32_t words[kWarps + 1];
  cg::grid_group grid = cg::this_grid();
  const int64_t v = r.v;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (tid == 0) {   // round 0's M list is every row; the rest fill later
    for (int k = 0; k < 4; ++k) r.counts[k] = 0;
    r.counts[2 * kLiveM] = static_cast<int32_t>(v);
  }
  for (int64_t i = tid; i < v; i += stride) {
    const uint32_t t0 = r.seeded != 0 ? r.t[i] : r.active[i] != 0 ? 1u : kOut;
    if (r.seeded == 0) r.t[i] = t0;
    r.m[i] = kOut;
    list_buffer<kLiveM>(r, 0)[i] = static_cast<int32_t>(i);
    if constexpr (kOnce) {   // round 0's refreshed tuples
      r.h[i] = is_undecided(t0)
                   ? fresh_of(r.kind, 0u, static_cast<uint32_t>(i), r.b,
                              r.mem)
                   : t0;
    }
  }
  for (int64_t j = tid; j < r.members; j += stride) r.its[j] = 0;
  grid.sync();
  // round 0's undecided list, a block's kThreads rows at a time
  for (int64_t i0 = tid - threadIdx.x; i0 < v; i0 += stride) {
    const int64_t i = i0 + threadIdx.x;
    bool keep = false;
    if (i < v) keep = r.seeded != 0 ? is_undecided(r.t[i]) : r.active[i] != 0;
    block_append(keep, static_cast<int32_t>(i), list_buffer<kUndecided>(r, 0),
                 r.counts + 2 * kUndecided, words);
  }
  grid.sync();
  int cur = 0;
  uint32_t it = 0;
  int64_t n1 = 0;
  for (;;) {
    n1 = state_load<kCoherent>(r.counts + 2 * kUndecided + cur);
    const int64_t n2 = state_load<kCoherent>(r.counts + 2 * kLiveM + cur);
    if (n1 == 0 || it >= static_cast<uint32_t>(r.max_iters)) break;
    const int nxt = cur ^ 1;
    if (tid == 0) r.counts[2 * kUndecided + nxt] = 0;   // (b) appends to it
    refresh_group_body<G, G, C, kOnce, Kind, kPadded, kCoherent>(
        kOnce ? r.h : r.t, r.m, r.nbrs, list_buffer<kLiveM>(r, cur), n2, it,
        v, v, r.d, r.b, nullptr, Kind, r.mem,
        LiveMSink{list_buffer<kLiveM>(r, nxt), r.counts + 2 * kLiveM + nxt,
                  words});
    grid.sync();
    if (tid == 0) r.counts[2 * kLiveM + cur] = 0;       // next round's (a)
    decide_group_body<G, G, C, true, kPadded, kCoherent>(
        r.t, r.m, r.active, r.nbrs, list_buffer<kUndecided>(r, cur), n1, it,
        v, v, r.d, r.b, r.kind, nullptr, nullptr, r.mem,
        UndecidedSink<kOnce>{list_buffer<kUndecided>(r, nxt),
                             r.counts + 2 * kUndecided + nxt, words, r.h,
                             r.its, r.mem, it, r.kind, r.b});
    grid.sync();
    cur = nxt;
    ++it;
  }
  if (tid == 0) {
    r.out[0] = static_cast<int32_t>(it);
    r.out[1] = static_cast<int32_t>(n1);
  }
}

// f(Int<G>, Int<C>, Int<kOnce>, Int<Kind>) for the one instance width d
// takes: below kHashOnceMinD G = 1 (group_lanes) with the hash inline, C
// from d and the kind a template; from there the group shape, whose lanes
// then hold over half of kLaneSlots of a row (or all of it at G = 1), so
// C = kChunk, and the refresh reading h, whose tuples the prologue and the
// decide hash with the kind read at run time.
// Returns false where that C is not the one chunk_slots picks.
template <typename F>
bool with_resident_shape(int d, int kind, F&& f) {
  const int g = group_lanes(d);
  if (d < kHashOnceMinD) {
    with_kind(kind, [&](auto k) {
      with_chunk<1>(chunk_slots(1, d), [&](auto gg, auto cc) {
        f(gg, cc, Int<0>{}, k);
      });
    });
    return true;
  }
  if (chunk_slots(g, d) != kChunk) return false;
  switch (g) {
    case 1: f(Int<1>{}, Int<kChunk>{}, Int<1>{}, Int<kXorshiftStar>{}); break;
    case 2: f(Int<2>{}, Int<kChunk>{}, Int<1>{}, Int<kXorshiftStar>{}); break;
    case 4: f(Int<4>{}, Int<kChunk>{}, Int<1>{}, Int<kXorshiftStar>{}); break;
    case 8: f(Int<8>{}, Int<kChunk>{}, Int<1>{}, Int<kXorshiftStar>{}); break;
    case 16:
      f(Int<16>{}, Int<kChunk>{}, Int<1>{}, Int<kXorshiftStar>{});
      break;
    default:
      f(Int<32>{}, Int<kChunk>{}, Int<1>{}, Int<kXorshiftStar>{});
  }
  return true;
}

// ---------------------------------------------------------------------------
// the hybrid fixed point: every round over the slabs and the spill in one
// cooperative launch
// ---------------------------------------------------------------------------

// blocks an SM must hold for the hybrid persistent kernel (its register cap)
constexpr int kHybridMinBlocks = 4;

// One slab of the hybrid layout, a row of the [S, 7] int64 table the
// wrapper builds once per layout: its global row ids and its [R * D] ids
// (device pointers), R, D, the group shape of its passes (G lanes a row, C
// slots a lane loads at once, as the standalone sliced kernels pick it:
// hybrid_slab_shape), and the offset of its two lists' two buffers ([R]
// each, slab-local rows, sentinel R) in the solve's list storage
struct HybridSlab {
  int64_t rows;
  int64_t nbrs;
  int64_t r;
  int64_t d;
  int64_t g;
  int64_t c;
  int64_t wl;
};

// a slab's view in the kernel: its pointers resolved
struct SlabView {
  const int32_t* rows;
  const int32_t* nbrs;
  int32_t* wl[2][2];
  int64_t r;
  int d;
  int g;
  int c;
};

// The hybrid solve's buffers.  counts[6 * s + 2 * l + k]: slab s's list l
// buffer k's live slots, and counts[6 * s + 4 + l] the slots the buffer a
// round writes held live before (stashed ahead of the writes);
// block_counts[(2 * s + l) * grid + block]: what a block keeps of it in a
// round's compaction; heavy[k]: the undecided heavy rows after a round, by
// its parity; hmin, hflags, htuple: [H] per heavy row the spill refresh's
// column min, the spill decide's two flags (bit 0: an active neighbour's M
// is OUT; bit 1: one differs from the row's tuple) and the row's refreshed
// tuple; rows_processed: [S] the live list rows each slab's passes
// visited; out: the rounds run and the last live count.
struct Hybrid {
  uint32_t* t;
  uint32_t* m;
  const uint8_t* active;        // null: every row active, M alone decides
  const HybridSlab* slabs;
  int32_t* lists;               // every slab's list buffers
  const int32_t* spill_rows;
  const int32_t* spill_seg;
  const int32_t* spill_cols;
  uint32_t* hmin;
  uint32_t* hflags;
  uint32_t* htuple;
  int32_t* counts;
  int32_t* block_counts;
  int32_t* heavy;
  int64_t* rows_processed;
  int32_t* out;
  int64_t v;
  int64_t h;
  int64_t e;
  int num_slabs;
  int b;
  int kind;
  int max_iters;
};

constexpr uint32_t kOutFlag = 1u;   // hflags bit: an active neighbour is OUT
constexpr uint32_t kNeqFlag = 2u;   // hflags bit: one's M is not the tuple

constexpr int kStale = 4;   // slab_counts(r, s)[kStale + l]

__device__ __forceinline__ int32_t* slab_counts(const Hybrid& r, int s) {
  return r.counts + 6 * s;
}

__device__ __forceinline__ int32_t* slab_block_counts(const Hybrid& r, int s,
                                                      int l) {
  return r.block_counts + (2 * s + l) * gridDim.x;
}

__device__ __forceinline__ SlabView slab_view(const Hybrid& r, int s) {
  const HybridSlab& x = r.slabs[s];
  SlabView sl;
  sl.rows = reinterpret_cast<const int32_t*>(x.rows);
  sl.nbrs = reinterpret_cast<const int32_t*>(x.nbrs);
  sl.r = x.r;
  sl.d = static_cast<int>(x.d);
  sl.g = static_cast<int>(x.g);
  sl.c = static_cast<int>(x.c);
  int32_t* base = r.lists + x.wl;
  sl.wl[0][0] = base;
  sl.wl[0][1] = base + x.r;
  sl.wl[1][0] = base + 2 * x.r;
  sl.wl[1][1] = base + 3 * x.r;
  return sl;
}

// buffer k of a slab's list L (selects, so the view is never indexed at
// run time)
template <int L>
__device__ __forceinline__ int32_t* slab_list(const SlabView& sl, int k) {
  return k != 0 ? sl.wl[L][1] : sl.wl[L][0];
}

// f(Int<G>, Int<C>) for a slab's group shape: G as picked, C rounded up to
// 2, 4 or kChunk (one kernel holds every instance it may switch to; a C
// past a lane's turns only loads nothing at the extra slots)
template <int G, typename F>
__device__ __forceinline__ void with_slab_chunk(int c, F&& f) {
  if (c <= 2) {
    f(Int<G>{}, Int<2>{});
  } else if (c <= 4) {
    f(Int<G>{}, Int<4>{});
  } else {
    f(Int<G>{}, Int<kChunk>{});
  }
}

template <typename F>
__device__ __forceinline__ void with_slab_shape(const SlabView& sl, F&& f) {
  with_lanes(sl.g, [&](auto gg) {
    with_slab_chunk<decltype(gg)::value>(sl.c, f);
  });
}

// Refresh's spill half: hmin[h] <- the min of the refreshed T over heavy row
// h's entries, for the rows live this round (round 0, or M not OUT; the slab
// passes beside it write M only at slab rows)
__device__ __forceinline__ void spill_refresh(const Hybrid& r, uint32_t it) {
  const RoundPriority<kAnyKind> prio(it, r.kind);
  segment_reduce_warp(
      r.spill_seg, r.e, kOut,
      [](uint32_t a, uint32_t b) { return a < b ? a : b; },
      [&](int64_t i, int32_t sg) -> uint32_t {
        const int32_t row = r.spill_rows[sg];
        if (it > 0 && state_load<kCoherent>(r.m + row) == kOut) return kOut;
        const int32_t col = r.spill_cols[i];
        const uint32_t x = state_load<kCoherent>(r.t + col);
        return is_undecided(x) ? prio.tuple(static_cast<uint32_t>(col), r.b)
                               : x;
      },
      [&](int32_t sg, uint32_t x) {
        if (x != kOut) atomicMin(r.hmin + sg, x);
      });
}

// ... its finish, after a grid sync: M at each live heavy row <- the min
// with the row's own refreshed tuple, IN -> OUT; the tuple kept for the
// decide; the scratch reset for the next use
__device__ __forceinline__ void spill_refresh_finish(const Hybrid& r,
                                                     uint32_t it) {
  const RoundPriority<kAnyKind> prio(it, r.kind);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t h = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       h < r.h; h += stride) {
    const int32_t row = r.spill_rows[h];
    uint32_t tself = state_load<kCoherent>(r.t + row);
    if (is_undecided(tself)) {
      tself = prio.tuple(static_cast<uint32_t>(row), r.b);
    }
    const uint32_t hm = state_load<kCoherent>(r.hmin + h);
    uint32_t x = hm < tself ? hm : tself;
    x = x == kIn ? kOut : x;
    if (it == 0 || state_load<kCoherent>(r.m + row) != kOut) r.m[row] = x;
    r.htuple[h] = tself;
    r.hmin[h] = kOut;
    r.hflags[h] = 0u;
  }
}

// Decide's spill half: hflags[h] <- the two flags over heavy row h's
// entries, for the rows still undecided
__device__ __forceinline__ void spill_decide(const Hybrid& r) {
  segment_reduce_warp(
      r.spill_seg, r.e, 0u, [](uint32_t a, uint32_t b) { return a | b; },
      [&](int64_t i, int32_t sg) -> uint32_t {
        const uint32_t tv = state_load<kCoherent>(r.htuple + sg);
        if (!is_undecided(tv)) return 0u;
        const int32_t col = r.spill_cols[i];
        const uint32_t mv = state_load<kCoherent>(r.m + col);
        const bool a = r.active == nullptr || r.active[col] != 0;
        return (a && mv == kOut ? kOutFlag : 0u) |
               (a && mv != tv ? kNeqFlag : 0u);
      },
      [&](int32_t sg, uint32_t x) {
        if (x != 0u) atomicOr(r.hflags + sg, x);
      });
}

// ... its finish, after a grid sync: T at each undecided heavy row <- OUT,
// IN or its tuple, the self term folded in; the rows left undecided added
// to heavy[k]
__device__ __forceinline__ void spill_decide_finish(const Hybrid& r, int k,
                                                    int32_t* words) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int32_t und = 0;
  for (int64_t h = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       h < r.h; h += stride) {
    const int32_t row = r.spill_rows[h];
    const uint32_t tv = state_load<kCoherent>(r.htuple + h);
    if (!is_undecided(tv)) continue;
    const uint32_t f = state_load<kCoherent>(r.hflags + h);
    const uint32_t ms = state_load<kCoherent>(r.m + row);
    const bool a = r.active == nullptr || r.active[row] != 0;
    const bool out = (f & kOutFlag) != 0u || (a && ms == kOut);
    const bool neq = (f & kNeqFlag) != 0u || (a && ms != tv);
    const uint32_t nt = out ? kOut : neq ? tv : kIn;
    r.t[row] = nt;
    und += is_undecided(nt) ? 1 : 0;
  }
  und = block_sum(und, words);
  if (threadIdx.x == 0 && und != 0) atomicAdd(r.heavy + k, und);
}

// the rows a heavy row list starts with: the active ones, counted into
// heavy[0]
__device__ __forceinline__ void count_active_heavy(const Hybrid& r,
                                                   int32_t* words) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int32_t n = 0;
  for (int64_t h = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       h < r.h; h += stride) {
    n += r.active == nullptr || r.active[r.spill_rows[h]] != 0 ? 1 : 0;
  }
  n = block_sum(n, words);
  if (threadIdx.x == 0 && n != 0) atomicAdd(r.heavy, n);
}

// what a slab's list L keeps of its previous list: the rows whose vertex is
// undecided (kUndecided; active ones for round 0's, `prev` null), or whose
// vertex's M is not OUT (kLiveM)
template <int L>
__device__ __forceinline__ auto slab_keep(const Hybrid& r,
                                          const SlabView& sl,
                                          const int32_t* prev) {
  return [&r, rows = sl.rows, prev](int32_t row) -> bool {
    const int32_t vid = rows[row];
    if constexpr (L == kUndecided) {
      return prev != nullptr ? is_undecided(state_load<kCoherent>(r.t + vid))
                             : r.active == nullptr || r.active[vid] != 0;
    } else {
      return state_load<kCoherent>(r.m + vid) != kOut;
    }
  };
}

// The hybrid layout's §V-B fixed point (repro/core/mis2_hybrid.py:
// _hybrid_fixed_point), from `active` (null: every row): round 0's state is
// T = 1 on the active rows and OUT elsewhere, M = OUT, each slab's undecided
// list its active rows and its M list every row.  Each round, while a row
// is undecided and fewer than max_iters rounds ran: (a) the refresh of
// every slab over its M list and the spill's entries, (b) the spill's
// finish, (c) the decide of every slab over its undecided list and the
// spill's entries, (d) the spill's finish and each slab's lists counted
// over themselves, (e) written; a grid sync after each ((b) only with a
// spill).  Every vertex lies in one slab or the spill, so the writes are
// disjoint, and the decided rows and M's OUT rows of a round are subsets of
// its lists: each list is compact_worklist over its slab, slot for slot.
__global__ void __launch_bounds__(kThreads, kHybridMinBlocks)
hybrid_fixed_point_kernel(const __grid_constant__ Hybrid r) {
  __shared__ int32_t words[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int ns = r.num_slabs;
  for (int64_t i = tid; i < r.v; i += stride) {
    r.t[i] = r.active == nullptr || r.active[i] != 0 ? 1u : kOut;
    r.m[i] = kOut;
  }
  for (int64_t i = tid; i < r.h; i += stride) {
    r.hmin[i] = kOut;
    r.hflags[i] = 0u;
  }
  for (int s = 0; s < ns; ++s) {
    const SlabView sl = slab_view(r, s);
    for (int64_t i = tid; i < sl.r; i += stride) {
      sl.wl[kLiveM][0][i] = static_cast<int32_t>(i);
    }
    count_kept(nullptr, sl.r, slab_keep<kUndecided>(r, sl, nullptr),
               slab_block_counts(r, s, kUndecided), words);
  }
  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      const int32_t rr = static_cast<int32_t>(slab_view(r, s).r);
      int32_t* c = slab_counts(r, s);
      c[2 * kLiveM] = rr;
      // buffer 1 of each list holds nothing yet: every slot is stale
      c[2 * kUndecided + 1] = c[2 * kLiveM + 1] = rr;
      r.rows_processed[s] = 0;
    }
    r.heavy[0] = r.heavy[1] = 0;
  }
  grid.sync();
  for (int s = 0; s < ns; ++s) {
    const SlabView sl = slab_view(r, s);
    write_kept(nullptr, sl.r, slab_keep<kUndecided>(r, sl, nullptr),
               slab_block_counts(r, s, kUndecided),
               slab_list<kUndecided>(sl, 0), slab_counts(r, s) + 2 * kUndecided,
               sl.r, static_cast<int32_t>(sl.r), words);
  }
  count_active_heavy(r, words);
  grid.sync();
  int cur = 0;
  uint32_t it = 0;
  int64_t n1 = 0;
  for (;;) {
    n1 = state_load<kCoherent>(r.heavy + cur);
    for (int s = 0; s < ns; ++s) {
      n1 += state_load<kCoherent>(slab_counts(r, s) + 2 * kUndecided + cur);
    }
    if (n1 == 0 || it >= static_cast<uint32_t>(r.max_iters)) break;
    const int nxt = cur ^ 1;
    if (tid == 0) {
      r.heavy[nxt] = 0;
      for (int s = 0; s < ns; ++s) {
        const int32_t* c = slab_counts(r, s);
        r.rows_processed[s] += state_load<kCoherent>(c + 2 * kUndecided + cur)
                               + state_load<kCoherent>(c + 2 * kLiveM + cur);
      }
    }
    // (a) refresh: only M is written, every pass reads the round-start T
    for (int s = 0; s < ns; ++s) {
      const SlabView sl = slab_view(r, s);
      const int64_t n2 =
          state_load<kCoherent>(slab_counts(r, s) + 2 * kLiveM + cur);
      with_slab_shape(sl, [&](auto gg, auto cc) {
        constexpr int kG = decltype(gg)::value, kC = decltype(cc)::value;
        refresh_group_body<kG, 1, kC, false, kAnyKind, kSlab, kCoherent>(
            r.t, r.m, sl.nbrs, slab_list<kLiveM>(sl, cur), n2, it, sl.r,
            sl.r, sl.d, r.b, sl.rows, r.kind);
      });
    }
    if (r.h > 0) {
      spill_refresh(r, it);
      grid.sync();
      spill_refresh_finish(r, it);
    }
    grid.sync();
    // (c) decide: each pass reads and writes T only at its own rows
    for (int s = 0; s < ns; ++s) {
      const SlabView sl = slab_view(r, s);
      const int64_t n1s =
          state_load<kCoherent>(slab_counts(r, s) + 2 * kUndecided + cur);
      with_slab_shape(sl, [&](auto gg, auto cc) {
        constexpr int kG = decltype(gg)::value, kC = decltype(cc)::value;
        if (r.active != nullptr) {
          decide_group_body<kG, 1, kC, true, kSlab, kCoherent>(
              r.t, r.m, r.active, sl.nbrs, slab_list<kUndecided>(sl, cur),
              n1s, it, sl.r, sl.r, sl.d, r.b, r.kind, sl.rows, nullptr);
        } else {
          decide_group_body<kG, 1, kC, false, kSlab, kCoherent>(
              r.t, r.m, nullptr, sl.nbrs, slab_list<kUndecided>(sl, cur),
              n1s, it, sl.r, sl.r, sl.d, r.b, r.kind, sl.rows, nullptr);
        }
      });
    }
    if (r.h > 0) spill_decide(r);
    grid.sync();
    // (d) the spill's decision, then each slab's lists counted over
    // themselves (the spill writes T only at heavy rows)
    if (r.h > 0) spill_decide_finish(r, nxt, words);
    for (int s = 0; s < ns; ++s) {
      const SlabView sl = slab_view(r, s);
      int32_t* c = slab_counts(r, s);
      if (tid == 0) {   // the slots each next buffer held live (two rounds ago)
        c[kStale + kUndecided] = c[2 * kUndecided + nxt];
        c[kStale + kLiveM] = c[2 * kLiveM + nxt];
      }
      const int32_t* wl1 = slab_list<kUndecided>(sl, cur);
      const int32_t* wl2 = slab_list<kLiveM>(sl, cur);
      count_kept(wl1, state_load<kCoherent>(c + 2 * kUndecided + cur),
                 slab_keep<kUndecided>(r, sl, wl1),
                 slab_block_counts(r, s, kUndecided), words);
      count_kept(wl2, state_load<kCoherent>(c + 2 * kLiveM + cur),
                 slab_keep<kLiveM>(r, sl, wl2),
                 slab_block_counts(r, s, kLiveM), words);
    }
    grid.sync();
    // (e) the survivors written, the sentinel R up to what the buffer held
    for (int s = 0; s < ns; ++s) {
      const SlabView sl = slab_view(r, s);
      int32_t* c = slab_counts(r, s);
      const int32_t* wl1 = slab_list<kUndecided>(sl, cur);
      const int32_t* wl2 = slab_list<kLiveM>(sl, cur);
      const int64_t n1s = state_load<kCoherent>(c + 2 * kUndecided + cur);
      const int64_t n2s = state_load<kCoherent>(c + 2 * kLiveM + cur);
      const int64_t stale1 = state_load<kCoherent>(c + kStale + kUndecided);
      const int64_t stale2 = state_load<kCoherent>(c + kStale + kLiveM);
      const int32_t sentinel = static_cast<int32_t>(sl.r);
      write_kept(wl1, n1s, slab_keep<kUndecided>(r, sl, wl1),
                 slab_block_counts(r, s, kUndecided),
                 slab_list<kUndecided>(sl, nxt), c + 2 * kUndecided + nxt,
                 stale1, sentinel, words);
      write_kept(wl2, n2s, slab_keep<kLiveM>(r, sl, wl2),
                 slab_block_counts(r, s, kLiveM), slab_list<kLiveM>(sl, nxt),
                 c + 2 * kLiveM + nxt, stale2, sentinel, words);
    }
    grid.sync();
    cur = nxt;
    ++it;
  }
  if (tid == 0) {
    r.out[0] = static_cast<int32_t>(it);
    r.out[1] = static_cast<int32_t>(n1);
  }
}

// The state of one resident solve over the caller's buffers (one graph,
// from `active`; the batched and seeded entries set the rest)
Resident resident_of(void* t, void* m, void* scratch, const void* active,
                     const void* nbrs, void* wl, void* aux, int64_t v, int d,
                     int b, int kind, int max_iters) {
  auto* w = static_cast<int32_t*>(wl);
  auto* x = static_cast<int32_t*>(aux);
  return Resident{static_cast<uint32_t*>(t), static_cast<uint32_t*>(m),
                  static_cast<uint32_t*>(scratch),
                  static_cast<const uint8_t*>(active),
                  static_cast<const int32_t*>(nbrs),
                  {{w, w + v}, {w + 2 * v, w + 3 * v}}, x, x + 4, v, d, b,
                  kind, max_iters, Members{}, nullptr, 0, 0};
}

// One cooperative launch of the instance width r.d takes, on a grid sized
// to the work: a block for each kResidentRowsPerBlock rows, at most the
// blocks that fit on the card at once
int launch_resident(const Resident& r, int64_t aux_len, void* stream) {
  int dev = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (coop == 0) return static_cast<int>(cudaErrorNotSupported);
  if (aux_len < 6) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t status = cudaSuccess;
  const bool shaped = with_resident_shape(r.d, r.kind, [&](auto gg, auto cc,
                                                           auto once, auto k) {
    auto fn = resident_fixed_point_kernel<decltype(gg)::value,
                                          decltype(cc)::value,
                                          decltype(once)::value != 0,
                                          decltype(k)::value>;
    const int grid = r.v > 0 ? grid_for(fn, r.v, kResidentRowsPerBlock) : 1;
    Resident arg = r;
    void* args[] = {&arg};
    status = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn),
                                         dim3(grid), dim3(kThreads), args, 0,
                                         static_cast<cudaStream_t>(stream));
  });
  if (!shaped) return static_cast<int>(cudaErrorInvalidValue);
  if (status != cudaSuccess) return static_cast<int>(status);
  return static_cast<int>(cudaGetLastError());
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

// The resident fixed point in one cooperative launch.  t, m, scratch: [V]
// words (written; nothing in them is read before the kernel writes it);
// active: [V] bytes; nbrs: [V * D] ids; wl: [4 * V] int32, the two lists'
// two buffers; aux: aux_len int32 words, at least 6: 4 counts and 2
// outputs (the rounds run, then the last live count of the undecided list).
// Returns cudaErrorNotSupported where the card has no cooperative launch,
// cudaErrorInvalidValue where aux is short or the width has no instance,
// and the launch's error (cudaErrorCooperativeLaunchTooLarge among them).
int resident_fixed_point(void* t, void* m, void* scratch, const void* active,
                         const void* nbrs, void* wl, void* aux,
                         int64_t aux_len, int64_t v, int d, int b, int kind,
                         int max_iters, void* stream) {
  return repro_torch::launch_resident(
      repro_torch::resident_of(t, m, scratch, active, nbrs, wl, aux, v, d, b,
                               kind, max_iters),
      aux_len, stream);
}

// The same over a bucket of graphs laid end to end, rows = 1 << shift rows
// each (one block-diagonal ELL of V = members * rows rows): bits, the
// members' id bits, int32 [members]; its: int32 [members], written, the
// rounds each member had an undecided row.  Returns as
// resident_fixed_point.
int resident_fixed_point_batched(void* t, void* m, void* scratch,
                                 const void* active, const void* nbrs,
                                 void* wl, void* aux, int64_t aux_len,
                                 int64_t v, int d, const void* bits,
                                 int shift, void* its, int64_t members,
                                 int kind, int max_iters, void* stream) {
  using namespace repro_torch;
  Resident r = resident_of(t, m, scratch, active, nbrs, wl, aux, v, d, 1,
                           kind, max_iters);
  r.mem = Members{static_cast<const int32_t*>(bits), shift};
  r.its = static_cast<int32_t*>(its);
  r.members = members;
  return launch_resident(r, aux_len, stream);
}

// The same from a given T: t holds the seed on entry (IN / OUT on frozen
// rows, undecided words on the rows to solve), the first undecided list is
// its undecided rows, and every row is active (active: [V] bytes, all
// set).  Returns as resident_fixed_point.
int resident_fixed_point_seeded(void* t, void* m, void* scratch,
                                const void* active, const void* nbrs, void* wl,
                                void* aux, int64_t aux_len, int64_t v, int d,
                                int b, int kind, int max_iters, void* stream) {
  using namespace repro_torch;
  Resident r = resident_of(t, m, scratch, active, nbrs, wl, aux, v, d, b,
                           kind, max_iters);
  r.seeded = 1;
  return launch_resident(r, aux_len, stream);
}

// The group shape of a slab of r rows of d ids in the hybrid fixed point,
// as the standalone sliced passes pick it: G << 8 | C
int hybrid_slab_shape(int d, int64_t r) {
  using namespace repro_torch;
  const int g = slab_group_lanes(d, r);
  return g << 8 | chunk_slots(g, d);
}

// The hybrid fixed point in one cooperative launch.  t, m: [V] words
// (written; nothing in them is read); active: [V] bytes, or null for
// every row with the decide reading M alone; table: the layout's [S, 7]
// int64 slab table on the card (see HybridSlab); lists: int32 [4 * sum R],
// each slab's two lists' two buffers at its offset; the spill's rows [H],
// seg and cols [E]; scratch: [3 * H] words; aux: aux_len int32 words, 2
// outputs (the rounds run, then the last live count), 2 heavy-row counts, 6
// a slab and 2 a slab a block; rows_processed: int64 [S], written.  Returns
// as resident_fixed_point.
int hybrid_fixed_point(void* t, void* m, const void* active,
                       const void* table, int num_slabs, void* lists,
                       const void* spill_rows, const void* spill_seg,
                       const void* spill_cols, int64_t h, int64_t e,
                       void* scratch, void* aux, int64_t aux_len,
                       void* rows_processed, int64_t v, int b, int kind,
                       int max_iters, void* stream) {
  using namespace repro_torch;
  int dev = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (coop == 0) return static_cast<int>(cudaErrorNotSupported);
  const int grid = resident_blocks(hybrid_fixed_point_kernel);
  if (4 + 6 * static_cast<int64_t>(num_slabs) +
          2 * static_cast<int64_t>(num_slabs) * grid > aux_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* x = static_cast<int32_t*>(aux);
  auto* words = static_cast<uint32_t*>(scratch);
  Hybrid r{static_cast<uint32_t*>(t), static_cast<uint32_t*>(m),
           static_cast<const uint8_t*>(active),
           static_cast<const HybridSlab*>(table),
           static_cast<int32_t*>(lists),
           static_cast<const int32_t*>(spill_rows),
           static_cast<const int32_t*>(spill_seg),
           static_cast<const int32_t*>(spill_cols), words, words + h,
           words + 2 * h, x + 4, x + 4 + 6 * num_slabs, x + 2,
           static_cast<int64_t*>(rows_processed), x, v, h, e, num_slabs, b,
           kind, max_iters};
  void* args[] = {&r};
  const cudaError_t status = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(hybrid_fixed_point_kernel), dim3(grid),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (status != cudaSuccess) return static_cast<int>(status);
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
