// The distance-k MIS fixed point (k-fold min-propagation) in one
// cooperative launch.
//
// It replaces the reference's two jitted lax.while_loops,
// repro/core/misk.py:_misk_fixpoint (engine dense) and
// :_misk_resident_fixpoint (engine resident): no Pallas kernel of their
// own (XLA ran the round), bit-identical sets, one dispatch each.  The port
// ran them as some twenty plain-torch launches and one blocking read of a
// live flag a round.  Here both engines are the same launch: the round
// lives in a register and the host reads nothing until the loop ends (the
// rounds run and the last live count go to a two-word output), while a row
// is undecided and fewer than max_iters rounds ran.
//
// A round, with uint32 tuples (IN = 0, OUT = 0xFFFFFFFF, hash.cuh):
//   (a) every row on the undecided list takes this round's §V-A tuple;
//   (b) k hops of the closed-neighbourhood min, M^1 over T and M^j over
//       M^(j-1), into two [V] buffers taken in turn (never T);
//   (c) k hops of "near an IN row" into two [V] byte buffers taken in
//       turn: the first reads T and M^k, a row being IN where T is IN or
//       where it is undecided and T == M^k (the round's new IN rows), and
//       writes that IN into T at its own row; the others OR the flags over
//       the row's slots and its own;
//   (d) the undecided list compacted over itself (compact.cuh): a row
//       near an IN row goes OUT there, a decided row leaves the list.
// A grid sync after (a), after each hop and after each half of (d): 2k + 3
// a round.  Every hop covers every row.
//
// (c)'s first hop writes IN into T while other rows read T: a reader of a
// new IN row sees its old tuple, equal to M^k, or IN, and counts it IN
// either way; nothing reads M^k's buffer there.  IN = 0 is every
// neighbourhood's minimum, so a row within k hops of an IN row never has
// T == M^k: that falls out of the min, as in the reference.
//
// Rows hold G lanes (the smallest power of two that leaves a lane at most
// kLaneSlots of the row's D slots), 32 / G rows a warp step, the group
// reducing by shuffles (min) or ballots (any); the ids are read plainly
// (nothing in the launch writes them), T, M, the flags and the list through
// L2 (ld.global.cg), since other blocks wrote them before the last sync.
//
// Bound: memory.  A hop reads the row's D ids and one word (a byte for
// the flags) per slot at the ids' addresses, and writes a word a row; at
// Elasticity3D_60 (D = 81) the ids are nearly all of it: 2k passes over
// the [V, D] ids a round.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "compact.cuh"
#include "grid.cuh"
#include "hash.cuh"

namespace repro_torch {
namespace {

namespace cg = cooperative_groups;

// Tuning constants
constexpr int kLaneSlots = 16;      // a row's slots a lane may take (picks G)
constexpr int kMiskMinBlocks = 4;   // blocks an SM must hold (register cap)

// The solve's buffers.  hop[k], near[k]: the hops' [V] buffers; wl[k]: the
// undecided list's two [V] buffers, counts[k] their live slots;
// block_counts: [grid], what a block keeps in a compaction; out: the
// rounds run and the last live count.
struct Misk {
  uint32_t* t;
  uint32_t* hop[2];
  uint8_t* near[2];
  const int32_t* nbrs;
  int32_t* wl[2];
  int32_t* counts;
  int32_t* block_counts;
  int32_t* out;
  int64_t v;
  int d;
  int b;
  int kind;
  int k;
  int max_iters;
};

// buffer i of a pair (a select, so the parameter struct is never indexed
// at run time)
template <typename T>
__device__ __forceinline__ T* pick(T* const (&pair)[2], int i) {
  return i != 0 ? pair[1] : pair[0];
}

__device__ __forceinline__ uint32_t flag_load(const uint8_t* p) {
  uint16_t x;
  asm volatile("{ .reg .u8 datum; ld.global.cg.u8 datum, [%1];"
               " cvt.u16.u8 %0, datum; }"
               : "=h"(x)
               : "l"(p));
  return x;
}

// any lane of group grp (G lanes) holds x
template <int G>
__device__ __forceinline__ bool group_any(bool x, int grp) {
  return (__ballot_sync(kFull, x) & group_bits<G>(grp)) != 0u;
}

// f(row, sub) on each lane of every row's group, then done(row, reduced)
// on the group's first lane: `slots(row, sub)` folds the lane's slots into
// a value that `reduce` combines over the group.  Warps stride over rows,
// 32 / G a step; every lane of a warp takes every step (rows past V fold
// nothing), so the shuffles see the whole warp.
template <int G, typename Slots, typename Reduce, typename Done>
__device__ __forceinline__ void each_row(int64_t v, Slots slots,
                                         Reduce reduce, Done done) {
  constexpr int kRows = 32 / G;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const int grp = lane / G;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t base = warp * kRows; base < v; base += warps * kRows) {
    const int64_t row = base + grp;
    const auto x = reduce(slots(row < v ? row : -1, sub), grp);
    if (row < v && sub == 0) done(row, x);
  }
}

// (b): dst[row] = the min of src over the row's slots
template <int G>
__device__ __forceinline__ void min_hop(const Misk& r, const uint32_t* src,
                                        uint32_t* dst) {
  each_row<G>(
      r.v,
      [&](int64_t row, int sub) {
        uint32_t mn = kOut;
        if (row >= 0) {
          const int32_t* ids = r.nbrs + row * r.d;
          for (int j = sub; j < r.d; j += G) {
            const uint32_t x = state_load<kCoherent>(src + ids[j]);
            mn = x < mn ? x : mn;
          }
        }
        return mn;
      },
      [](uint32_t x, int) { return group_min<G>(x); },
      [&](int64_t row, uint32_t mn) { dst[row] = mn; });
}

// a row is IN this round: decided IN before, or undecided and the minimum
// of its distance-k neighbourhood
__device__ __forceinline__ bool in_now(const Misk& r, const uint32_t* mk,
                                       int64_t w) {
  const uint32_t t = state_load<kCoherent>(r.t + w);
  return t == kIn || (is_undecided(t) && t == state_load<kCoherent>(mk + w));
}

// (c)'s first hop: near[row] = the row or one of its slots is IN; a new
// IN row writes IN into T
template <int G>
__device__ __forceinline__ void first_near_hop(const Misk& r,
                                               const uint32_t* mk,
                                               uint8_t* dst) {
  each_row<G>(
      r.v,
      [&](int64_t row, int sub) {
        bool x = false;
        if (row >= 0) {
          const int32_t* ids = r.nbrs + row * r.d;
          for (int j = sub; j < r.d; j += G) x |= in_now(r, mk, ids[j]);
        }
        return x;
      },
      [](bool x, int grp) { return group_any<G>(x, grp); },
      [&](int64_t row, bool x) {
        const uint32_t t = state_load<kCoherent>(r.t + row);
        const bool in = is_undecided(t) &&
                        t == state_load<kCoherent>(mk + row);
        if (in) r.t[row] = kIn;
        dst[row] = x || in || t == kIn ? 1 : 0;
      });
}

// (c)'s later hops: dst[row] = src[row] or src at one of the row's slots
template <int G>
__device__ __forceinline__ void near_hop(const Misk& r, const uint8_t* src,
                                         uint8_t* dst) {
  each_row<G>(
      r.v,
      [&](int64_t row, int sub) {
        bool x = false;
        if (row >= 0) {
          const int32_t* ids = r.nbrs + row * r.d;
          for (int j = sub; j < r.d; j += G) x |= flag_load(src + ids[j]) != 0;
        }
        return x;
      },
      [](bool x, int grp) { return group_any<G>(x, grp); },
      [&](int64_t row, bool x) {
        dst[row] = x || flag_load(src + row) != 0 ? 1 : 0;
      });
}

template <int G>
__global__ void __launch_bounds__(kThreads, kMiskMinBlocks)
misk_fixed_point_kernel(const __grid_constant__ Misk r) {
  __shared__ int32_t words[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int64_t v = r.v;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  for (int64_t i = tid; i < v; i += stride) {
    r.t[i] = 1u;
    r.wl[0][i] = static_cast<int32_t>(i);
  }
  if (tid == 0) {
    // every row is undecided; buffer 1 holds nothing yet: every slot stale
    r.counts[0] = r.counts[1] = static_cast<int32_t>(v);
  }
  grid.sync();
  int cur = 0;
  uint32_t it = 0;
  int64_t n = 0;
  for (;;) {
    n = state_load<kCoherent>(r.counts + cur);
    if (n == 0 || it >= static_cast<uint32_t>(r.max_iters)) break;
    const int nxt = cur ^ 1;
    const int32_t* wl = pick(r.wl, cur);
    // (a) the undecided rows' tuples
    for (int64_t i = tid; i < n; i += stride) {
      const int32_t row = state_load<kCoherent>(wl + i);
      r.t[row] = fresh_tuple(r.kind, it, static_cast<uint32_t>(row), r.b);
    }
    grid.sync();
    // (b) M^1 .. M^k
    for (int j = 0; j < r.k; ++j) {
      min_hop<G>(r, j == 0 ? r.t : pick(r.hop, (j - 1) & 1),
                 pick(r.hop, j & 1));
      grid.sync();
    }
    const uint32_t* mk = pick(r.hop, (r.k - 1) & 1);
    // (c) near an IN row, k hops
    first_near_hop<G>(r, mk, pick(r.near, 0));
    grid.sync();
    for (int j = 1; j < r.k; ++j) {
      near_hop<G>(r, pick(r.near, (j - 1) & 1), pick(r.near, j & 1));
      grid.sync();
    }
    const uint8_t* near = pick(r.near, (r.k - 1) & 1);
    // (d) OUT near an IN row; the list keeps the rows still undecided
    auto keep = [&r, near](int32_t row) -> bool {
      const uint32_t t = state_load<kCoherent>(r.t + row);
      if (!is_undecided(t)) return false;
      if (flag_load(near + row) != 0) {
        r.t[row] = kOut;
        return false;
      }
      return true;
    };
    const int64_t stale = state_load<kCoherent>(r.counts + nxt);
    count_kept(wl, n, keep, r.block_counts, words);
    grid.sync();
    write_kept(wl, n, keep, r.block_counts, pick(r.wl, nxt), r.counts + nxt,
               stale, static_cast<int32_t>(v), words);
    grid.sync();
    cur = nxt;
    ++it;
  }
  if (tid == 0) {
    r.out[0] = static_cast<int32_t>(it);
    r.out[1] = static_cast<int32_t>(n);
  }
}

// f(Int<G>{}) for G, the lanes a row of d slots takes
template <typename F>
void with_row_lanes(int d, F&& f) {
  switch (row_lanes(d, kLaneSlots)) {
    case 1: return f(Int<1>{});
    case 2: return f(Int<2>{});
    case 4: return f(Int<4>{});
    case 8: return f(Int<8>{});
    case 16: return f(Int<16>{});
    default: return f(Int<32>{});
  }
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// The distance-k fixed point in one cooperative launch.  t: [V] words,
// written (T at the end; nothing in it is read); nbrs: [V * D] ids, the
// self-padded ELL; hops: [2 * V] words and near: [2 * V] bytes of
// scratch; wl: [2 * V] int32, the list's two buffers; aux: aux_len int32
// words, 2 counts, 2 outputs (the rounds run, then the last live count)
// and 1 per block.  Returns cudaErrorNotSupported where the card has no
// cooperative launch, cudaErrorInvalidValue where aux is short or k < 1,
// and the launch's error (cudaErrorCooperativeLaunchTooLarge among them).
int misk_fixed_point(void* t, const void* nbrs, void* hops, void* near,
                     void* wl, void* aux, int64_t aux_len, int64_t v, int d,
                     int b, int kind, int k, int max_iters, void* stream) {
  using namespace repro_torch;
  int dev = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (coop == 0) return static_cast<int>(cudaErrorNotSupported);
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto* h = static_cast<uint32_t*>(hops);
  auto* f = static_cast<uint8_t*>(near);
  auto* w = static_cast<int32_t*>(wl);
  auto* x = static_cast<int32_t*>(aux);
  Misk r{static_cast<uint32_t*>(t), {h, h + v}, {f, f + v},
         static_cast<const int32_t*>(nbrs), {w, w + v}, x, x + 4, x + 2, v, d,
         b, kind, k, max_iters};
  cudaError_t status = cudaSuccess;
  with_row_lanes(d, [&](auto gg) {
    auto fn = misk_fixed_point_kernel<decltype(gg)::value>;
    const int grid = resident_blocks(fn);
    if (4 + static_cast<int64_t>(grid) > aux_len) {
      status = cudaErrorInvalidValue;
      return;
    }
    void* args[] = {&r};
    status = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn),
                                         dim3(grid), dim3(kThreads), args, 0,
                                         static_cast<cudaStream_t>(stream));
  });
  if (status != cudaSuccess) return static_cast<int>(status);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
