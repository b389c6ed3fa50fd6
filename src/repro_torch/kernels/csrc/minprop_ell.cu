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
// address, and writes one word.  One thread per slot loops over the row;
// a warp per row (coalesced id reads, paper §V-D) is later work, as is
// folding every slab of a round into one launch.  Blocks wholly past
// *count exit before touching memory, standing in for the TPU's pl.when
// block skipping.  The unfused passes read the [W, D] row copy that was
// written outside (one more movement of each live row than the fused
// ones), and write every slot of their [W] output, dead ones included.
//
// In place is safe: refresh writes only M and reads only T; decide reads T
// only at its own row and writes that row.  The slabs of the hybrid layout
// hold disjoint rows, and every refresh of a round is enqueued before the
// first decide on the same stream.
#include <cstdint>

#include <cuda_runtime.h>

#include "hash.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

// min over one row's D ids of the refreshed T, IN -> OUT
__device__ __forceinline__ uint32_t refreshed_min(
    const uint32_t* __restrict__ t, const int32_t* __restrict__ r, int d,
    int kind, uint32_t it, int b) {
  uint32_t mn = kOut;
  for (int j = 0; j < d; ++j) {
    const int32_t nb = r[j];
    const uint32_t tv = refresh(t[nb], static_cast<uint32_t>(nb), kind, it, b);
    mn = tv < mn ? tv : mn;
  }
  return mn == kIn ? kOut : mn;
}

// T[row] <- OUT if an active neighbour's M is OUT, else IN if every active
// neighbour's M equals the row's refreshed tuple, else the refreshed tuple;
// decided rows are left as they are.  Reads T only at its own row.
__device__ __forceinline__ void decide_row(
    uint32_t* __restrict__ t, const uint32_t* __restrict__ m,
    const uint8_t* __restrict__ active, const int32_t* __restrict__ r,
    int32_t row, int d, int kind, uint32_t it, int b) {
  const uint32_t told = t[row];
  if (!is_undecided(told)) return;
  const uint32_t tv = refresh(told, static_cast<uint32_t>(row), kind, it, b);
  bool all_eq = true;
  for (int j = 0; j < d; ++j) {
    const int32_t nb = r[j];
    if (!active[nb]) continue;
    const uint32_t mv = m[nb];
    if (mv == kOut) {
      t[row] = kOut;
      return;
    }
    all_eq = all_eq && mv == tv;
  }
  t[row] = all_eq ? kIn : tv;
}

// M[row] for every live worklist row of the padded ELL
__global__ void fused_refresh_columns_kernel(
    const uint32_t* __restrict__ t, uint32_t* __restrict__ m,
    const int32_t* __restrict__ nbrs, const int32_t* __restrict__ wl,
    const int32_t* __restrict__ count, const uint32_t* __restrict__ it_ptr,
    int64_t v, int64_t w, int d, int b, int kind) {
  const int64_t n = *count;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n || i >= w) return;
  const int32_t row = wl[i];
  if (row < 0 || row >= v) return;  // sentinel slot
  m[row] = refreshed_min(t, nbrs + static_cast<int64_t>(row) * d, d, kind,
                         *it_ptr, b);
}

__global__ void fused_decide_kernel(
    uint32_t* __restrict__ t, const uint32_t* __restrict__ m,
    const uint8_t* __restrict__ active, const int32_t* __restrict__ nbrs,
    const int32_t* __restrict__ wl, const int32_t* __restrict__ count,
    const uint32_t* __restrict__ it_ptr, int64_t v, int64_t w, int d, int b,
    int kind) {
  const int64_t n = *count;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n || i >= w) return;
  const int32_t row = wl[i];
  if (row < 0 || row >= v) return;  // sentinel slot
  decide_row(t, m, active, nbrs + static_cast<int64_t>(row) * d, row, d, kind,
             *it_ptr, b);
}

// M[slab_rows[local]] for every live slab-local worklist row of one slab
__global__ void sliced_refresh_columns_kernel(
    const uint32_t* __restrict__ t, uint32_t* __restrict__ m,
    const int32_t* __restrict__ slab_rows, const int32_t* __restrict__ nbrs,
    const int32_t* __restrict__ wl, const int32_t* __restrict__ count,
    const uint32_t* __restrict__ it_ptr, int64_t r, int64_t w, int d, int b,
    int kind) {
  const int64_t n = *count;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n || i >= w) return;
  const int32_t local = wl[i];
  if (local < 0 || local >= r) return;  // sentinel slot
  m[slab_rows[local]] = refreshed_min(
      t, nbrs + static_cast<int64_t>(local) * d, d, kind, *it_ptr, b);
}

__global__ void sliced_decide_kernel(
    uint32_t* __restrict__ t, const uint32_t* __restrict__ m,
    const uint8_t* __restrict__ active, const int32_t* __restrict__ slab_rows,
    const int32_t* __restrict__ nbrs, const int32_t* __restrict__ wl,
    const int32_t* __restrict__ count, const uint32_t* __restrict__ it_ptr,
    int64_t r, int64_t w, int d, int b, int kind) {
  const int64_t n = *count;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n || i >= w) return;
  const int32_t local = wl[i];
  if (local < 0 || local >= r) return;  // sentinel slot
  decide_row(t, m, active, nbrs + static_cast<int64_t>(local) * d,
             slab_rows[local], d, kind, *it_ptr, b);
}

// M of pre-gathered worklist row i: min of T over its D ids, IN -> OUT
__global__ void refresh_columns_kernel(const uint32_t* __restrict__ t,
                                       const int32_t* __restrict__ rows,
                                       uint32_t* __restrict__ out, int64_t w,
                                       int d, int64_t count) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= w) return;
  if (i >= count) {  // dead slot
    out[i] = kOut;
    return;
  }
  const int32_t* r = rows + i * d;
  uint32_t mn = kOut;
  for (int j = 0; j < d; ++j) {
    const uint32_t tv = t[r[j]];
    mn = tv < mn ? tv : mn;
  }
  out[i] = mn == kIn ? kOut : mn;
}

// T of pre-gathered worklist row i: OUT if an active neighbour's M is OUT,
// else IN if every active neighbour's M equals the row's tuple, else the
// tuple; decided rows and dead slots keep theirs
__global__ void decide_kernel(const uint32_t* __restrict__ t_rows,
                              const uint32_t* __restrict__ m,
                              const uint8_t* __restrict__ active,
                              const int32_t* __restrict__ rows,
                              uint32_t* __restrict__ out, int64_t w, int d,
                              int64_t count) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= w) return;
  const uint32_t tv = t_rows[i];
  if (i >= count || !is_undecided(tv)) {
    out[i] = tv;
    return;
  }
  const int32_t* r = rows + i * d;
  bool all_eq = true;
  for (int j = 0; j < d; ++j) {
    const int32_t nb = r[j];
    if (!active[nb]) continue;
    const uint32_t mv = m[nb];
    if (mv == kOut) {
      out[i] = kOut;
      return;
    }
    all_eq = all_eq && mv == tv;
  }
  out[i] = all_eq ? kIn : tv;
}

int blocks_for(int64_t w) {
  return static_cast<int>((w + kThreads - 1) / kThreads);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

int fused_refresh_columns(const void* t, void* m, const void* nbrs,
                          const void* wl, const void* count, const void* it,
                          int64_t v, int64_t w, int d, int b, int kind,
                          void* stream) {
  using namespace repro_torch;
  if (w > 0) {
    fused_refresh_columns_kernel<<<blocks_for(w), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(t), static_cast<uint32_t*>(m),
        static_cast<const int32_t*>(nbrs), static_cast<const int32_t*>(wl),
        static_cast<const int32_t*>(count), static_cast<const uint32_t*>(it),
        v, w, d, b, kind);
  }
  return static_cast<int>(cudaGetLastError());
}

int fused_decide(void* t, const void* m, const void* active, const void* nbrs,
                 const void* wl, const void* count, const void* it, int64_t v,
                 int64_t w, int d, int b, int kind, void* stream) {
  using namespace repro_torch;
  if (w > 0) {
    fused_decide_kernel<<<blocks_for(w), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint32_t*>(t), static_cast<const uint32_t*>(m),
        static_cast<const uint8_t*>(active), static_cast<const int32_t*>(nbrs),
        static_cast<const int32_t*>(wl), static_cast<const int32_t*>(count),
        static_cast<const uint32_t*>(it), v, w, d, b, kind);
  }
  return static_cast<int>(cudaGetLastError());
}

int sliced_refresh_columns(const void* t, void* m, const void* slab_rows,
                           const void* nbrs, const void* wl, const void* count,
                           const void* it, int64_t r, int64_t w, int d, int b,
                           int kind, void* stream) {
  using namespace repro_torch;
  if (w > 0) {
    sliced_refresh_columns_kernel<<<blocks_for(w), kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(t), static_cast<uint32_t*>(m),
        static_cast<const int32_t*>(slab_rows),
        static_cast<const int32_t*>(nbrs), static_cast<const int32_t*>(wl),
        static_cast<const int32_t*>(count), static_cast<const uint32_t*>(it),
        r, w, d, b, kind);
  }
  return static_cast<int>(cudaGetLastError());
}

int sliced_decide(void* t, const void* m, const void* active,
                  const void* slab_rows, const void* nbrs, const void* wl,
                  const void* count, const void* it, int64_t r, int64_t w,
                  int d, int b, int kind, void* stream) {
  using namespace repro_torch;
  if (w > 0) {
    sliced_decide_kernel<<<blocks_for(w), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint32_t*>(t), static_cast<const uint32_t*>(m),
        static_cast<const uint8_t*>(active),
        static_cast<const int32_t*>(slab_rows),
        static_cast<const int32_t*>(nbrs), static_cast<const int32_t*>(wl),
        static_cast<const int32_t*>(count), static_cast<const uint32_t*>(it),
        r, w, d, b, kind);
  }
  return static_cast<int>(cudaGetLastError());
}

int refresh_columns(const void* t, const void* rows, void* out, int64_t w,
                    int d, int64_t count, void* stream) {
  using namespace repro_torch;
  if (w > 0) {
    refresh_columns_kernel<<<blocks_for(w), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(t), static_cast<const int32_t*>(rows),
        static_cast<uint32_t*>(out), w, d, count);
  }
  return static_cast<int>(cudaGetLastError());
}

int decide(const void* t_rows, const void* m, const void* active,
           const void* rows, void* out, int64_t w, int d, int64_t count,
           void* stream) {
  using namespace repro_torch;
  if (w > 0) {
    decide_kernel<<<blocks_for(w), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(t_rows), static_cast<const uint32_t*>(m),
        static_cast<const uint8_t*>(active), static_cast<const int32_t*>(rows),
        static_cast<uint32_t*>(out), w, d, count);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
