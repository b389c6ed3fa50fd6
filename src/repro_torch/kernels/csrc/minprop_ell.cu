// The two passes of one device-resident MIS-2 round over padded ELL.
//
// Replace repro/kernels/minprop_ell/kernel.py:fused_refresh_columns_pallas
// and :fused_decide_pallas, each followed by the scatter
// `x.at[wl].set(out, mode="drop")` of repro/kernels/minprop_ell/ops.py:
// here the kernel writes its row in place and skips dead slots, so there
// is no [W] output and no separate scatter.
//
// Layout: T, M are [V] uint32 words (stored by torch as int32 bit
// patterns), nbrs is the flat self-padded ELL adjacency [V * D] int32,
// wl is a [W] worklist whose first *count slots are live rows (a slot may
// hold the sentinel V, which is skipped); count and it live on the device,
// so the host never reads them.
//
// Bound: memory.  Per live slot a pass reads wl, the row's D neighbour
// ids (contiguous) and one 4-byte word per neighbour at a data-dependent
// address, and writes one word.  One thread per slot loops over the row;
// a warp per row (coalesced id reads, paper §V-D) is later work.  Blocks
// wholly past *count exit before touching memory, standing in for the
// TPU's pl.when block skipping.
#include <cstdint>

#include <cuda_runtime.h>

#include "hash.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

// M[row] = min over the closed neighbourhood of the refreshed T, IN -> OUT
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
  const uint32_t it = *it_ptr;
  const int32_t* r = nbrs + static_cast<int64_t>(row) * d;
  uint32_t mn = kOut;
  for (int j = 0; j < d; ++j) {
    const int32_t nb = r[j];
    const uint32_t tv = refresh(t[nb], static_cast<uint32_t>(nb), kind, it, b);
    mn = tv < mn ? tv : mn;
  }
  m[row] = mn == kIn ? kOut : mn;
}

// T[row] <- OUT if an active neighbour's M is OUT, else IN if every active
// neighbour's M equals the row's refreshed tuple, else the refreshed tuple;
// decided rows are left as they are.  Reads T only at its own row.
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
  const uint32_t told = t[row];
  if (!is_undecided(told)) return;
  const uint32_t tv = refresh(told, static_cast<uint32_t>(row), kind, *it_ptr, b);
  const int32_t* r = nbrs + static_cast<int64_t>(row) * d;
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

}  // extern "C"
