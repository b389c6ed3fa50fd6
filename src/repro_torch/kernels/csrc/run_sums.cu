// Ordered run sums of a sorted key stream: the accumulation step of the
// multilevel setup's sorted-COO products (the Galerkin product's two
// SpGEMM stages and the smoothed prolongator's A P0).
//
// Replaces no TPU kernel: the JAX package computes this step with XLA's
// segment_sum, which on its CPU backend adds each segment in order.  The
// host engine adds each run in sorted order with np.add.at, and the level
// matrices are held to that engine's bits, so the order is the contract.
// PyTorch's index_add_, scatter_add_ and segment_reduce add with atomics
// or a tree on the card, in an order that is neither this one nor fixed.
//
// Input: keys (int64, sorted, each run of equal keys contiguous), vals
// (float64, in the same order) and the runs' first positions, starts
// (int64, ascending, starts[0] = 0).  Output per run r: its key, the sum of
// its values in stream order, vals[s] + vals[s+1] + ... with each add
// rounded (__dadd_rn, so that nothing is contracted or reassociated), and
// keep = sum != 0.0 (exact zeros, and so -0.0, are dropped by the caller).
// Starting the sum at vals[s] and not at 0.0 changes only the sign of a
// zero total, which keep drops either way.
//
// Bound: memory.  The stream's values are read once (8 B each), and per
// run its start, its head key and the three outputs (8 + 8 + 8 + 8 + 1 B).
// The design: one thread a run, a grid sized to the card striding over the
// runs.  A run's values are contiguous, so a thread walks whole sectors
// and neighbouring threads' runs are neighbouring bytes; runs are short
// (a coarse entry's products: 1 to some hundreds), so the imbalance of one
// long run holds back only its own warp.  No atomics, no shared memory.
#include <cstdint>

#include <cuda_runtime.h>

#include "grid.cuh"

namespace repro_torch {
namespace {

__global__ void __launch_bounds__(kThreads) run_sums_kernel(
    const int64_t* __restrict__ keys, const double* __restrict__ vals,
    const int64_t* __restrict__ starts, int64_t runs, int64_t n,
    int64_t* __restrict__ out_keys, double* __restrict__ sums,
    bool* __restrict__ keep) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       r < runs; r += stride) {
    const int64_t s = starts[r];
    const int64_t e = r + 1 < runs ? starts[r + 1] : n;
    double acc = vals[s];
    for (int64_t i = s + 1; i < e; ++i) acc = __dadd_rn(acc, vals[i]);
    out_keys[r] = keys[s];
    sums[r] = acc;
    keep[r] = acc != 0.0;
  }
}

int launch(const void* keys, const void* vals, const void* starts,
           int64_t runs, int64_t n, void* out_keys, void* sums, void* keep,
           void* stream) {
  if (runs > 0) {
    auto k = run_sums_kernel;
    k<<<grid_for(k, runs, kThreads), kThreads, 0,
        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(keys), static_cast<const double*>(vals),
        static_cast<const int64_t*>(starts), runs, n,
        static_cast<int64_t*>(out_keys), static_cast<double*>(sums),
        static_cast<bool*>(keep));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// per run r of the sorted stream (keys, vals) of n entries, starting at
// starts[r]: out_keys[r], sums[r] (in stream order) and keep[r]
int run_sums(const void* keys, const void* vals, const void* starts,
             int64_t runs, int64_t n, void* out_keys, void* sums, void* keep,
             void* stream) {
  return repro_torch::launch(keys, vals, starts, runs, n, out_keys, sums,
                             keep, stream);
}

}  // extern "C"
