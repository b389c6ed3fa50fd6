// ELL SpMV and its transpose: the AMG solve's hot loop.
//
// spmv_ell replaces repro/kernels/spmv_ell/kernel.py:spmv_ell_pallas
// (y = A x over padded ELL, f32 accumulation); spmv_ell_t replaces
// :spmv_ell_t_pallas (y = P^T x for a rectangular ELL P: the matrix-free
// restriction of the V-cycle).
//
// Both sum a row's products one at a time, in a fixed order, with
// __fmul_rn / __fadd_rn: nvcc's default --fmad=true would otherwise
// contract the pair into an FMA and the plain-torch twins (separate
// multiply and add) could not match bit for bit.  Padded ELL slots carry
// val == 0, so no mask is read.
//
// The TPU transposed kernel scatter-adds into a VMEM-resident output in
// the order of its sequential grid.  Blocks run in no order here, and a
// float atomicAdd would change the sum's bits from run to run, so the
// transpose is a gather instead: at setup the caller stores a stable
// column-sorted permutation of P's real slots (perm, int32 [nnz]) and the
// column offsets (int32 [num_out + 1]); one thread per output row sums its
// segment in ascending fine-row order.  That is the order of the explicit
// R = P^T rows, so spmv_ell_t(P) equals spmv_ell(R) bit for bit.
//
// Bound: memory.  spmv_ell reads cols and vals once (8 B per slot), x at
// the gathered columns and writes y; spmv_ell_t reads perm, P's vals at
// the permuted slots and x at their rows, and writes y.  One thread per
// row reads its row's slots strided across the warp (uncoalesced for wide
// rows); a warp per row is later work.
#include <cstdint>

#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

__global__ void spmv_ell_kernel(const int32_t* __restrict__ cols,
                                const float* __restrict__ vals,
                                const float* __restrict__ x,
                                float* __restrict__ y, int64_t rows, int d) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const int64_t base = i * d;
  float acc = 0.0f;
  for (int j = 0; j < d; ++j) {
    acc = __fadd_rn(acc, __fmul_rn(vals[base + j], x[cols[base + j]]));
  }
  y[i] = acc;
}

__global__ void spmv_ell_t_kernel(const float* __restrict__ vals,
                                  const int32_t* __restrict__ perm,
                                  const int32_t* __restrict__ offsets,
                                  const float* __restrict__ x,
                                  float* __restrict__ y, int64_t num_out,
                                  int d) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= num_out) return;
  const int32_t end = offsets[c + 1];
  float acc = 0.0f;
  for (int32_t k = offsets[c]; k < end; ++k) {
    const int32_t s = perm[k];           // flat slot of P: row * d + j
    acc = __fadd_rn(acc, __fmul_rn(vals[s], x[s / d]));
  }
  y[c] = acc;
}

int blocks_for(int64_t n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

int spmv_ell(const void* cols, const void* vals, const void* x, void* y,
             int64_t rows, int d, void* stream) {
  using namespace repro_torch;
  if (rows > 0) {
    spmv_ell_kernel<<<blocks_for(rows), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(x), static_cast<float*>(y), rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}

int spmv_ell_t(const void* vals, const void* perm, const void* offsets,
               const void* x, void* y, int64_t num_out, int d, void* stream) {
  using namespace repro_torch;
  if (num_out > 0) {
    spmv_ell_t_kernel<<<blocks_for(num_out), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), static_cast<const int32_t*>(perm),
        static_cast<const int32_t*>(offsets), static_cast<const float*>(x),
        static_cast<float*>(y), num_out, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
