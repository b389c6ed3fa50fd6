// ELL SpMV and its transpose: the AMG solve's hot loop.
//
// spmv_ell replaces repro/kernels/spmv_ell/kernel.py:spmv_ell_pallas
// (y = A x over padded ELL, f32 accumulation); spmv_ell_t replaces
// :spmv_ell_t_pallas (y = P^T x for a rectangular ELL P: the matrix-free
// restriction of the V-cycle).
//
// The bits.  Each output row sums its products one at a time, in a fixed
// order, starting from 0.0f, with __fmul_rn / __fadd_rn (nvcc's default
// --fmad=true would otherwise contract the pair into an FMA, and the
// plain-torch twins, a separate multiply and add, could not match).
// spmv_ell sums in slot order; padded ELL slots carry val == 0, so no mask
// is read.  The TPU transposed kernel scatter-adds into a VMEM-resident
// output in the order of its sequential grid; blocks run in no order here
// and a float atomicAdd would change the bits from run to run, so the
// transpose is a gather: at setup the caller stores a stable column-sorted
// permutation of P's real slots (perm, int32 [nnz]) and the column offsets
// (int32 [num_out + 1]), and output row c sums its segment
// perm[offsets[c] .. offsets[c+1]] in that order: ascending fine row, the
// order of the explicit R = P^T rows, so spmv_ell_t(P) equals
// spmv_ell(R) bit for bit.
//
// Bound: memory.  spmv_ell reads cols and vals once (8 B a slot), x at the
// gathered columns and writes y; spmv_ell_t reads perm, P's vals at the
// permuted slots and x at their rows, and writes y.
//
// The design: stage the products, then sum in order.  A block owns a
// contiguous range of output rows, and so a contiguous range of slots:
// [r0*D, (r0+R)*D) of cols / vals (ELL is row-major), or
// perm[offsets[c0] .. offsets[c0+R]] (perm is sorted by column).
//  1. Products: all 256 threads stride through the range together, so
//     each warp load is coalesced and many independent x gathers are in
//     flight; each writes __fmul_rn(val, x[col]) to shared memory.  A
//     product is rounded on its own, so computing it in parallel leaves
//     its bits as they were.
//  2. Ordered sum: after __syncthreads(), thread t < R adds its own row's
//     products from shared memory with __fadd_rn, in order, from 0.0f.
// A range larger than the staging budget is walked in chunks, each thread
// carrying its sum across them: chunks of the D columns for spmv_ell (only
// past D = 191), chunks of the perm range for spmv_ell_t (a long segment,
// a hub column).
//
// spmv_ell stages rows as [R][stride] words with an odd stride (D, or D+1
// for even D), so that thread t reading word t*stride + j in step 2 hits
// 32 distinct banks.  R is the largest power of two in [32, 256] whose
// rows fit kProductBytes (room for 8 blocks an SM): 256 at D = 7 (7 KB),
// 64 at D = 81 (20.7 KB).  When the range is whole (D <= 191) and cols /
// vals are 16-byte aligned, step 1 reads them as int4 / float4: one group
// of 4 slots a thread and turn at D <= 16 (32 registers, 8 blocks an SM),
// two above (more bytes in flight; 48 registers).
// spmv_ell_t stages the chunk (2,048 products) flat, as perm orders it,
// gives a block 64 coarse rows, and keeps 8 perm loads, then 16 gathers, in
// flight a thread: one long segment serialises only its own thread's sum,
// while the products stay spread over the whole block.  Its gathers of
// P's vals and x at scattered rows, not its streamed reads, bound it.
// The constants below are the measured best on an H100; tools/bench_spmv.py
// builds variants of them by rewriting this source.
#include <cstdint>

#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 256;                        // loaders per block
constexpr int kMaxRows = 256;                        // rows per block
constexpr int kMinRows = 32;
constexpr int kProductBytes = 24576;   // spmv_ell's stage: 8 blocks an SM
constexpr int kUnroll = 4;             // scalar loads in flight a thread
constexpr int kNarrow = 16;     // widths up to this take one int4 a turn
constexpr int kTRows = 64;                           // spmv_ell_t rows
constexpr int kTChunk = 2048;                        // products a chunk
constexpr int kTUnroll = 8;              // perm loads in flight a thread
static_assert(kTRows <= kThreads && kMaxRows <= kThreads, "a summer a row");

// Rows per block, columns per chunk and the odd row stride of spmv_ell's
// staging for width d, and whether the 16-byte loads may be used.
struct Plan {
  int rows, width, stride, vec;
};

int odd(int w) { return w | 1; }

Plan spmv_plan(int d, bool aligned) {
  int rows = kMaxRows;
  while (rows > kMinRows && rows * odd(d) * 4 > kProductBytes) rows /= 2;
  int width = d;
  if (rows * odd(d) * 4 > kProductBytes) width = kProductBytes / 4 / rows - 1;
  return {rows, width, odd(width), aligned && width == d};
}

// Products of one chunk, scalar loads: item i of [0, n) is (row r,
// column c) = (i / w, i % w), global slot base + r*d + c, staged at
// r*stride + c; (r, c) are stepped, not divided.
__device__ __forceinline__ void stage_scalar(
    const int32_t* __restrict__ cols, const float* __restrict__ vals,
    const float* __restrict__ x, float* prod, int64_t base, int n, int w,
    int d, int stride) {
  const int t = threadIdx.x;
  const int dr = kThreads / w, dc = kThreads % w;
  int r = t / w, c = t % w;
  for (int i = t; i < n; i += kUnroll * kThreads) {
    int32_t col[kUnroll];
    float val[kUnroll];
    int at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      col[u] = 0;
      val[u] = 0.0f;
      at[u] = -1;
      if (i + u * kThreads < n) {
        const int64_t s = base + static_cast<int64_t>(r) * d + c;
        col[u] = __ldcs(cols + s);
        val[u] = __ldcs(vals + s);
        at[u] = r * stride + c;
      }
      c += dc;
      r += dr;
      if (c >= w) {
        c -= w;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (at[u] >= 0) prod[at[u]] = __fmul_rn(val[u], x[col[u]]);
    }
  }
}

// Products of the whole range (w == d, so the range is contiguous and,
// with r0 a multiple of 32, 16-byte aligned): group g is the items 4g ..
// 4g+3, read as one int4 and one float4; (r, c) is the row and column of
// item 4g.  An odd d stages item i at word i, so the group is one 16-byte
// shared store; an even d pads each row by a word.
template <int kVecUnroll>
__device__ __forceinline__ void stage_vec4(
    const int32_t* __restrict__ cols, const float* __restrict__ vals,
    const float* __restrict__ x, float* prod, int64_t base, int n, int d,
    int stride) {
  const int t = threadIdx.x;
  const int ng = n >> 2;
  const int4* c4 = reinterpret_cast<const int4*>(cols + base);
  const float4* v4 = reinterpret_cast<const float4*>(vals + base);
  const int dr = 4 * kThreads / d, dc = 4 * kThreads % d;
  int r = 4 * t / d, c = 4 * t % d;
  for (int g = t; g < ng; g += kVecUnroll * kThreads) {
    int4 cc[kVecUnroll];
    float4 vv[kVecUnroll];
    int rr[kVecUnroll], c1[kVecUnroll];
#pragma unroll
    for (int u = 0; u < kVecUnroll; ++u) {
      if (g + u * kThreads < ng) {
        cc[u] = __ldcs(c4 + g + u * kThreads);
        vv[u] = __ldcs(v4 + g + u * kThreads);
      }
      rr[u] = r;
      c1[u] = c;
      c += dc;
      r += dr;
      if (c >= d) {
        c -= d;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kVecUnroll; ++u) {
      if (g + u * kThreads >= ng) continue;
      const float p[4] = {__fmul_rn(vv[u].x, x[cc[u].x]),
                          __fmul_rn(vv[u].y, x[cc[u].y]),
                          __fmul_rn(vv[u].z, x[cc[u].z]),
                          __fmul_rn(vv[u].w, x[cc[u].w])};
      if (stride == d) {
        reinterpret_cast<float4*>(prod)[g + u * kThreads] =
            make_float4(p[0], p[1], p[2], p[3]);
      } else {
        int pr = rr[u], pc = c1[u];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          prod[pr * stride + pc] = p[e];
          if (++pc == d) {
            pc = 0;
            ++pr;
          }
        }
      }
    }
  }
  const int i = 4 * ng + t;                // the last n % 4 items
  if (i < n) {
    prod[i / d * stride + i % d] = __fmul_rn(vals[base + i], x[cols[base + i]]);
  }
}

template <int kVecUnroll>
__global__ void __launch_bounds__(kThreads)
spmv_ell_kernel(const int32_t* __restrict__ cols,
                const float* __restrict__ vals, const float* __restrict__ x,
                float* __restrict__ y, int64_t rows, int d, Plan plan) {
  extern __shared__ __align__(16) float prod[];
  const int t = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * plan.rows;
  const int nr = static_cast<int>(
      rows - r0 < plan.rows ? rows - r0 : plan.rows);
  float acc = 0.0f;
  for (int j0 = 0; j0 < d; j0 += plan.width) {
    const int w = d - j0 < plan.width ? d - j0 : plan.width;
    if (plan.vec) {
      stage_vec4<kVecUnroll>(cols, vals, x, prod, r0 * d, nr * d, d,
                             plan.stride);
    } else {
      stage_scalar(cols, vals, x, prod, r0 * d + j0, nr * w, w, d,
                   plan.stride);
    }
    __syncthreads();
    if (t < nr) {
      const float* p = prod + t * plan.stride;
      for (int k = 0; k < w; ++k) acc = __fadd_rn(acc, p[k]);
    }
    __syncthreads();
  }
  if (t < nr) y[r0 + t] = acc;
}

__global__ void __launch_bounds__(kThreads)
spmv_ell_t_kernel(const float* __restrict__ vals,
                  const int32_t* __restrict__ perm,
                  const int32_t* __restrict__ offsets,
                  const float* __restrict__ x, float* __restrict__ y,
                  int64_t num_out, int d) {
  __shared__ float prod[kTChunk];
  const int t = threadIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kTRows;
  const int nr = static_cast<int>(
      num_out - c0 < kTRows ? num_out - c0 : kTRows);
  const int32_t kb = offsets[c0], ke = offsets[c0 + nr];
  int32_t lo = 0, hi = 0;                  // this thread's segment
  if (t < nr) {
    lo = offsets[c0 + t];
    hi = offsets[c0 + t + 1];
  }
  const uint32_t ud = static_cast<uint32_t>(d);
  float acc = 0.0f;
  for (int32_t k0 = kb; k0 < ke; k0 += kTChunk) {
    const int n = ke - k0 < kTChunk ? ke - k0 : kTChunk;
    for (int i = t; i < n; i += kTUnroll * kThreads) {
      uint32_t s[kTUnroll];
#pragma unroll
      for (int u = 0; u < kTUnroll; ++u) {
        s[u] = 0;
        if (i + u * kThreads < n) {
          s[u] = static_cast<uint32_t>(__ldcs(perm + k0 + i + u * kThreads));
        }
      }
      float v[kTUnroll], xv[kTUnroll];
#pragma unroll
      for (int u = 0; u < kTUnroll; ++u) {
        v[u] = 0.0f;
        xv[u] = 0.0f;
        if (i + u * kThreads < n) {    // flat slot of P: row * d + j
          v[u] = vals[s[u]];
          xv[u] = x[s[u] / ud];
        }
      }
#pragma unroll
      for (int u = 0; u < kTUnroll; ++u) {
        if (i + u * kThreads < n) {
          prod[i + u * kThreads] = __fmul_rn(v[u], xv[u]);
        }
      }
    }
    __syncthreads();
    const int32_t a = lo > k0 ? lo : k0;
    const int32_t b = hi < k0 + n ? hi : k0 + n;
    for (int32_t k = a; k < b; ++k) acc = __fadd_rn(acc, prod[k - k0]);
    __syncthreads();
  }
  if (t < nr) y[c0 + t] = acc;
}

}  // namespace
}  // namespace repro_torch

extern "C" {

int spmv_ell(const void* cols, const void* vals, const void* x, void* y,
             int64_t rows, int d, void* stream) {
  using namespace repro_torch;
  if (rows > 0) {
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(cols) |
          reinterpret_cast<uintptr_t>(vals)) & 15) == 0;
    const Plan plan = spmv_plan(d, aligned);
    const int64_t blocks = (rows + plan.rows - 1) / plan.rows;
    const size_t smem = static_cast<size_t>(plan.rows) * plan.stride * 4;
    auto kernel = d <= kNarrow ? spmv_ell_kernel<1> : spmv_ell_kernel<2>;
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(x), static_cast<float*>(y), rows, d, plan);
  }
  return static_cast<int>(cudaGetLastError());
}

int spmv_ell_t(const void* vals, const void* perm, const void* offsets,
               const void* x, void* y, int64_t num_out, int d, void* stream) {
  using namespace repro_torch;
  if (num_out > 0) {
    const int64_t blocks = (num_out + kTRows - 1) / kTRows;
    spmv_ell_t_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), static_cast<const int32_t*>(perm),
        static_cast<const int32_t*>(offsets), static_cast<const float*>(x),
        static_cast<float*>(y), num_out, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
