// K6: general-sparsity (CSR / AIJ) SpMV, y = A x.
//
// Replaces the Pallas kernel of slepc_tpu/ops/ell_pallas.py:233
//   hyb_spmv_padded / _hyb_kernel (the hybrid diagonal/gather ELL SpMV).
// The hybrid pack (pack_hyb: dense diagonals in 128-lane roll slots,
// irregular entries in int8 lane-gather bins, an 80-slot budget, a reach of
// one neighbour block) existed only because the TPU's vector unit gathers
// poorly.  Hopper gathers natively, so this kernel takes plain CSR
// (rowptr int64 (m+1), cols int32 (nnz), vals (nnz)) and has none of those
// limits: any pattern, any row length, any m.
//
// Bound: bytes.  One apply streams vals and cols once (nnz * (sizeof(T) +
// 4)), rowptr once ((m+1) * 8), the plan once (4 bytes a block) and writes
// y once; x is gathered, and in a banded (e.g. RCM) order a row's columns
// lie within +-bandwidth, so the x window in flight stays in the 50 MB L2
// and x costs about one DRAM read.  Per call ~ nnz * (sizeof(T) + 4) +
// (m+1) * 8 + 2 * m * sizeof(T) bytes (+ 4 bytes per row block).
//
// What held the earlier design back ("vector CSR", a sub-warp per row) was
// loads in flight, not bandwidth: each thread loaded rowptr, then one
// cols/vals pair, then one x value -- three serial round trips for ~12
// bytes.  Design now (CSR-stream / CSR-adaptive, Greathouse & Daga, SC'14):
// the host plan (ops/csr.py csr_row_blocks) cuts the rows into blocks of
// consecutive rows holding at most `budget` entries (a longer row gets a
// block of its own) and at most kMaxRows rows; one thread block takes one
// row block:
//   * short rows: the block's entries are contiguous, cols[k0:k1] and
//     vals[k0:k1]; each thread loads kUnroll (col, val) pairs at once
//     (coalesced, streaming: they are read once), then starts their kUnroll
//     independent x gathers, and parks the products in shared memory -- a
//     thread keeps 8 pairs and 8 gathers in flight where the old one kept
//     one, so no staging copy of cols/vals is needed (only the products go
//     through shared memory).  Then a group of g lanes per row (g a power
//     of two up to a warp, from the block's row count: 1 for the 7-entry
//     rows of a stencil, more for fewer, longer rows) sums the row's
//     segment in a fixed order, reduces by shuffles and writes y once --
//     the one store of each row, where an epilogue would go;
//   * a row longer than the budget: the plan cuts it into chunks of
//     `chunk` entries, and the grid's first blocks take one chunk each
//     (so a hub row of 10^5 entries is spread over many SMs and starts
//     first): every thread strides the chunk with four partial sums in
//     flight, a fixed-order block reduction gives the chunk's sum, and the
//     last chunk of the row to finish (a counter per long row; the one
//     atomic) adds the chunks' sums in chunk order and writes y.
// The sum order depends only on the plan, so the result is bitwise
// repeatable run to run.  A plan belongs to its rowptr and budget (the
// wrapper passes the plan's own budget).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 1024;     // rows a block of the plan may hold
constexpr int kMaxBudget = 16384;  // entries a block of the plan may hold
constexpr int kUnroll = 8;         // (col, val) pairs a thread has in flight

template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  // fixed order: shuffles within each warp, then thread 0 adds the warps'
  // sums in warp order; the value is valid in thread 0
  v = slepc::warp_sum(v);
  __syncthreads();  // red is reused row after row
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = T(0);
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// entries [k0, k1) of a row by the whole block: strided partial sums, four
// in flight; the sum is valid in thread 0
template <typename T>
__device__ T blockwide_sum(const int* __restrict__ cols,
                           const T* __restrict__ vals, const T* __restrict__ x,
                           int64_t k0, int64_t k1, T* red) {
  T acc[4] = {T(0), T(0), T(0), T(0)};
  int64_t k = k0 + threadIdx.x;
  for (; k + 3 * kThreads < k1; k += 4 * kThreads) {
    int c[4];
    T v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      c[u] = __ldcs(cols + k + u * kThreads);
      v[u] = __ldcs(vals + k + u * kThreads);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u] += v[u] * __ldg(x + c[u]);
  }
  for (; k < k1; k += kThreads) acc[0] += __ldcs(vals + k) * __ldg(x + __ldcs(cols + k));
  return block_sum((acc[0] + acc[1]) + (acc[2] + acc[3]), red);
}

// chunk j of a long row: its sum into partial[j]; the row's last chunk to
// finish adds the row's chunk sums in order and writes y
template <typename T>
__device__ void long_row_chunk(const long long* __restrict__ rp,
                               const int* __restrict__ cols,
                               const T* __restrict__ vals,
                               const T* __restrict__ x, T* __restrict__ y,
                               const int* __restrict__ long_rows,
                               const int* __restrict__ chunk_first,
                               const int* __restrict__ chunk_row, int chunk,
                               T* partial, int* done, T* red, int j) {
  __shared__ int last;
  const int li = __ldg(chunk_row + j);
  const int r = __ldg(long_rows + li);
  const int c0 = __ldg(chunk_first + li), c1 = __ldg(chunk_first + li + 1);
  const int64_t start = __ldg(rp + r), end = __ldg(rp + r + 1);
  const int64_t k0 = start + static_cast<int64_t>(j - c0) * chunk;
  const int64_t k1 = k0 + chunk < end ? k0 + chunk : end;
  const T s = blockwide_sum(cols, vals, x, k0, k1, red);
  if (threadIdx.x == 0) {
    partial[j] = s;
    __threadfence();  // the sum is visible before the count says so
    last = atomicAdd(done + li, 1) == c1 - c0 - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    T total = T(0);
    for (int q = c0; q < c1; ++q) total += __ldcg(partial + q);
    y[r] = total;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_spmv_kernel(const int64_t* __restrict__ rowptr, const int* __restrict__ cols,
                const T* __restrict__ vals, const T* __restrict__ x,
                T* __restrict__ y, const int* __restrict__ starts, int budget,
                const int* __restrict__ long_rows,
                const int* __restrict__ chunk_first,
                const int* __restrict__ chunk_row, int nchunks, int chunk,
                T* partial, int* done) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* prod = reinterpret_cast<T*>(smem_raw);            // budget products
  int* roff = reinterpret_cast<int*>(prod + budget);   // kMaxRows + 1 offsets
  __shared__ T red[kWarps];
  const long long* rp = reinterpret_cast<const long long*>(rowptr);
  if (static_cast<int>(blockIdx.x) < nchunks) {  // the long rows first
    long_row_chunk(rp, cols, vals, x, y, long_rows, chunk_first, chunk_row,
                   chunk, partial, done, red, blockIdx.x);
    return;
  }
  const int b = blockIdx.x - nchunks;
  const int r0 = __ldg(starts + b);
  const int r1 = __ldg(starts + b + 1);
  const int nr = r1 - r0;
  const int64_t k0 = __ldg(rp + r0);
  const int64_t nnz = __ldg(rp + r1) - k0;
  if (nnz > budget || nr > kMaxRows) return;  // a long row: its chunks
  for (int i = threadIdx.x; i <= nr; i += kThreads)
    roff[i] = static_cast<int>(__ldg(rp + r0 + i) - k0);
  const int cnt = static_cast<int>(nnz);
  const int* cb = cols + k0;
  const T* vb = vals + k0;
  for (int base = threadIdx.x; base < cnt; base += kThreads * kUnroll) {
    int c[kUnroll];
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = base + u * kThreads;
      c[u] = k < cnt ? __ldcs(cb + k) : 0;
      v[u] = k < cnt ? __ldcs(vb + k) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = base + u * kThreads;
      if (k < cnt) prod[k] = v[u] * __ldg(x + c[u]);
    }
  }
  __syncthreads();
  // g lanes per row: the largest power of two (<= 32) that keeps the
  // block's rows within its threads
  int g = 1;
  while (g < 32 && 2 * g * nr <= kThreads) g *= 2;
  const int lane = threadIdx.x & (g - 1);
  const int grp = threadIdx.x / g;
  const int ngrp = kThreads / g;
  for (int rb = 0; rb < nr; rb += ngrp) {  // the same trip count in every warp
    const int r = rb + grp;
    T acc = T(0);
    if (r < nr)
      for (int k = roff[r] + lane; k < roff[r + 1]; k += g) acc += prod[k];
    for (int s = g >> 1; s > 0; s >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, s, g);
    if (lane == 0 && r < nr) y[r0 + r] = acc;
  }
}

template <typename T>
cudaError_t launch(const int64_t* rowptr, const int* cols, const void* vals,
                   const void* x, void* y, const int* starts, int64_t nblocks,
                   int budget, const int* long_rows, const int* chunk_first,
                   const int* chunk_row, int64_t nchunks, int chunk,
                   void* partial, int* done, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(budget) * sizeof(T)
      + (kMaxRows + 1) * sizeof(int);
  cudaError_t err = slepc::allow_smem(csr_spmv_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  csr_spmv_kernel<T><<<static_cast<unsigned>(nblocks + nchunks), kThreads,
                       smem, stream>>>(
      rowptr, cols, static_cast<const T*>(vals), static_cast<const T*>(x),
      static_cast<T*>(y), starts, budget, long_rows, chunk_first, chunk_row,
      static_cast<int>(nchunks), chunk, static_cast<T*>(partial), done);
  return cudaGetLastError();
}

}  // namespace

extern "C" int slepc_csr_max_rows() { return kMaxRows; }
extern "C" int slepc_csr_max_budget() { return kMaxBudget; }

// rowptr (m+1) int64, cols (nnz) int32, vals (nnz), x (ncols), y (m), starts
// (nblocks+1) int32 row-block starts ending at m; long_rows (nlong) int32,
// chunk_first (nlong+1) int32, chunk_row (nchunks) int32: the plan's long
// rows and their chunks of `chunk` entries; partial (nchunks) scratch and
// done (nlong) int32 zeros: device arrays.  nblocks == 0 launches nothing.
extern "C" int slepc_csr_spmv(int dtype, const void* rowptr, const void* cols,
                              const void* vals, const void* x, void* y,
                              const void* starts, int64_t nblocks, int budget,
                              const void* long_rows, const void* chunk_first,
                              const void* chunk_row, int64_t nchunks, int chunk,
                              void* partial, void* done, void* stream) {
  if (nblocks < 0 || nchunks < 0 || nblocks + nchunks >= (int64_t(1) << 31)
      || budget < 1 || budget > kMaxBudget || (nchunks > 0 && chunk < 1))
    return cudaErrorInvalidValue;
  if (nblocks == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* rp = static_cast<const int64_t*>(rowptr);
  const int* ci = static_cast<const int*>(cols);
  const int* st = static_cast<const int*>(starts);
  const int* lr = static_cast<const int*>(long_rows);
  const int* cf = static_cast<const int*>(chunk_first);
  const int* cr = static_cast<const int*>(chunk_row);
  int* dn = static_cast<int*>(done);
  if (dtype == slepc::kF32)
    return launch<float>(rp, ci, vals, x, y, st, nblocks, budget, lr, cf, cr,
                         nchunks, chunk, partial, dn, s);
  if (dtype == slepc::kF64)
    return launch<double>(rp, ci, vals, x, y, st, nblocks, budget, lr, cf, cr,
                          nchunks, chunk, partial, dn, s);
  return cudaErrorInvalidValue;
}
