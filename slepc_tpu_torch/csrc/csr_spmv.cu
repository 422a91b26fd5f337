// K6: general-sparsity (CSR / AIJ) SpMV, y = A x.
//
// Replaces the Pallas kernel of slepc_tpu/ops/ell_pallas.py:
//   _hyb_kernel / hyb_spmv_padded (the hybrid diagonal/gather ELL SpMV).
// The hybrid pack (pack_hyb: dense diagonals in 128-lane roll slots,
// irregular entries in int8 lane-gather bins, an 80-slot budget, a reach of
// one neighbour block) existed only because the TPU's vector unit gathers
// poorly.  Hopper gathers natively, so this kernel takes plain CSR
// (rowptr int64 (m+1), cols int32 (nnz), vals (nnz)) and has none of those
// limits: any pattern, any row length, any m.
//
// Bound: bytes.  One apply streams vals and cols once (nnz * (sizeof(T) +
// 4)), rowptr once ((m+1) * 8) and writes y once; x is gathered, and in a
// banded (e.g. RCM) order a row's columns lie within +-bandwidth, so the x
// window in flight stays in the 50 MB L2 and x costs about one DRAM read.
// Per call ~ nnz * (sizeof(T) + 4) + (m+1) * 8 + 2 * m * sizeof(T) bytes.
// Design ("vector CSR"): a sub-warp of L lanes per row, L a power of two in
// [2, 32] picked on the host from the mean row length.  The lanes stride the
// row's cols/vals (coalesced), gather x through the read-only path (__ldg),
// reduce with __shfl_down_sync inside the sub-warp and lane 0 writes y once.
// A row longer than L just takes more strides.  No shared memory, no
// atomics: the sum order is fixed, so the result is deterministic.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
csr_spmv_kernel(const int64_t* __restrict__ rowptr, const int* __restrict__ cols,
                const T* __restrict__ vals, const T* __restrict__ x,
                T* __restrict__ y, int64_t m) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row = tid / L;
  // every lane of a sub-warp shares its row, so a sub-warp is wholly in or
  // out of range and the shuffle below always has all L lanes
  if (row >= m) return;
  const int lane = threadIdx.x & (L - 1);
  const long long* rp = reinterpret_cast<const long long*>(rowptr) + row;
  const int64_t begin = __ldg(rp);
  const int64_t end = __ldg(rp + 1);
  T acc = T(0);
  for (int64_t k = begin + lane; k < end; k += L)
    acc += __ldg(vals + k) * __ldg(x + __ldg(cols + k));
  // the sub-warp's own lanes within the warp
  const unsigned mask = (L == 32) ? 0xffffffffu
      : (((1u << (L & 31)) - 1u) << (threadIdx.x & 31 & ~(L - 1)));
#pragma unroll
  for (int s = L / 2; s > 0; s >>= 1) acc += __shfl_down_sync(mask, acc, s, L);
  if (lane == 0) y[row] = acc;
}

template <typename T, int L>
cudaError_t launch_l(const int64_t* rowptr, const int* cols, const void* vals,
                     const void* x, void* y, int64_t m, cudaStream_t stream) {
  const int64_t blocks = (m * L + kThreads - 1) / kThreads;
  csr_spmv_kernel<T, L><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      rowptr, cols, static_cast<const T*>(vals), static_cast<const T*>(x),
      static_cast<T*>(y), m);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int lanes, const int64_t* rowptr, const int* cols,
                   const void* vals, const void* x, void* y, int64_t m,
                   cudaStream_t s) {
  switch (lanes) {
    case 2: return launch_l<T, 2>(rowptr, cols, vals, x, y, m, s);
    case 4: return launch_l<T, 4>(rowptr, cols, vals, x, y, m, s);
    case 8: return launch_l<T, 8>(rowptr, cols, vals, x, y, m, s);
    case 16: return launch_l<T, 16>(rowptr, cols, vals, x, y, m, s);
    case 32: return launch_l<T, 32>(rowptr, cols, vals, x, y, m, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// rowptr (m+1) int64, cols (nnz) int32, vals (nnz), x (ncols), y (m): device
// arrays.  m == 0 launches nothing.
extern "C" int slepc_csr_spmv(int dtype, int lanes, const void* rowptr,
                              const void* cols, const void* vals, const void* x,
                              void* y, int64_t m, void* stream) {
  if (m < 0 || m > (int64_t(1) << 31)) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* rp = static_cast<const int64_t*>(rowptr);
  const int* ci = static_cast<const int*>(cols);
  if (dtype == slepc::kF32) return launch<float>(lanes, rp, ci, vals, x, y, m, s);
  if (dtype == slepc::kF64) return launch<double>(lanes, rp, ci, vals, x, y, m, s);
  return cudaErrorInvalidValue;
}
