// K1 + K2: DIA (diagonal-offset) SpMV, y[i] = sum_k d_k[i] * x[i + off_k],
// with x taken as zero outside [0, n).  K5 (below): the same operator on b
// vectors at once.
//
// Replaces the Pallas kernels of slepc_tpu/ops/dia_pallas.py:
//   dia_spmv_prepared / _dia_kernel, dia_spmv_padded / _dia_kernel2,
//   dia_spmv_padded_v3 / _dia_kernel3p (f32, K1) and
//   dia_spmv_padded_ds / _dia_kernel_ds (f64 in double-single, K2).
// Hopper has native f64, so the f64 instantiation computes in f64 and the
// padded (rows, 512)-lane layout with zero halo blocks is gone: vectors are
// flat (n,) and the bounds check stands in for the halo.
//
// Bound: bytes.  One apply reads every diagonal once and writes y once; x is
// read once from DRAM when the stencil's neighbours hit in L2 (the flagship
// offsets +-1, +-200, +-45000 span 0.7 MB of f64 x, far inside the 50 MB
// L2).  Per call: (nd + 2) * n * sizeof(T) bytes, e.g. 9 * 10.35M * 8 =
// 745 MB for the f64 flagship apply.
// Design: one thread per row in a grid-stride loop, so each diagonal row
// and y are read/written fully coalesced; offsets travel by value in the
// kernel's parameter space.  No shared memory, no atomics.
#include "common.cuh"

namespace {

constexpr int kMaxDiags = 32;
constexpr int kThreads = 256;
constexpr int kMaxB = 8;  // vectors K5 holds in registers (K3's bound too)

struct DiaOffsets {
  int64_t off[kMaxDiags];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ diags, int64_t ld, DiaOffsets offs,
                int nd, const T* __restrict__ x, T* __restrict__ y, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    T acc = T(0);
    for (int k = 0; k < nd; ++k) {
      const int64_t j = i + offs.off[k];
      if (j >= 0 && j < n) acc += diags[k * ld + i] * x[j];
    }
    y[i] = acc;
  }
}

template <typename T>
cudaError_t launch(const void* diags, int64_t ld, const int64_t* offsets,
                   int nd, const void* x, void* y, int64_t n,
                   cudaStream_t stream) {
  DiaOffsets offs;
  for (int k = 0; k < nd; ++k) offs.off[k] = offsets[k];
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 16384) blocks = 16384;
  if (blocks < 1) blocks = 1;
  dia_spmv_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(diags), ld, offs, nd, static_cast<const T*>(x),
      static_cast<T*>(y), n);
  return cudaGetLastError();
}

// K5: block DIA SpMM, Y[m, i] = sum_k d_k[i] * X[m, i + off_k] for m < b,
// X and Y (b, n) with row strides ldx / ldy (X may be a slice of a taller
// basis: no copy).
//
// Replaces the Pallas kernel of slepc_tpu/ops/dia_pallas.py:
//   dia_spmv_padded_block / _dia_kernel2b (f32 only on the TPU; the f64
//   blocked cycle there vmapped the double-single single-vector kernel).
// The TPU kernel's sub-block grid, halo rounding, VMEM budget and its vmap
// fallback past one sub-block of row reach were TPU workarounds; K5 has no
// reach limit.
//
// Bound: bytes.  The point of the kernel is that each diagonal is read ONCE
// for all b vectors: per call (nd + 2b) * n * sizeof(T) bytes (diagonals
// once, X once with its neighbours hitting in L2, Y once), against
// b * (nd + 2) * n for b K1/K2 calls -- 1.24 GB instead of 2.98 GB for the
// f64 flagship at b = 4.
// Design: K1's, one thread per row in a grid-stride loop; the thread reads
// d_k[i] once per diagonal and applies it to all b vectors, whose sums sit in
// registers (acc[kMaxB], loops unrolled, guarded by m < b).  Offsets travel
// by value.  No shared memory, no atomics.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmm_kernel(const T* __restrict__ diags, int64_t ld, DiaOffsets offs,
                int nd, const T* __restrict__ X, int64_t ldx,
                T* __restrict__ Y, int64_t ldy, int b, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    T acc[kMaxB];
#pragma unroll
    for (int m = 0; m < kMaxB; ++m) acc[m] = T(0);
    for (int k = 0; k < nd; ++k) {
      const int64_t j = i + offs.off[k];
      if (j >= 0 && j < n) {
        const T d = diags[k * ld + i];
#pragma unroll
        for (int m = 0; m < kMaxB; ++m)
          if (m < b) acc[m] += d * X[m * ldx + j];
      }
    }
#pragma unroll
    for (int m = 0; m < kMaxB; ++m)
      if (m < b) Y[m * ldy + i] = acc[m];
  }
}

template <typename T>
cudaError_t launch_block(const void* diags, int64_t ld, const int64_t* offsets,
                         int nd, const void* X, int64_t ldx, void* Y,
                         int64_t ldy, int b, int64_t n, cudaStream_t stream) {
  DiaOffsets offs;
  for (int k = 0; k < nd; ++k) offs.off[k] = offsets[k];
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 16384) blocks = 16384;
  if (blocks < 1) blocks = 1;
  dia_spmm_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(diags), ld, offs, nd, static_cast<const T*>(X), ldx,
      static_cast<T*>(Y), ldy, b, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int slepc_dia_max_diags() { return kMaxDiags; }
extern "C" int slepc_dia_spmm_max_b() { return kMaxB; }

extern "C" const char* slepc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// diags: (nd, ld) device array, row k holds d_k[0:n]; offsets: host array.
extern "C" int slepc_dia_spmv(int dtype, const void* diags, int64_t ld,
                              const int64_t* offsets, int nd, const void* x,
                              void* y, int64_t n, void* stream) {
  if (nd < 1 || nd > kMaxDiags || n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == slepc::kF32)
    return launch<float>(diags, ld, offsets, nd, x, y, n, s);
  if (dtype == slepc::kF64)
    return launch<double>(diags, ld, offsets, nd, x, y, n, s);
  return cudaErrorInvalidValue;
}

// X (b, ldx) and Y (b, ldy) device arrays, rows contiguous; 1 <= b <= kMaxB.
extern "C" int slepc_dia_spmm(int dtype, const void* diags, int64_t ld,
                              const int64_t* offsets, int nd, const void* X,
                              int64_t ldx, void* Y, int64_t ldy, int b,
                              int64_t n, void* stream) {
  if (nd < 1 || nd > kMaxDiags || n < 1 || b < 1 || b > kMaxB)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == slepc::kF32)
    return launch_block<float>(diags, ld, offsets, nd, X, ldx, Y, ldy, b, n, s);
  if (dtype == slepc::kF64)
    return launch_block<double>(diags, ld, offsets, nd, X, ldx, Y, ldy, b, n, s);
  return cudaErrorInvalidValue;
}
