// K4: the Krylov-Schur restart rotation (BVMultInPlace role),
//   out[p, i] = sum_k Q[k, p] * V[k, i],   Q (K, P), V (K, n), out (P, n).
//
// Replaces the Pallas kernel of slepc_tpu/ops/rotate_pallas.py:
// rotate_basis_ds / _rotate_ds_once / _rotate_kernel, which computed in
// double-single (hi, lo) f32 because Mosaic rejected f64.  Here the f64
// instantiation computes in f64; the f32 one serves f32 bases.
//
// Bound: bytes.  One call reads V once and writes out once:
// (K + P) * n * sizeof(T) bytes, e.g. (48 + 40) * 10.35M * 8 = 7.3 GB at the
// flagship restart.  The K * P * n multiply-adds (20 G at the flagship) are
// served from shared memory and registers.
// Design: Q sits in shared memory for the whole kernel (K * P * 8 bytes,
// 15 KB at 48 x 40).  A block owns a 64-column tile at a time: it copies the
// K x 64 V tile into shared memory with coalesced row reads (each V element
// leaves DRAM once), then each thread produces kRows output rows of one
// column from that tile, reusing each V value from a register for kRows
// multiply-adds.  The output goes to a separate (P, n) buffer; the caller
// copies it into V[:P].
#include "common.cuh"

namespace {

constexpr int kTile = 64;      // columns per tile
constexpr int kThreads = 128;
constexpr int kRows = 4;       // output rows per thread

template <typename T>
__global__ void __launch_bounds__(kThreads)
rotate_kernel(const T* __restrict__ Q, int K, int P, const T* __restrict__ V,
              int64_t ldv, T* __restrict__ out, int64_t ldo, int64_t n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // K*P
  T* Vs = Qs + K * P;                      // K*kTile
  for (int idx = threadIdx.x; idx < K * P; idx += blockDim.x) Qs[idx] = Q[idx];
  const int groups = (P + kRows - 1) / kRows;

  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTile; i0 < n;
       i0 += static_cast<int64_t>(gridDim.x) * kTile) {
    __syncthreads();  // Qs loaded / previous tile consumed
    for (int idx = threadIdx.x; idx < K * kTile; idx += blockDim.x) {
      const int k = idx / kTile;
      const int64_t i = i0 + (idx % kTile);
      Vs[idx] = i < n ? V[k * ldv + i] : T(0);
    }
    __syncthreads();
    for (int w = threadIdx.x; w < groups * kTile; w += blockDim.x) {
      const int p0 = (w / kTile) * kRows;
      const int t = w % kTile;
      T acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = T(0);
      for (int k = 0; k < K; ++k) {
        const T v = Vs[k * kTile + t];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (p0 + r < P) acc[r] += Qs[k * P + p0 + r] * v;
      }
      const int64_t i = i0 + t;
      if (i < n) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (p0 + r < P) out[(p0 + r) * ldo + i] = acc[r];
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* Q, int K, int P, const void* V, int64_t ldv,
                   void* out, int64_t ldo, int64_t n, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(K) * P + static_cast<size_t>(K) * kTile) * sizeof(T);
  cudaError_t err = slepc::allow_smem(rotate_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  int64_t blocks = (n + kTile - 1) / kTile;
  if (blocks > 2048) blocks = 2048;
  rotate_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(Q), K, P, static_cast<const T*>(V), ldv,
      static_cast<T*>(out), ldo, n);
  return cudaGetLastError();
}

}  // namespace

// Q (K, P) contiguous on the device; V rows of stride ldv; out rows of
// stride ldo.
extern "C" int slepc_rotate(int dtype, const void* Q, int K, int P,
                            const void* V, int64_t ldv, void* out, int64_t ldo,
                            int64_t n, void* stream) {
  if (K < 1 || P < 1 || n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == slepc::kF32) return launch<float>(Q, K, P, V, ldv, out, ldo, n, s);
  if (dtype == slepc::kF64) return launch<double>(Q, K, P, V, ldv, out, ldo, n, s);
  return cudaErrorInvalidValue;
}
