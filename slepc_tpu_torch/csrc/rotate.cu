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
// flagship restart (2.2 ms at 3.35 TB/s).  The K * P * n multiply-adds (20 G
// at the flagship) would take 1.3 ms (f64) on the FP64 pipe at its peak and
// cannot be fed from shared memory at one load per multiply-add, so the
// design must (a) keep the arithmetic off the critical path and (b) keep
// loads in flight while it runs.
//
// Design, both types: a persistent block per slot of the card walks column
// tiles grid-stride.  The V tile arrives through a ring of shared-memory
// stages, kChunk basis rows by one tile of columns each, filled with
// cp.async (16 bytes a copy; 8 or 4 bytes a copy for rows whose base or
// stride is not 16-byte aligned), so the copies of the next stages run
// under this stage's products and shared memory does not grow with K.
// Q^T (zero-padded to the compute tile) sits in shared memory for the whole
// kernel; accumulators are registers.  A block has read all K rows of a
// column tile before it stores any output row of those columns and no other
// block touches them, so `out` may be rows of V itself (the restart writes
// V[:P] in place and no copy-back follows).  The k-sum has a fixed order:
// the same bits on every call.
//   f64: the products run on the tensor cores, mma.sync m8n8k4 (f64 has no
//        wgmma): A = Q^T in 8-row tiles (MT of them, a template parameter),
//        B = the V chunk, 4 warps of 16 columns each.  The shared-memory
//        row strides are = 4 mod 16 doubles so both fragment loads are free
//        of bank conflicts.  One shared load feeds 2 (A) or MT (B) mma.
//   f32: exact f32 on the FP32 pipe, register-tiled: a warp owns 8 output
//        rows, a lane 4 columns (32 multiply-adds for three 16-byte shared
//        loads: one of V, two broadcast loads of Q).  Single-pass TF32 drops
//        13 mantissa bits and fails the 1e-5 gate; a split big+small TF32
//        product needs three mma for one and two extra roundings per
//        operand, for arithmetic that already hides under the loads here.
// At most 64 output rows a launch (8 row tiles); the wrapper splits a wider
// Q into launches.
#include "common.cuh"

namespace {

constexpr int kChunk = 16;         // basis rows per ring stage
constexpr int kTile64 = 64;        // f64: columns per tile
constexpr int kStride64 = 68;      // f64: shared row stride (= 4 mod 16)
constexpr int kThreads64 = 128;    // f64: 4 warps x 16 columns
constexpr int kTile32 = 128;       // f32: columns per tile (32 lanes x 4)
constexpr int kMaxRowTiles = 8;    // 8-row tiles of output per launch

using slepc::cp_async;
using slepc::cp_async_commit;

// Wait until the oldest of `stages - 1` groups in flight has landed.
__device__ __forceinline__ void cp_async_wait_for(int stages) {
  if (stages >= 4)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (stages == 3)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma_f64(double& c0, double& c1, double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%0, %1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

// Shared row stride of Q^T in the f64 kernel: >= Kpad and = 4 mod 16.
__host__ __device__ inline int q_stride64(int kpad) {
  return kpad + ((4 - kpad % 16) + 16) % 16;
}

// The ring's bookkeeping, common to both kernels: which (tile, row chunk)
// the next copy is for.
struct Cursor {
  int64_t tile;  // column tile of the next item
  int chunk;     // row chunk of the next item
  int slot;      // ring slot of the next item
  __device__ void advance(int nchunks, int stages, int64_t tile_step) {
    if (++chunk == nchunks) { chunk = 0; tile += tile_step; }
    if (++slot == stages) slot = 0;
  }
};

// Copy rows [chunk * kChunk, ...) of column tile `tile` into a ring slot;
// rows at or past K (the zero padding of the k-sum) and columns at or past n
// are zero-filled (a copy of 0 source bytes).
template <typename T, int TILE, int STRIDE, bool VEC>
__device__ __forceinline__ void copy_chunk(T* dst, const T* V, int64_t ldv,
                                            int K, int rows, int chunk,
                                            int64_t i0, int64_t n) {
  constexpr int W = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int CH = TILE / W;
  for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
    const int r = idx / CH;
    const int ch = idx % CH;
    const int k = chunk * kChunk + r;
    const int64_t i = i0 + ch * W;
    const bool ok = k < K && i < n;  // VEC: n is a multiple of W
    const T* src = ok ? V + static_cast<int64_t>(k) * ldv + i : V;
    cp_async<W * sizeof(T)>(dst + r * STRIDE + ch * W, src,
                            ok ? W * static_cast<int>(sizeof(T)) : 0);
  }
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(kThreads64)
rotate_f64_kernel(const double* __restrict__ Q, int K, int P, const double* V,
                  int64_t ldv, double* out, int64_t ldo, int64_t n, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* Qs = reinterpret_cast<double*>(smem_raw);  // [8 * MT][SQ]: Q^T
  const int kpad = (K + 3) & ~3;
  const int SQ = q_stride64(kpad);
  double* ring = Qs + 8 * MT * SQ;  // [stages][kChunk][kStride64]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row (A, C) / column (B)
  const int t = lane & 3;   // fragment k index (A, B) / column pair (C)

  for (int idx = tid; idx < 8 * MT * SQ; idx += kThreads64) {
    const int p = idx / SQ;
    const int k = idx % SQ;
    Qs[idx] = (p < P && k < K) ? Q[static_cast<int64_t>(k) * P + p] : 0.0;
  }

  const int nchunks = (kpad + kChunk - 1) / kChunk;
  const int64_t ntiles = (n + kTile64 - 1) / kTile64;
  const int64_t step = gridDim.x;
  Cursor load{static_cast<int64_t>(blockIdx.x), 0, 0};
  auto fill = [&]() {
    if (load.tile < ntiles) {
      const int rows = min(kChunk, kpad - load.chunk * kChunk);
      copy_chunk<double, kTile64, kStride64, VEC>(
          ring + load.slot * (kChunk * kStride64), V, ldv, K, rows, load.chunk,
          load.tile * kTile64, n);
    }
    cp_async_commit();
    load.advance(nchunks, stages, step);
  };
  for (int s = 0; s < stages - 1; ++s) fill();

  double acc[MT][2][2];
  int slot = 0;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += step) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      acc[mt][0][0] = acc[mt][0][1] = acc[mt][1][0] = acc[mt][1][1] = 0.0;
    for (int chunk = 0; chunk < nchunks; ++chunk) {
      cp_async_wait_for(stages);
      __syncthreads();  // this item has landed; the slot refilled next is free
      fill();
      const double* vs = ring + slot * (kChunk * kStride64) + warp * 16 + g;
      const double* qs = Qs + g * SQ + chunk * kChunk + t;
      const int ksteps = min(kChunk, kpad - chunk * kChunk) / 4;
      for (int ks = 0; ks < ksteps; ++ks) {
        const double b0 = vs[(ks * 4 + t) * kStride64];
        const double b1 = vs[(ks * 4 + t) * kStride64 + 8];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const double a = qs[mt * 8 * SQ + ks * 4];
          mma_f64(acc[mt][0][0], acc[mt][0][1], a, b0);
          mma_f64(acc[mt][1][0], acc[mt][1][1], a, b1);
        }
      }
      if (++slot == stages) slot = 0;
    }
    // every row of this tile has been read: store (out may be rows of V)
    const int64_t i0 = tile * kTile64 + warp * 16 + 2 * t;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int p = mt * 8 + g;
      if (p < P) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int64_t i = i0 + 8 * j;
          double* dst = out + static_cast<int64_t>(p) * ldo + i;
          if (VEC) {
            if (i < n) *reinterpret_cast<double2*>(dst) =
                make_double2(acc[mt][j][0], acc[mt][j][1]);
          } else {
            if (i < n) dst[0] = acc[mt][j][0];
            if (i + 1 < n) dst[1] = acc[mt][j][1];
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// blockDim.x = 32 * (row tiles of 8): warp w owns output rows 8w ... 8w + 7.
template <bool VEC>
__global__ void __launch_bounds__(32 * kMaxRowTiles)
rotate_f32_kernel(const float* __restrict__ Q, int K, int P, const float* V,
                  int64_t ldv, float* out, int64_t ldo, int64_t n, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [K][PQ]
  const int PQ = blockDim.x >> 2;                  // 8 * warps
  float* ring = Qs + K * PQ;                       // [stages][kChunk][kTile32]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int idx = tid; idx < K * PQ; idx += blockDim.x) {
    const int k = idx / PQ;
    const int p = idx % PQ;
    Qs[idx] = p < P ? Q[static_cast<int64_t>(k) * P + p] : 0.0f;
  }

  const int nchunks = (K + kChunk - 1) / kChunk;
  const int64_t ntiles = (n + kTile32 - 1) / kTile32;
  const int64_t step = gridDim.x;
  Cursor load{static_cast<int64_t>(blockIdx.x), 0, 0};
  auto fill = [&]() {
    if (load.tile < ntiles) {
      const int rows = min(kChunk, K - load.chunk * kChunk);
      copy_chunk<float, kTile32, kTile32, VEC>(
          ring + load.slot * (kChunk * kTile32), V, ldv, K, rows, load.chunk,
          load.tile * kTile32, n);
    }
    cp_async_commit();
    load.advance(nchunks, stages, step);
  };
  for (int s = 0; s < stages - 1; ++s) fill();

  float acc[8][4];
  int slot = 0;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += step) {
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
    for (int chunk = 0; chunk < nchunks; ++chunk) {
      cp_async_wait_for(stages);
      __syncthreads();  // this item has landed; the slot refilled next is free
      fill();
      const float* vs = ring + slot * (kChunk * kTile32) + 4 * lane;
      const float* qs = Qs + chunk * kChunk * PQ + 8 * warp;
      const int rows = min(kChunk, K - chunk * kChunk);
#pragma unroll 4
      for (int kr = 0; kr < rows; ++kr) {
        const float4 v = *reinterpret_cast<const float4*>(vs + kr * kTile32);
        const float4 qa = *reinterpret_cast<const float4*>(qs + kr * PQ);
        const float4 qb = *reinterpret_cast<const float4*>(qs + kr * PQ + 4);
        const float q[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          acc[r][0] += q[r] * v.x;
          acc[r][1] += q[r] * v.y;
          acc[r][2] += q[r] * v.z;
          acc[r][3] += q[r] * v.w;
        }
      }
      if (++slot == stages) slot = 0;
    }
    // every row of this tile has been read: store (out may be rows of V)
    const int64_t i = tile * kTile32 + 4 * lane;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int p = warp * 8 + r;
      if (p < P) {
        float* dst = out + static_cast<int64_t>(p) * ldo + i;
        if (VEC) {
          if (i < n) *reinterpret_cast<float4*>(dst) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (i + e < n) dst[e] = acc[r][e];
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Args {
  const void* Q; int K; int P;
  const void* V; int64_t ldv; void* out; int64_t ldo; int64_t n;
  int stages; int grid; cudaStream_t stream;
  int* blocks_per_sm;  // when set: report the occupancy and launch nothing
};

int row_tiles(int P) { return (P + 7) / 8; }
// Row tiles the f64 kernel is compiled for: the least of 1, 2, 4, 5, 6, 8
// that holds P.
int row_tiles64(int P) {
  const int mt = row_tiles(P);
  return mt == 3 ? 4 : mt == 7 ? 8 : mt;
}

size_t smem_bytes(int dtype, int K, int P, int stages) {
  if (dtype == slepc::kF64) {
    const int kpad = (K + 3) & ~3;
    return (static_cast<size_t>(8) * row_tiles64(P) * q_stride64(kpad) +
            static_cast<size_t>(stages) * kChunk * kStride64) * sizeof(double);
  }
  return (static_cast<size_t>(K) * 8 * row_tiles(P) +
          static_cast<size_t>(stages) * kChunk * kTile32) * sizeof(float);
}

template <typename T, typename Kernel>
cudaError_t run(Kernel kernel, int threads, int dtype, const Args& a) {
  const size_t smem = smem_bytes(dtype, a.K, a.P, a.stages);
  cudaError_t err = slepc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (a.blocks_per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.blocks_per_sm, kernel,
                                                         threads, smem);
  kernel<<<a.grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.Q), a.K, a.P, static_cast<const T*>(a.V), a.ldv,
      static_cast<T*>(a.out), a.ldo, a.n, a.stages);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t run64(const Args& a) {
  switch (row_tiles64(a.P)) {
    case 1: return run<double>(rotate_f64_kernel<1, VEC>, kThreads64, slepc::kF64, a);
    case 2: return run<double>(rotate_f64_kernel<2, VEC>, kThreads64, slepc::kF64, a);
    case 4: return run<double>(rotate_f64_kernel<4, VEC>, kThreads64, slepc::kF64, a);
    case 5: return run<double>(rotate_f64_kernel<5, VEC>, kThreads64, slepc::kF64, a);
    case 6: return run<double>(rotate_f64_kernel<6, VEC>, kThreads64, slepc::kF64, a);
    default: return run<double>(rotate_f64_kernel<8, VEC>, kThreads64, slepc::kF64, a);
  }
}

cudaError_t dispatch(int dtype, int vec, const Args& a) {
  if (a.K < 1 || a.P < 1 || a.P > 8 * kMaxRowTiles || a.n < 1 || a.stages < 2 ||
      a.stages > 4)
    return cudaErrorInvalidValue;
  if (dtype == slepc::kF64) return vec ? run64<true>(a) : run64<false>(a);
  if (dtype == slepc::kF32) {
    const int threads = 32 * row_tiles(a.P);
    return vec ? run<float>(rotate_f32_kernel<true>, threads, dtype, a)
               : run<float>(rotate_f32_kernel<false>, threads, dtype, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int slepc_rotate_max_p() { return 8 * kMaxRowTiles; }

// Dynamic shared memory, in bytes, of one block.
extern "C" int64_t slepc_rotate_smem(int dtype, int K, int P, int stages) {
  return static_cast<int64_t>(smem_bytes(dtype, K, P, stages));
}

// Blocks one SM holds at this shape (registers, threads and shared memory
// of the compiled kernel); launches nothing.
extern "C" int slepc_rotate_occupancy(int dtype, int vec, int K, int P,
                                      int stages, int* blocks_per_sm) {
  Args a{};
  a.K = K; a.P = P; a.n = 1; a.stages = stages; a.blocks_per_sm = blocks_per_sm;
  return dispatch(dtype, vec, a);
}

// Q (K, P) contiguous on the device, P <= slepc_rotate_max_p(); V rows of
// stride ldv; out rows of stride ldo (out may be rows of V with the same
// stride and column offset).  vec = 1 takes 16-byte copies and stores and
// needs the bases and strides of V and out 16-byte aligned and n a multiple
// of the vector width.  stages (2..4) is the depth of the shared-memory ring.
extern "C" int slepc_rotate(int dtype, int vec, const void* Q, int K, int P,
                            const void* V, int64_t ldv, void* out, int64_t ldo,
                            int64_t n, int stages, int grid, void* stream) {
  if (grid < 1) return cudaErrorInvalidValue;
  Args a{Q, K, P, V, ldv, out, ldo, n, stages, grid,
         static_cast<cudaStream_t>(stream), nullptr};
  return dispatch(dtype, vec, a);
}
