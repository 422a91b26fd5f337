// K3: the CGS2 panel sweeps on a row-major basis V (K, n) and panel W (b, n):
//   dots          D[k, m] = sum_i conj(V[k, i]) W[m, i]
//   update        Wout[m, i] = W[m, i] - sum_k C[k, m] V[k, i]
//   update_dots   both: Wout as above, D = dots of V with Wout, V read once
//
// Replaces the Pallas kernels of slepc_tpu/ops/bv_pallas.py: panel_dots /
// _dots_kernel, panel_update / _update_kernel and panel_update_dots /
// _update_dots_kernel (f32 only on the TPU; templated here over float and
// double, so the f64 flagship's orthogonalization runs through it too).
//
// Bound: bytes.  Each sweep streams the basis once: dots reads (K + b) * n
// elements, update reads (K + b) * n and writes b * n, update_dots the same
// as update.  At the flagship (K = 49, b = 1, n = 10.35M, f64) that is
// 4.1 GB per dots call and 4.2 GB per update / update_dots call, so a CGS2
// column costs three basis reads instead of four.  The arithmetic is 2 to 4
// operations per element read and never the limit, so the design is about
// keeping loads in flight and nothing else between them.
//
// Design: the basis goes from device memory straight into registers and is
// never parked in shared memory.  A block is G row groups of CT column
// threads (a group is cw warps; 32 * cw = CT).  Thread (c, g) owns the
// kRows basis rows g * kRows ... of its VW columns (one 16-byte load per
// row: 2 doubles or 4 floats; VW = 1 for rows that are not 16-byte aligned),
// so a tile is kRows independent vector loads per thread.  The block walks
// column tiles grid-stride.
//   dots:    every thread multiplies its rows with the panel values of its
//            columns into kRows * b running sums that stay in registers over
//            the whole walk: no shuffle, no barrier and no shared memory
//            inside the walk.
//   update:  the coefficients C of a thread's rows sit in registers for the
//            whole kernel (in shared memory from panel width 4 up, where
//            the next tile's values are also fetched before this tile's
//            exchange).  Each group forms its part of sum_k C[k, m] v_k,
//            the G parts meet in shared memory (b * G * tile values, one
//            barrier, double-buffered), and the sums over the groups, taken
//            in group order, are shared out over the threads, which hold W
//            and store Wout = W - sum: the projection is summed first and
//            subtracted once, as a matrix product does.  (Subtracting each
//            product from W in turn rounds at W's size after every step:
//            in f32 that held the blocked cycle's error estimates 4-10x
//            above the ones a matrix product gives.)
//   update_dots: the summed panel values go back through shared memory (a
//            second barrier) to every group, which multiplies them with the
//            basis values it still holds.
// At the end of the walk one block reduction (shuffles, then shared memory)
// writes per-block partial sums, and a second kernel adds them per output in
// a fixed order: no atomics, so a run gives the same bits every time.
// The panel width is a template parameter (1, 2, 4, 8; a width between two
// of them runs the next one with its spare rows masked; update_dots is not
// compiled at 8, where it spills: the wrapper runs two sweeps), and kRows is
// chosen per element type and width so that the running sums, the
// coefficients and the held values fit the registers.  Shared memory does not grow with K beyond the G parts,
// and G <= kMaxGroups: a taller basis is swept in row chunks by the wrapper.
//
// K3c: the same kernels for complex64 / complex128 (slepc::Complex): the
// dots conjugate the basis (D = V^H W, the inner product <v_k, w_m>), the
// update does not (Wout = W - C^T V, C the coefficients the dots gave), and
// the update still sums the projection and subtracts it once.  A 16-byte
// load holds two c64 or one c128 values.  Bound: bytes, as above with 8 or
// 16 bytes an element: the same bytes per basis row as the real form of a
// complex operator, which has twice the rows of half the width.  The
// arithmetic (8 flops per c128 element of V) stays under the FP64 ridge.
// Registers set kRows per element type: a thread's basis values are kRows
// 16-byte packs whatever the type, but a running sum (and a coefficient) is
// one register for f32, two for f64 and c64, four for c128, and the kernel
// has 128 registers a thread (512-thread blocks).  c128 holds 7, 4, 4, 1
// rows at widths 1, 2, 4, 8 (7 at width 1: the cycle's 49 basis rows fill
// 7 row groups with no idle row, and the dots hold three blocks an SM where
// 8 rows held two; the dots and the update then measured ahead of the
// library's one call, with 8 rows behind it) and its update+dots keeps the
// coefficients in shared memory at every width (the real plan, 8, 8, 4, 4
// rows with coefficients in registers below width 4, spilled its
// update+dots at widths 1, 2 and 4).  Its update+dots is not compiled from width 4 up (64
// running sums of four registers): the wrapper runs the two sweeps there.
// Two rows a thread at width 4 would fit it, but then K = 49 takes two row
// chunks, each rereading and rewriting the panel.  c64 takes the real plan
// but 2 rows at width 8, where its update spilled.
#include "common.cuh"

namespace {

constexpr int kMaxGroups = 16;  // row groups (warps down the rows) per block
constexpr int kMaxThreads = 512;
constexpr int kReduceThreads = 256;

// The dtype code of an element type.
template <typename T> constexpr int kCode = slepc::kF32;
template <> constexpr int kCode<double> = slepc::kF64;
template <> constexpr int kCode<slepc::c64> = slepc::kC64;
template <> constexpr int kCode<slepc::c128> = slepc::kC128;

// Basis rows a thread holds, per dtype code and compiled panel width.
__host__ __device__ constexpr int rows_for(int dtype, int B) {
  return dtype == slepc::kC128 ? (B == 1 ? 7 : B <= 4 ? 4 : 1)
         : dtype == slepc::kC64 && B == 8 ? 2
         : B <= 2 ? 8 : 4;
}

template <typename T, int VW>
struct alignas(sizeof(T) * VW) Pack {
  T v[VW];
};

template <typename T, int VW>
__device__ __forceinline__ Pack<T, VW> zero_pack() {
  Pack<T, VW> p;
#pragma unroll
  for (int e = 0; e < VW; ++e) p.v[e] = T(0);
  return p;
}

template <typename T, int VW>
__device__ __forceinline__ Pack<T, VW> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, VW>*>(p);
}

template <typename T, int VW>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, VW>& x) {
  *reinterpret_cast<Pack<T, VW>*>(p) = x;
}

// Panel widths from 4 up keep the coefficients in shared memory (they would
// take kRows * B more registers) and fetch the next tile's values before
// this tile's exchange: at 4 rows a thread the block is many warps, one or
// two blocks fit an SM, and without the early fetch no load would be in
// flight while the block sits in its barriers.
__host__ __device__ constexpr bool wide(int B) { return B >= 4; }
// The update's coefficients in shared memory: the wide panels, and c128's
// update+dots.
__host__ __device__ constexpr bool coef_shared(int dtype, int B, bool dots) {
  return wide(B) || (dtype == slepc::kC128 && dots);
}
// Whether the fused update + dots is compiled at width B.
__host__ __device__ constexpr bool fused(int dtype, int B) {
  return B < (dtype == slepc::kC128 ? 4 : 8);
}

// Elements of shared memory a block of G groups and CT column threads needs.
__host__ __device__ inline size_t smem_elems(int dtype, bool update, bool dots,
                                             int B, int G, int cw, int VW) {
  const int R = rows_for(dtype, B);
  const size_t tc = static_cast<size_t>(32) * cw * VW;
  size_t need = 0;
  if (update) need = 2 * static_cast<size_t>(G) * B * tc;   // the G parts
  if (update && dots) need += 2 * static_cast<size_t>(B) * tc;  // summed panel
  if (update && coef_shared(dtype, B, dots))
    need += static_cast<size_t>(G) * R * B;
  const size_t red = dots ? static_cast<size_t>(G) * cw * R * B : 0;
  return need > red ? need : red;
}

template <typename T, int B, int VW, bool kUpdate, bool kDots>
__global__ void __launch_bounds__(kMaxThreads)
panel_kernel(const T* V, int64_t ldv, int K, const T* W, int64_t ldw, int b,
             const T* __restrict__ C, T* Wout, int64_t ldo,
             T* __restrict__ partial, int64_t n, int cw) {
  constexpr int R = rows_for(kCode<T>, B);
  constexpr bool kCoefShared = kUpdate && coef_shared(kCode<T>, B, kDots);
  constexpr bool kFetchAhead = kUpdate && wide(B);
  using P = Pack<T, VW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = (blockDim.x >> 5) / cw;
  const int g = warp / cw;
  const int CT = 32 * cw;
  const int c = (warp % cw) * 32 + lane;
  const int TC = CT * VW;
  const int k0 = g * R;
  const size_t ex_size = static_cast<size_t>(G) * B * TC;
  // shared memory: [2][G][B][CT] parts, then (update + dots) [2][B][CT]
  // summed panel, then (wide) [G * R][B] coefficients
  T* cs = smem + 2 * ex_size + (kDots ? 2 * static_cast<size_t>(B) * TC : 0);

  T coef[R][B];  // unused (and dropped by the compiler) when kCoefShared
  T sum[R][B];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int m = 0; m < B; ++m) {
      coef[r][m] = (kUpdate && !kCoefShared && k0 + r < K && m < b)
                       ? C[static_cast<int64_t>(k0 + r) * b + m] : T(0);
      sum[r][m] = T(0);
    }
  }
  if (kCoefShared) {
    for (int p = tid; p < G * R * B; p += blockDim.x) {
      const int k = p / B;
      const int m = p % B;
      cs[p] = (k < K && m < b) ? C[static_cast<int64_t>(k) * b + m] : T(0);
    }
    __syncthreads();
  }

  const int64_t ntiles = (n + TC - 1) / TC;
  // the basis values of this thread's rows and (update: group 0 only) the
  // panel values of its columns, for one tile
  auto fetch = [&](int64_t tile, P (&vv)[R], P (&ww)[B]) {
    const int64_t col = tile * TC + static_cast<int64_t>(c) * VW;
    const bool in = tile < ntiles && col < n;  // n is a multiple of VW
#pragma unroll
    for (int r = 0; r < R; ++r)
      vv[r] = (in && k0 + r < K)
                  ? load_pack<T, VW>(V + static_cast<int64_t>(k0 + r) * ldv + col)
                  : zero_pack<T, VW>();
    // update: a thread holds the panel rows it combines (m = g, g + G, ...)
#pragma unroll
    for (int m = 0; m < B; ++m)
      ww[m] = (in && m < b && (!kUpdate || m % G == g))
                  ? load_pack<T, VW>(W + m * ldw + col) : zero_pack<T, VW>();
  };

  P v[R], w[B];
  if (kFetchAhead) fetch(blockIdx.x, v, w);
  int buf = 0;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t col = tile * TC + static_cast<int64_t>(c) * VW;
    const bool in = col < n;
    P vn[R], wn[B];  // the next tile's values, when fetched ahead
    if (kFetchAhead) {
      fetch(tile + gridDim.x, vn, wn);
    } else {
      fetch(tile, v, w);
    }
    if (kUpdate) {
      T* ex = smem + buf * ex_size;  // [G][B][CT] packs
#pragma unroll
      for (int m = 0; m < B; ++m) {
        if (m < b) {
          P part = zero_pack<T, VW>();
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const T cf = kCoefShared ? cs[(k0 + r) * B + m] : coef[r][m];
#pragma unroll
            for (int e = 0; e < VW; ++e) part.v[e] += cf * v[r].v[e];
          }
          store_pack<T, VW>(ex + (static_cast<size_t>(g * B + m) * CT + c) * VW,
                            part);
        }
      }
      __syncthreads();
      T* wf = smem + 2 * ex_size + static_cast<size_t>(buf) * B * TC;
      // rows m = g, g + G, ... (unrolled over B: w stays in registers)
#pragma unroll
      for (int m = 0; m < B; ++m) {
        if (m >= b || m % G != g) continue;
        P s = load_pack<T, VW>(ex + (static_cast<size_t>(m) * CT + c) * VW);
        for (int gg = 1; gg < G; ++gg) {
          const P a = load_pack<T, VW>(
              ex + (static_cast<size_t>(gg * B + m) * CT + c) * VW);
#pragma unroll
          for (int e = 0; e < VW; ++e) s.v[e] += a.v[e];
        }
#pragma unroll
        for (int e = 0; e < VW; ++e) s.v[e] = w[m].v[e] - s.v[e];
        if (in) store_pack<T, VW>(Wout + m * ldo + col, s);
        if (kDots) store_pack<T, VW>(wf + (static_cast<size_t>(m) * CT + c) * VW, s);
      }
      if (kDots) {
        __syncthreads();
#pragma unroll
        for (int m = 0; m < B; ++m)
          w[m] = m < b ? load_pack<T, VW>(wf + (static_cast<size_t>(m) * CT + c) * VW)
                       : zero_pack<T, VW>();
      }
      buf ^= 1;
    }
    if (kDots) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int m = 0; m < B; ++m) {
#pragma unroll
          for (int e = 0; e < VW; ++e)
            sum[r][m] += slepc::conj_mul(v[r].v[e], w[m].v[e]);
        }
      }
    }
    if (kFetchAhead) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = vn[r];
#pragma unroll
      for (int m = 0; m < B; ++m) w[m] = wn[m];
    }
  }

  if (kDots) {
    // one block reduction: the 32 lanes of a warp by shuffles, then the cw
    // warps of a group in warp order
    __syncthreads();
    T* red = smem;  // [warps][R * B]
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int m = 0; m < B; ++m) {
        const T s = slepc::warp_sum(sum[r][m]);
        if (lane == 0) red[warp * (R * B) + r * B + m] = s;
      }
    }
    __syncthreads();
    for (int p = tid; p < G * R * B; p += blockDim.x) {
      const int gg = p / (R * B);
      const int rm = p % (R * B);
      const int k = gg * R + rm / B;
      const int m = rm % B;
      if (k < K && m < b) {
        T s = T(0);
        for (int wc = 0; wc < cw; ++wc) s += red[(gg * cw + wc) * (R * B) + rm];
        partial[(static_cast<int64_t>(k) * b + m) * gridDim.x + blockIdx.x] = s;
      }
    }
  }
}

// out[p] = sum_g partial[p, g], one block per output, fixed summation order.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const T* __restrict__ partial, int G, T* __restrict__ out) {
  __shared__ T s[kReduceThreads];
  const int p = blockIdx.x;
  T a = T(0);
  for (int g = threadIdx.x; g < G; g += blockDim.x)
    a += partial[static_cast<int64_t>(p) * G + g];
  s[threadIdx.x] = a;
  __syncthreads();
  for (int st = blockDim.x / 2; st > 0; st >>= 1) {
    if (threadIdx.x < st) s[threadIdx.x] += s[threadIdx.x + st];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[p] = s[0];
}

struct Args {
  const void* V; int64_t ldv; int K;
  const void* W; int64_t ldw; int b;
  const void* C; void* Wout; int64_t ldo;
  void* partial; int grid; int groups; int cw; void* D; int64_t n;
  cudaStream_t stream;
  int* blocks_per_sm;  // when set: report the occupancy and launch nothing
};

template <typename T, int B, int VW, bool kUpdate, bool kDots>
cudaError_t run(const Args& a) {
  auto kernel = panel_kernel<T, B, VW, kUpdate, kDots>;
  const int threads = 32 * a.groups * a.cw;
  const size_t smem =
      smem_elems(kCode<T>, kUpdate, kDots, B, a.groups, a.cw, VW) * sizeof(T);
  cudaError_t err = slepc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (a.blocks_per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.blocks_per_sm, kernel,
                                                         threads, smem);
  kernel<<<a.grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.V), a.ldv, a.K, static_cast<const T*>(a.W), a.ldw,
      a.b, static_cast<const T*>(a.C), static_cast<T*>(a.Wout), a.ldo,
      static_cast<T*>(a.partial), a.n, a.cw);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kDots) return err;
  reduce_partials<T><<<a.K * a.b, kReduceThreads, 0, a.stream>>>(
      static_cast<const T*>(a.partial), a.grid, static_cast<T*>(a.D));
  return cudaGetLastError();
}

// The fused update + dots is not compiled at width 8 (c128: from 4 up): its
// running sums beside the held values spill, and an update sweep followed
// by a dots sweep is the faster there (the wrapper runs those).
template <typename T, int B, int VW>
cudaError_t by_mode(int mode, const Args& a) {
  if (mode == 0) return run<T, B, VW, false, true>(a);
  if (mode == 1) return run<T, B, VW, true, false>(a);
  if constexpr (fused(kCode<T>, B)) {
    if (mode == 2) return run<T, B, VW, true, true>(a);
  }
  return cudaErrorInvalidValue;
}

// The compiled width that runs a panel of b rows.
int width_of(int b) { return b == 1 ? 1 : b == 2 ? 2 : b <= 4 ? 4 : 8; }

template <typename T, int VW>
cudaError_t by_width(int mode, const Args& a) {
  if (a.b == 1) return by_mode<T, 1, VW>(mode, a);
  if (a.b == 2) return by_mode<T, 2, VW>(mode, a);
  if (a.b <= 4) return by_mode<T, 4, VW>(mode, a);
  return by_mode<T, 8, VW>(mode, a);
}

cudaError_t dispatch(int dtype, int mode, int vec, const Args& a) {
  if (a.K < 1 || a.b < 1 || a.b > 8 || a.n < 1 || a.groups < 1 ||
      a.groups > kMaxGroups || a.cw < 1 ||
      32 * a.groups * a.cw > kMaxThreads)
    return cudaErrorInvalidValue;
  const int B = width_of(a.b);
  if (a.K > a.groups * rows_for(dtype, B))
    return cudaErrorInvalidValue;
  if (dtype == slepc::kF32)
    return vec ? by_width<float, 4>(mode, a) : by_width<float, 1>(mode, a);
  if (dtype == slepc::kF64)
    return vec ? by_width<double, 2>(mode, a) : by_width<double, 1>(mode, a);
  if (dtype == slepc::kC64)
    return vec ? by_width<slepc::c64, 2>(mode, a)
               : by_width<slepc::c64, 1>(mode, a);
  if (dtype == slepc::kC128)  // one c128 is a 16-byte load either way
    return by_width<slepc::c128, 1>(mode, a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int slepc_panel_max_b() { return 8; }
extern "C" int slepc_panel_max_groups() { return kMaxGroups; }
// Basis rows a thread holds at panel width b for a dtype code (0 for an
// unknown code).
extern "C" int slepc_panel_rows(int dtype, int b) {
  return slepc::elem_bytes(dtype) == 0 ? 0 : rows_for(dtype, width_of(b));
}
// Dynamic shared memory, in bytes, of one block of the sweep kernel.
extern "C" int64_t slepc_panel_smem(int dtype, int mode, int b, int groups,
                                    int cw, int vec) {
  const int B = width_of(b);
  const int elt = slepc::elem_bytes(dtype);
  if (elt == 0) return -1;
  const int VW = vec ? 16 / elt : 1;
  return static_cast<int64_t>(
             smem_elems(dtype, mode != 0, mode != 1, B, groups, cw, VW)) * elt;
}

// Blocks of the sweep kernel one SM holds at this launch shape (registers,
// threads and shared memory of the compiled kernel); launches nothing.
extern "C" int slepc_panel_occupancy(int dtype, int mode, int b, int groups,
                                     int cw, int vec, int* blocks_per_sm) {
  Args a{};
  a.K = 1; a.b = b; a.n = 1; a.groups = groups; a.cw = cw;
  a.blocks_per_sm = blocks_per_sm;
  return dispatch(dtype, mode, vec, a);
}

// mode 0 = dots, 1 = update, 2 = update + dots.  V (K, ldv), W (b, ldw),
// C (K, b) contiguous on the device, Wout (b, ldo), partial (K*b, grid)
// scratch, D (K, b) output.  A block is groups * cw warps (K <= groups *
// slepc_panel_rows(b)); vec = 1 takes 16-byte loads and needs every row
// base and row stride 16-byte aligned and n a multiple of the vector width.
extern "C" int slepc_panel(int dtype, int mode, int vec, const void* V,
                           int64_t ldv, int K, const void* W, int64_t ldw,
                           int b, const void* C, void* Wout, int64_t ldo,
                           void* partial, int grid, int groups, int cw,
                           void* D, int64_t n, void* stream) {
  if (grid < 1) return cudaErrorInvalidValue;
  Args a{V, ldv, K, W, ldw, b, C, Wout, ldo, partial, grid, groups, cw, D, n,
         static_cast<cudaStream_t>(stream), nullptr};
  return dispatch(dtype, mode, vec, a);
}
