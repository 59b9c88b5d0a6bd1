// Grouped (ragged) matrix product for Hopper: two kernels.
//
// Replace the TPU kernel of paddle_tpu/ops/pallas/grouped_matmul.py and
// its backward:
//   grouped_matmul_kernel    <- `_kernel` (call in `grouped_matmul_pallas`);
//                               with the weight read transposed it is also
//                               the dx half of `_gmm_bwd`, the vjp of
//                               ragged_dot that XLA computes there
//   grouped_matmul_dw_kernel <- the dw half of that vjp: the port's own
//                               kernel, where the JAX package leaves the
//                               backward to XLA
// The op: the rows of x [m, K] split into g contiguous runs, run i being
// rows [ends[i - 1], ends[i]) with ends = cumsum(group sizes) on the
// device (clamped to [0, m]); run i multiplies its own weight:
//   forward: y[r] = x[r] . w[i]     w [g, K, N], y [m, N]
//   TRANS:   y[r] = x[r] . w[i]^T   w [g, N, K]: dx = gy . w^T reads the
//            forward's [g, k, n] weight by strides, with no copy
//   dw:      dw[i] = x[run i]^T . gy[run i]   dw [g, K, N], 0 where run i
//            is empty (the vjp gives 0 there and the optimizer reads it)
// Rows past ends[g - 1] belong to no run and get 0, as ragged_dot gives.
// Sums are fp32; y is written fp32 or bf16 as the caller asks.
//
// Bound: operations. At the bf16 dropless training step of DeepSeekMoE-16B
// (m = 49152 rows = 8192 tokens x top-6, g = 64 experts) the gate_up
// product does 2 m K N = 567 GFLOP on 1.5 GB: 573 us of tensor-core time
// against 446 us of bytes; dx and dw repeat their forward's arithmetic.
// Design: the TPU kernel packs each run to a block_m-aligned offset in a
// staging copy, because a BlockSpec needs whole static tiles, and picks a
// tile's weight through a scalar-prefetched tile->group table. Here there
// is no copy and no table. The grid is static: ceil(m / BM) + g row tiles
// (enough for every run's tiles and for the tail, since the ceilings of
// g + 1 parts sum to at most the ceiling of their sum plus g) by N / BN
// column tiles. Each block's first warp scans the run lengths 32 runs at a
// time (a warp prefix sum of each run's tile count) to find its run and
// its tile within the run; the tile loop masks rows past the run's end;
// blocks past the last tile exit. No group size reaches the host. The dw
// grid is (g, K / BM, N / BN): each block loops over its run's rows in
// order (a fixed-order sum, no atomics), and an empty run's loop is empty,
// so its block writes zeros. Products: the shared tile loop
// (tile_gemm.cuh), bf16 mma.sync from a cp.async ring, fp32 FMAs for fp32.
// `wgmma`, TMA and a persistent schedule are later work.

#include <stdint.h>

#include "tile_gemm.cuh"

namespace {

using pt::tile::bf;
using pt::tile::GemmOf;
using pt::tile::NT;

__device__ __forceinline__ int clamp_row(int v, int m) {
  return min(max(v, 0), m);
}

// rows [s, e) of run i; run g is the tail [ends[g - 1], m)
__device__ __forceinline__ void run_rows(const int* ends, int i, int g, int m,
                                         int& s, int& e) {
  s = i > 0 ? clamp_row(ends[i - 1], m) : 0;
  e = i < g ? clamp_row(ends[i], m) : m;
  e = max(e, s);
}

// Which run, and which tile of it, row tile t is. info = {run, its first
// row, its rows, the tile's index within the run}, run -1 past the last
// tile. Called by the whole block; warp 0 scans, one run a lane.
template <int BM>
__device__ __forceinline__ void find_tile(const int* ends, int g, int m,
                                          int t, int* info) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int base = 0;  // tiles of the runs before this chunk
    bool found = false;
    for (int c0 = 0; c0 <= g; c0 += 32) {
      const int i = c0 + lane;
      int s = 0, e = 0;
      if (i <= g) run_rows(ends, i, g, m, s, e);
      const int nt = (e - s + BM - 1) / BM;
      int inc = nt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      const int first = base + inc - nt;
      const bool mine = i <= g && t >= first && t < first + nt;
      if (__ballot_sync(0xffffffffu, mine)) {
        if (mine) {
          info[0] = i;
          info[1] = s;
          info[2] = e - s;
          info[3] = t - first;
        }
        found = true;
        break;
      }
      base += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (!found && lane == 0) info[0] = -1;
  }
  __syncthreads();
}

template <typename T, typename OutT, bool TRANS>
__global__ void __launch_bounds__(NT, 1)
    grouped_matmul_kernel(const T* x, const T* w, const int* ends, OutT* y,
                          int m, int K, int N, int g, int vec) {
  using G = typename GemmOf<T, true, !TRANS>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int info[4];
  find_tile<G::BM>(ends, g, m, blockIdx.x, info);
  const int run = info[0];
  if (run < 0) return;
  const int s = info[1], rows = info[2], m0 = info[3] * G::BM;
  const int n0 = blockIdx.y * G::BN;
  const int nr = min(G::BM, rows - m0);
  if (run < g) {
    // B(k, n) = w[run][k, n] (ld N), or w[run][n, k] (column-major, ld K)
    G::run(x + static_cast<long long>(s) * K, K,
           w + static_cast<long long>(run) * K * N, TRANS ? K : N, rows, N,
           K, m0, n0, vec != 0, smem);
  }
  const float* Cs = reinterpret_cast<const float*>(smem);
  for (int i = threadIdx.x; i < G::BM * G::BN; i += NT) {
    const int r = i / G::BN, c = i % G::BN;
    if (r >= nr || n0 + c >= N) continue;
    y[static_cast<long long>(s + m0 + r) * N + n0 + c] =
        pt::from_f<OutT>(run < g ? Cs[r * G::LDC + c] : 0.f);
  }
}

template <typename T, typename OutT>
__global__ void __launch_bounds__(NT, 1)
    grouped_matmul_dw_kernel(const T* x, const T* gy, const int* ends,
                             OutT* dw, int m, int K, int N, int g, int vec) {
  using G = typename GemmOf<T, false, true>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const int run = blockIdx.x;
  int s, e;
  run_rows(ends, run, g, m, s, e);
  const int m0 = blockIdx.y * G::BM, n0 = blockIdx.z * G::BN;
  // A(r, q) = x[s + q][r]: column-major with leading dimension K
  G::run(x + static_cast<long long>(s) * K, K,
         gy + static_cast<long long>(s) * N, N, K, N, e - s, m0, n0,
         vec != 0, smem);
  const float* Cs = reinterpret_cast<const float*>(smem);
  OutT* out = dw + static_cast<long long>(run) * K * N;
  for (int i = threadIdx.x; i < G::BM * G::BN; i += NT) {
    const int r = i / G::BN, c = i % G::BN;
    if (m0 + r >= K || n0 + c >= N) continue;
    out[static_cast<long long>(m0 + r) * N + n0 + c] =
        pt::from_f<OutT>(Cs[r * G::LDC + c]);
  }
}

template <typename Kern, typename... A>
cudaError_t launch(Kern kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   A... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, NT, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, typename OutT, bool TRANS>
cudaError_t forward(const void* x, const void* w, const int* ends, void* y,
                    int m, int K, int N, int g, int vec, cudaStream_t s) {
  using G = typename GemmOf<T, true, !TRANS>::type;
  const dim3 grid((m + G::BM - 1) / G::BM + g, (N + G::BN - 1) / G::BN);
  return launch(grouped_matmul_kernel<T, OutT, TRANS>, grid, G::SMEM, s,
                static_cast<const T*>(x), static_cast<const T*>(w), ends,
                static_cast<OutT*>(y), m, K, N, g, vec);
}

template <typename T, typename OutT>
cudaError_t backward_dw(const void* x, const void* gy, const int* ends,
                        void* dw, int m, int K, int N, int g, int vec,
                        cudaStream_t s) {
  using G = typename GemmOf<T, false, true>::type;
  const dim3 grid(g, (K + G::BM - 1) / G::BM, (N + G::BN - 1) / G::BN);
  return launch(grouped_matmul_dw_kernel<T, OutT>, grid, G::SMEM, s,
                static_cast<const T*>(x), static_cast<const T*>(gy), ends,
                static_cast<OutT*>(dw), m, K, N, g, vec);
}

template <typename T, typename OutT>
cudaError_t forward_any(int trans, const void* x, const void* w,
                        const int* ends, void* y, int m, int K, int N, int g,
                        int vec, cudaStream_t s) {
  return trans ? forward<T, OutT, true>(x, w, ends, y, m, K, N, g, vec, s)
               : forward<T, OutT, false>(x, w, ends, y, m, K, N, g, vec, s);
}

}  // namespace

// y [m, N] = per-run x . w[run] (trans: x . w[run]^T), x [m, K] and w of
// element type `dtype` (0 fp32, 1 bf16), y of type `out_dtype` (fp32 x
// gives fp32 y only), ends int32 [g]. `vec`: K, N multiples of 8 and
// 16-byte aligned bases (bf16 only).
extern "C" int pt_grouped_matmul(const void* x, const void* w,
                                 const void* ends, void* y, int m, int K,
                                 int N, int g, int trans, int dtype,
                                 int out_dtype, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* e = static_cast<const int*>(ends);
  cudaError_t r = cudaErrorInvalidValue;
  if (dtype == 0 && out_dtype == 0)
    r = forward_any<float, float>(trans, x, w, e, y, m, K, N, g, 0, s);
  else if (dtype == 1 && out_dtype == 0)
    r = forward_any<bf, float>(trans, x, w, e, y, m, K, N, g, vec, s);
  else if (dtype == 1 && out_dtype == 1)
    r = forward_any<bf, bf>(trans, x, w, e, y, m, K, N, g, vec, s);
  return static_cast<int>(r);
}

// dw [g, K, N] = per-run x[run]^T . gy[run], x [m, K] and gy [m, N] of
// element type `dtype`, dw of type `out_dtype`; zeros for an empty run.
extern "C" int pt_grouped_matmul_dw(const void* x, const void* gy,
                                    const void* ends, void* dw, int m, int K,
                                    int N, int g, int dtype, int out_dtype,
                                    int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* e = static_cast<const int*>(ends);
  cudaError_t r = cudaErrorInvalidValue;
  if (dtype == 0 && out_dtype == 0)
    r = backward_dw<float, float>(x, gy, e, dw, m, K, N, g, 0, s);
  else if (dtype == 1 && out_dtype == 0)
    r = backward_dw<bf, float>(x, gy, e, dw, m, K, N, g, vec, s);
  else if (dtype == 1 && out_dtype == 1)
    r = backward_dw<bf, bf>(x, gy, e, dw, m, K, N, g, vec, s);
  return static_cast<int>(r);
}
