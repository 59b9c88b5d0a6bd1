// Grouped (ragged) matrix product for Hopper: the forward (and dx) and dW.
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
// is no copy and no table on the host. Two routes, chosen by the wrapper
// from dtype and shapes:
//  - bf16 with K and N multiples of 8 and 16-byte aligned bases (what TMA
//    reads): the TMA + `wgmma` mainloop of wgmma_gemm.cuh (128 x 256
//    tiles, a 4-stage ring, one producer and two consumer warpgroups,
//    persistent blocks) under a grouped tile scheduler. At block start the
//    scheduler reads `ends` on the device into a table in shared memory.
//    Forward and dx: each run's ceil(rows / 128) row tiles x ceil(N / 256)
//    column tiles, run after run (an expert's weight stays in L2 while its
//    tiles run), then the tail's; the table is the runs' first rows and
//    tile-count prefix, found by binary search. A comes from a 2-D tensor
//    map over x at row run_start + 128 t; rows of the tile past the run
//    are computed and masked in the epilogue. B comes from one 3-D tensor
//    map over w [g, ., .] in its own layout, so TMA's zero fill ends each
//    expert at its own edges: MN-major for the forward, K-major for dx
//    (whose contraction runs over w's contiguous dimension). The tail's
//    tiles have no slices and store zeros. dW: g x ceil(K / 128) x
//    ceil(N / 256) tiles, runs longest first (so that a skewed run does
//    not finish alone), each tile one block's fixed-order sum over its
//    run's rows, 64 a slice (x and gy both MN-major), no atomics: dW is
//    the same bit for bit between runs. The last slice's rows of the next
//    run are zeroed in shared memory before its products; an empty run's
//    tiles have no slices and store zeros. The stores: dW's short
//    contraction (one run's rows) makes its epilogue a large share of a
//    tile, so bf16 dW tiles leave through a shared-memory staging buffer
//    by TMA stores, which run while the block's next tile computes; bf16 y
//    goes out four columns (8 bytes) a lane after an exchange within each
//    lane quad, so that every store fills whole 32-byte sectors.
//  - fp32, and bf16 widths or bases that TMA cannot take: the shared tile
//    loop (tile_gemm.cuh; bf16 mma.sync from a cp.async ring, fp32 FMAs)
//    on a static grid of ceil(m / BM) + g row tiles (enough for every
//    run's tiles and for the tail, since the ceilings of g + 1 parts sum
//    to at most the ceiling of their sum plus g) by N / BN column tiles.
//    Each block's first warp scans the run lengths 32 runs at a time to
//    find its run and its tile within the run; blocks past the last tile
//    exit. The dw grid is (g, K / BM, N / BN): each block loops over its
//    run's rows in order, and an empty run's block writes zeros.
// No group size reaches the host on either route.

#include <stdint.h>

#include <type_traits>

#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

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

// ---------------------------------------------------------------------------
// bf16 on TMA + `wgmma`: grouped schedulers and epilogues of wgmma_gemm.cuh
// ---------------------------------------------------------------------------

namespace grouped {

using pt::wg::BK;
using pt::wg::BM;
using pt::wg::BN;
using pt::wg::PANEL;
using pt::wg::Tile;

// the largest g the schedulers' shared-memory tables hold
constexpr int MAX_GROUPS = 512;

// Forward and dx: run i in 0 .. g - 1 (and the tail, run g) of rows
// [start[i], end[i]) gives ceil(rows / BM) x tiles_n tiles from first[i];
// the table is start, end and first, g + 2 entries each.
struct Rows {
  const int* ends;
  int m, g, K, tiles_n;
  static constexpr bool RAGGED_K = false;

  __host__ __device__ int table_bytes() const { return 3 * 4 * (g + 2); }
  // warp 0 scans the runs' tile counts, one run a lane
  __device__ void setup(int* tab, unsigned char*) const {
    int *start = tab, *end = tab + (g + 2), *first = tab + 2 * (g + 2);
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int base = 0;  // tiles of the runs before this chunk
    for (int c0 = 0; c0 <= g; c0 += 32) {
      const int i = c0 + lane;
      int s = 0, e = 0;
      if (i <= g) run_rows(ends, i, g, m, s, e);
      const int nt = (e - s + BM - 1) / BM * tiles_n;
      int inc = nt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      if (i <= g) {
        start[i] = s;
        end[i] = e;
        first[i] = base + inc - nt;
      }
      base += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (lane == 0) first[g + 1] = base;
  }
  __device__ int count(const int* tab) const {
    return tab[2 * (g + 2) + g + 1];
  }
  __device__ Tile tile(const int* tab, int id) const {
    const int *start = tab, *end = tab + (g + 2), *first = tab + 2 * (g + 2);
    int lo = 0, hi = g;  // the last run whose first tile is <= id
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (first[mid] <= id) lo = mid; else hi = mid - 1;
    }
    const int local = id - first[lo];
    const int row_tiles = (end[lo] - start[lo] + BM - 1) / BM;
    const int tm = local % row_tiles, tn = local / row_tiles;
    return {start[lo] + tm * BM, tn * BN, lo < g ? (K + BK - 1) / BK : 0,
            lo, start[lo], end[lo]};
  }
  // A: x [m, K] K-major at the tile's rows; B: w [g, K, N] MN-major
  // (forward) or w [g, N, K] K-major (dx), the tile's expert's matrix
  template <bool A_MN, bool B_MN>
  __device__ void load(const Tile& t, int kt, const CUtensorMap* ta,
                       const CUtensorMap* tb, unsigned char* sa,
                       unsigned char* sb, uint64_t* bar) const {
    const int k0 = kt * BK;
    pt::hopper::tma_load2(sa, ta, bar, k0, t.m0);
    if (B_MN) {
#pragma unroll
      for (int p = 0; p < BN / 64; ++p)
        pt::hopper::tma_load3(sb + p * PANEL, tb, bar, t.n0 + 64 * p, k0,
                              t.run);
    } else {
      pt::hopper::tma_load3(sb, tb, bar, k0, t.n0, t.run);
    }
  }
};

// dW: g x tiles_m x tiles_n tiles, runs in order of their rows, longest
// first (ties by index); each tile sums its run's rows [lo, hi), BK a
// slice. The table is the order (16 bits a run); a tile's rows come from
// `ends` itself.
struct Dw {
  const int* ends;
  int m, g, tiles_m, tiles_n;
  static constexpr bool RAGGED_K = true;

  __host__ __device__ int table_bytes() const { return (2 * g + 15) / 16 * 16; }
  // the whole block: the runs' lengths into `scratch`, then each run's
  // rank by length
  __device__ void setup(int* tab, unsigned char* scratch) const {
    int* len = reinterpret_cast<int*>(scratch);
    for (int i = threadIdx.x; i < g; i += blockDim.x) {
      int s, e;
      run_rows(ends, i, g, m, s, e);
      len[i] = e - s;
    }
    __syncthreads();
    uint16_t* order = reinterpret_cast<uint16_t*>(tab);
    for (int i = threadIdx.x; i < g; i += blockDim.x) {
      int rank = 0;
      for (int j = 0; j < g; ++j)
        rank += len[j] > len[i] || (len[j] == len[i] && j < i);
      order[rank] = static_cast<uint16_t>(i);
    }
    // the scratch is the ring, which TMA writes next
    pt::hopper::fence_async_shared();
  }
  __device__ int count(const int*) const { return g * tiles_m * tiles_n; }
  __device__ Tile tile(const int* tab, int id) const {
    const int per = tiles_m * tiles_n;
    const int run = reinterpret_cast<const uint16_t*>(tab)[id / per];
    const int local = id % per;
    int lo, hi;
    run_rows(ends, run, g, m, lo, hi);
    return {local % tiles_m * BM, local / tiles_m * BN,
            (hi - lo + BK - 1) / BK, run, lo, hi};
  }
  // A: x [m, K] read MN-major (K is the output's rows), B: gy [m, N]
  // MN-major, both at the slice's rows
  template <bool A_MN, bool B_MN>
  __device__ void load(const Tile& t, int kt, const CUtensorMap* ta,
                       const CUtensorMap* tb, unsigned char* sa,
                       unsigned char* sb, uint64_t* bar) const {
    const int r0 = t.lo + kt * BK;
    pt::hopper::tma_load2(sa, ta, bar, t.m0, r0);
    pt::hopper::tma_load2(sa + PANEL, ta, bar, t.m0 + 64, r0);
#pragma unroll
    for (int p = 0; p < BN / 64; ++p)
      pt::hopper::tma_load2(sb + p * PANEL, tb, bar, t.n0 + 64 * p, r0);
  }
  // rows of slice kt inside the run (BK but for the last slice)
  __device__ int valid_k(const Tile& t, int kt) const {
    return min(BK, t.hi - t.lo - kt * BK);
  }
};

template <typename OutT>
__device__ __forceinline__ void store2(OutT* p, float a, float b) {
  if constexpr (std::is_same<OutT, float>::value)
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// y rows of the tile's run ([.., hi)), N columns (a multiple of 8, so a
// pair or a bf16 quad never straddles the edge); the tail's tiles store
// their zeros. bf16 goes out four columns (8 bytes) a lane.
template <typename OutT>
struct RowsOut {
  static constexpr int STORE =
      std::is_same<OutT, bf>::value ? pt::wg::QUADS : pt::wg::PAIRS;
  OutT* y;
  int N;

  struct Row {
    OutT* out;
    bool ok;
  };
  __device__ __forceinline__ Row row(const Tile& t, int r) const {
    return {y + static_cast<long long>(r) * N, r < t.hi};
  }
  __device__ __forceinline__ float2 addend(const Row&, int) const {
    return make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ void pair(const Row& r, int col, float x0,
                                       float x1) const {
    if (col < N) store2(r.out + col, x0, x1);
  }
  __device__ __forceinline__ void quad(const Row& r, int col,
                                       uint2 v) const {
    if (col < N) *reinterpret_cast<uint2*>(r.out + col) = v;
  }
};

// dw[run] [K, N]; an empty run's tiles store zeros. bf16 goes out by TMA
// (boxes of the 3-D map over dw [g, K, N], clipped at K and N).
template <typename OutT>
struct DwOut {
  static constexpr int STORE =
      std::is_same<OutT, bf>::value ? pt::wg::TMA : pt::wg::PAIRS;
  OutT* dw;
  int K, N;

  struct Row {
    OutT* out;
    bool ok;
  };
  __device__ __forceinline__ Row row(const Tile& t, int r) const {
    return {dw + (static_cast<long long>(t.run) * K + r) * N, r < K};
  }
  __device__ __forceinline__ float2 addend(const Row&, int) const {
    return make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ void pair(const Row& r, int col, float x0,
                                       float x1) const {
    if (col < N) store2(r.out + col, x0, x1);
  }
  __device__ __forceinline__ void store_box(const CUtensorMap* tc,
                                            const unsigned char* box,
                                            const Tile& t, int row,
                                            int col) const {
    pt::hopper::tma_store3(tc, box, col, row, t.run);
  }
};

// forward (w [g, K, N]) or, with TRANS, dx (w [g, N, K])
template <typename OutT, bool TRANS>
int forward(const void* x, const void* w, const int* ends, void* y, int m,
            int K, int N, int g, cudaStream_t s) {
  using pt::hopper::MAP_REFUSED;
  CUtensorMap ta, tb;
  if (!pt::wg::map_bf16(&ta, {x, K, m, K}, BM)) return MAP_REFUSED;
  const bool ok = TRANS ? pt::wg::map_bf16_3d(&tb, w, K, N, g, BN)
                        : pt::wg::map_bf16_3d(&tb, w, N, K, g, 64);
  if (!ok) return MAP_REFUSED + 1;
  const Rows sched = {ends, m, g, K, (N + BN - 1) / BN};
  const RowsOut<OutT> epi = {static_cast<OutT*>(y), N};
  return pt::wg::launch<false, !TRANS>(
      ta, tb, CUtensorMap{}, sched, epi,
      (static_cast<long long>(m + BM - 1) / BM + g) * sched.tiles_n, s);
}

template <typename OutT>
int dw(const void* x, const void* gy, const int* ends, void* out, int m,
       int K, int N, int g, cudaStream_t s) {
  using pt::hopper::MAP_REFUSED;
  CUtensorMap ta, tb, tc = {};
  if (!pt::wg::map_bf16(&ta, {x, K, m, K}, 64)) return MAP_REFUSED;
  if (!pt::wg::map_bf16(&tb, {gy, N, m, N}, 64)) return MAP_REFUSED + 1;
  if (std::is_same<OutT, bf>::value &&
      !pt::wg::map_bf16_3d(&tc, out, N, K, g, 64))
    return MAP_REFUSED + 2;
  const Dw sched = {ends, m, g, (K + BM - 1) / BM, (N + BN - 1) / BN};
  const DwOut<OutT> epi = {static_cast<OutT*>(out), K, N};
  return pt::wg::launch<true, true>(
      ta, tb, tc, sched, epi,
      static_cast<long long>(g) * sched.tiles_m * sched.tiles_n, s);
}

}  // namespace grouped

}  // namespace

// y [m, N] = per-run x . w[run] (trans: x . w[run]^T), x [m, K] and w of
// element type `dtype` (0 fp32, 1 bf16), y of type `out_dtype` (fp32 x
// gives fp32 y only), ends int32 [g]. `route` (bf16 only): 0 the tile
// loop with element loads, 1 the tile loop with 16-byte loads (K, N
// multiples of 8, 16-byte aligned bases), 2 TMA + `wgmma` (the same, and
// g <= MAX_GROUPS).
extern "C" int pt_grouped_matmul(const void* x, const void* w,
                                 const void* ends, void* y, int m, int K,
                                 int N, int g, int trans, int dtype,
                                 int out_dtype, int route, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* e = static_cast<const int*>(ends);
  if (dtype == 1 && route == 2) {
    if (g > grouped::MAX_GROUPS || K % 8 || N % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    if (out_dtype == 0)
      return trans ? grouped::forward<float, true>(x, w, e, y, m, K, N, g, s)
                   : grouped::forward<float, false>(x, w, e, y, m, K, N, g,
                                                    s);
    if (out_dtype == 1)
      return trans ? grouped::forward<bf, true>(x, w, e, y, m, K, N, g, s)
                   : grouped::forward<bf, false>(x, w, e, y, m, K, N, g, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = route == 1;
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
// `route` as for pt_grouped_matmul.
extern "C" int pt_grouped_matmul_dw(const void* x, const void* gy,
                                    const void* ends, void* dw, int m, int K,
                                    int N, int g, int dtype, int out_dtype,
                                    int route, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* e = static_cast<const int*>(ends);
  if (dtype == 1 && route == 2) {
    if (g > grouped::MAX_GROUPS || K % 8 || N % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    if (out_dtype == 0) return grouped::dw<float>(x, gy, e, dw, m, K, N, g, s);
    if (out_dtype == 1) return grouped::dw<bf>(x, gy, e, dw, m, K, N, g, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = route == 1;
  cudaError_t r = cudaErrorInvalidValue;
  if (dtype == 0 && out_dtype == 0)
    r = backward_dw<float, float>(x, gy, e, dw, m, K, N, g, 0, s);
  else if (dtype == 1 && out_dtype == 0)
    r = backward_dw<bf, float>(x, gy, e, dw, m, K, N, g, vec, s);
  else if (dtype == 1 && out_dtype == 1)
    r = backward_dw<bf, bf>(x, gy, e, dw, m, K, N, g, vec, s);
  return static_cast<int>(r);
}
