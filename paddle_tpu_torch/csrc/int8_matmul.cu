// Weight-only int8 matrix product for Hopper.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/int8_matmul.py `_kernel`
// (called from `int8_matmul_pallas`) and computes what it computes:
//   y[m, n] = (sum_k x[m, k] * float(wq[n, k])) * scale[n]
// with x [m, k] row-major bf16 or fp32, wq [n, k] int8 (k contiguous, the
// transposed layout `weight_quantize` writes), scale [n] fp32, the sum in
// fp32 and y [m, n] in x's type, rounded once. Any m >= 1 (rows past m are
// masked); n and k multiples of 16.
//
// Bound: at decode (m = 8) bytes: the n x k int8 weight crosses device
// memory once and x, scale and y are small; at Llama-3-8B widths that is
// 7.5 / 5.0 / 35.0 / 17.5 / 156.8 us for qkv / o / gate_up / down /
// lm_head at 3.35 TB/s. At prefill (m of a page multiple, up to 1536)
// operations: 2 m n k on the tensor cores.
//
// Design. The weight is widened from int8 in registers, right before the
// product, and never written back dequantized: that pass is what the
// kernel exists to avoid. The scale multiplies the fp32 sum once, in the
// epilogue, as the TPU kernel's `_epilogue` does.
//  - bf16 x: tensor cores, mma.sync m16n8k16 (bf16 operands, fp32
//    accumulators). x and the int8 weight tile stream through a cp.async
//    ring in shared memory with 16-byte copies. Each thread reads its
//    B fragment as one 32-bit word of four int8 values of one weight row
//    (wq is [n, k], k contiguous: the `.col` layout the B operand wants)
//    and widens it to two bf16 pairs; int8 is exact in bf16. The four
//    values are k = 4c .. 4c + 3 of the 16-deep step (c = lane % 4),
//    where the fragment's own order is 2c, 2c + 1, 2c + 8, 2c + 9: the
//    A fragment is read with the same permutation of k, which leaves
//    the sum unchanged and makes both reads single words (A: two 8-byte
//    reads per 16 rows).
//    Two tilings, chosen by m:
//      m <= 16 (decode): 16 x 32 block tiles, 4 warps that split each
//      256-deep stage four ways (k groups) and add their partial sums in
//      a fixed order at the end, 4 stages. At n = 4096 that is 128
//      blocks for 132 SMs, each streaming 32 weight rows; rows 8..15 of
//      the tile are zero-filled without reading memory.
//      m > 16 (prefill): 128 x 128 block tiles of four 64 x 64 warp
//      tiles, 64-deep stages, 3 stages.
//  - fp32 x: real fp32 FMAs (64 x 64 tiles, 4 x 4 outputs a thread), as
//    the fp32 tolerance needs; the weight widens to fp32 in shared memory.
// `wgmma`, TMA and a split over k across blocks (n = 4096 leaves SMs idle
// at decode) are later work.

#include <stdint.h>

#include "common.cuh"

namespace {

using bf = __nv_bfloat16;
using pt::cp_async16;
using pt::cp_async_commit;
using pt::cp_async_wait;

// block tile BM x BN; WGM x WGN warps over it, repeated for KS k groups
template <int BM_, int BN_, int WGM, int WGN, int KS_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, KS = KS_, STAGES = STAGES_;
  static constexpr int THREADS = WGM * WGN * KS * 32;
  static constexpr int BK = 64;             // k of one group in a stage
  static constexpr int SK = BK * KS;        // k of a stage
  static constexpr int WM = BM / WGM, WN = BN / WGN;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int WG = WGM * WGN;      // warps of one k group
  // staged rows padded so that the fragment reads of a warp fall in
  // distinct banks: x rows 2 SK + 32 bytes, weight rows SK + 16 bytes
  static constexpr int LDX = SK + 16;       // bf16 elements
  static constexpr int LDW = SK + 16;       // bytes
  static constexpr int X_BYTES = BM * LDX * 2;
  static constexpr int STAGE_BYTES = X_BYTES + BN * LDW;
  static constexpr int LDC = BN + 4;        // fp32 partial sums
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int CS = KS * BM * LDC * 4;
  static constexpr int SMEM = RING > CS ? RING : CS;
};

using DecodeTile = Tile<16, 32, 1, 1, 4, 4>;
using PrefillTile = Tile<128, 128, 2, 2, 1, 3>;

// four int8 values of a 32-bit word -> two bf16 pairs, low bytes first
__device__ __forceinline__ void widen4(unsigned q, unsigned& lo,
                                       unsigned& hi) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(
      static_cast<float>(static_cast<signed char>(q & 0xffu)),
      static_cast<float>(static_cast<signed char>((q >> 8) & 0xffu)));
  const __nv_bfloat162 b = __floats2bfloat162_rn(
      static_cast<float>(static_cast<signed char>((q >> 16) & 0xffu)),
      static_cast<float>(static_cast<signed char>(q >> 24)));
  lo = *reinterpret_cast<const unsigned*>(&a);
  hi = *reinterpret_cast<const unsigned*>(&b);
}

// d += a . b on one m16n8k16 tile: bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <class C>
__global__ void __launch_bounds__(C::THREADS)
int8_mm_bf16_kernel(const bf* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, bf* __restrict__ y,
                    int m, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kg = warp / C::WG, wi = warp % C::WG;
  const int wm = wi / (C::BN / C::WN), wn = wi % (C::BN / C::WN);
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int g = lane >> 2, c = lane & 3;
  const int nsteps = (k + C::SK - 1) / C::SK;

  auto stage_x = [&](int s) {
    return reinterpret_cast<bf*>(smem + s * C::STAGE_BYTES);
  };
  auto stage_w = [&](int s) {
    return reinterpret_cast<int8_t*>(smem + s * C::STAGE_BYTES + C::X_BYTES);
  };
  // stage `step` of x (BM rows, 8 elements a copy) and of the weight (BN
  // rows, 16 a copy); k is a multiple of 16, so a copy is whole or absent
  auto load = [&](int step, int s) {
    const int k0 = step * C::SK;
    bf* xd = stage_x(s);
    for (int v = tid; v < C::BM * C::SK / 8; v += C::THREADS) {
      const int r = v / (C::SK / 8), cc = (v % (C::SK / 8)) * 8;
      const bool ok = m0 + r < m && k0 + cc < k;
      cp_async16(xd + r * C::LDX + cc,
                 ok ? x + static_cast<size_t>(m0 + r) * k + k0 + cc : x, ok);
    }
    int8_t* wd = stage_w(s);
    for (int v = tid; v < C::BN * C::SK / 16; v += C::THREADS) {
      const int r = v / (C::SK / 16), cc = (v % (C::SK / 16)) * 16;
      const bool ok = n0 + r < n && k0 + cc < k;
      cp_async16(wd + r * C::LDW + cc,
                 ok ? w + static_cast<size_t>(n0 + r) * k + k0 + cc : w, ok);
    }
  };

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    // refill the slot that step - 1 read, which every thread has left
    const int next = step + C::STAGES - 1;
    if (next < nsteps) load(next, next % C::STAGES);
    cp_async_commit();
    const int s = step % C::STAGES;
    const bf* xt = stage_x(s) + kg * C::BK;
    const int8_t* wt = stage_w(s) + kg * C::BK;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      unsigned a[C::MT][4];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        const bf* p = xt + (wm * C::WM + i * 16 + g) * C::LDX + kk + 4 * c;
        const uint2 lo = *reinterpret_cast<const uint2*>(p);
        const uint2 hi = *reinterpret_cast<const uint2*>(p + 8 * C::LDX);
        a[i][0] = lo.x;     // row g,     k 4c, 4c + 1
        a[i][1] = hi.x;     // row g + 8, k 4c, 4c + 1
        a[i][2] = lo.y;     // row g,     k 4c + 2, 4c + 3
        a[i][3] = hi.y;     // row g + 8, k 4c + 2, 4c + 3
      }
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        const int8_t* p = wt + (wn * C::WN + j * 8 + g) * C::LDW + kk + 4 * c;
        unsigned b0, b1;
        widen4(*reinterpret_cast<const unsigned*>(p), b0, b1);
#pragma unroll
        for (int i = 0; i < C::MT; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring becomes the partial sums

  float* cs = reinterpret_cast<float*>(smem) + kg * C::BM * C::LDC;
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j) {
      const int r = wm * C::WM + i * 16 + g, col = wn * C::WN + j * 8 + 2 * c;
      cs[r * C::LDC + col] = acc[i][j][0];
      cs[r * C::LDC + col + 1] = acc[i][j][1];
      cs[(r + 8) * C::LDC + col] = acc[i][j][2];
      cs[(r + 8) * C::LDC + col + 1] = acc[i][j][3];
    }
  __syncthreads();
  // k groups added in order, the scale on the sum, two columns a thread
  const float* c0 = reinterpret_cast<const float*>(smem);
  for (int v = tid; v < C::BM * C::BN / 2; v += C::THREADS) {
    const int r = v / (C::BN / 2), col = (v % (C::BN / 2)) * 2;
    if (m0 + r >= m || n0 + col >= n) continue;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int q = 0; q < C::KS; ++q) {
      s0 += c0[(q * C::BM + r) * C::LDC + col];
      s1 += c0[(q * C::BM + r) * C::LDC + col + 1];
    }
    *reinterpret_cast<__nv_bfloat162*>(
        y + static_cast<size_t>(m0 + r) * n + n0 + col) =
        __floats2bfloat162_rn(s0 * scale[n0 + col], s1 * scale[n0 + col + 1]);
  }
}

constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_THREADS = 256;

// fp32 x: 16 x 16 threads, each 4 x 4 outputs strided by 16 rows and
// columns; x staged transposed, the weight widened to fp32 on staging
__global__ void __launch_bounds__(F_THREADS)
int8_mm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ y,
                   int m, int n, int k) {
  __shared__ float xs[F_BK][F_BM + 4];
  __shared__ float ws[F_BK][F_BN + 4];
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int m0 = blockIdx.y * F_BM, n0 = blockIdx.x * F_BN;
  const int lr = tid >> 2, lk = (tid & 3) * 4;   // one row, four k a load
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < k; k0 += F_BK) {
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + lr < m)
      xv = *reinterpret_cast<const float4*>(
          x + static_cast<size_t>(m0 + lr) * k + k0 + lk);
    unsigned wv = 0;
    if (n0 + lr < n)
      wv = *reinterpret_cast<const unsigned*>(
          w + static_cast<size_t>(n0 + lr) * k + k0 + lk);
    __syncthreads();  // the previous tile is read
    xs[lk][lr] = xv.x;
    xs[lk + 1][lr] = xv.y;
    xs[lk + 2][lr] = xv.z;
    xs[lk + 3][lr] = xv.w;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ws[lk + e][lr] = static_cast<float>(
          static_cast<signed char>((wv >> (8 * e)) & 0xffu));
    __syncthreads();
#pragma unroll
    for (int kq = 0; kq < F_BK; ++kq) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kq][tr + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kq][tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + tr + 16 * i, col = n0 + tc + 16 * j;
      if (r < m && col < n)
        y[static_cast<size_t>(r) * n + col] = acc[i][j] * scale[col];
    }
}

template <class C>
cudaError_t launch_bf16(const void* x, const void* w, const float* scale,
                        void* y, int m, int n, int k, cudaStream_t s) {
  static bool ready = false;  // dynamic shared memory above 48 KB
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_mm_bf16_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const dim3 grid((n + C::BN - 1) / C::BN, (m + C::BM - 1) / C::BM);
  int8_mm_bf16_kernel<C><<<grid, C::THREADS, C::SMEM, s>>>(
      static_cast<const bf*>(x), static_cast<const int8_t*>(w), scale,
      static_cast<bf*>(y), m, n, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pt_int8_matmul(const void* x, const void* wq,
                              const void* scale, void* y, int m, int n, int k,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (m < 1 || n < 16 || k < 16 || n % 16 || k % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return static_cast<int>(
        m <= DecodeTile::BM
            ? launch_bf16<DecodeTile>(x, wq, sc, y, m, n, k, s)
            : launch_bf16<PrefillTile>(x, wq, sc, y, m, n, k, s));
  if (dtype == 0) {
    const dim3 grid((n + F_BN - 1) / F_BN, (m + F_BM - 1) / F_BM);
    int8_mm_f32_kernel<<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(wq), sc,
        static_cast<float*>(y), m, n, k);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
