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
// epilogue, as the TPU kernel's `_epilogue` does. Three routes, which the
// wrapper chooses from m and x's type:
//  - bf16 x, m > 16 (prefill): TMA + `wgmma` with warp specialisation
//    (CUTLASS's mixed-input Hopper GEMM). The operands are swapped,
//    y^T = wq . x^T, so that the int8 weight is the M-side operand, the
//    only one `wgmma` takes from registers. Tiles of 128 channels x BN
//    tokens (BN = 256 at m >= 256, 128 at m > 64, else 64), 64-deep
//    k-slices in a 4-stage ring: TMA brings the weight as int8 in 64-byte
//    rows in the 64-byte swizzle (conflict-free reads of the fragment's
//    bytes) and x as a bf16 K-major box in the 128-byte swizzle that the
//    `wgmma` descriptor reads in place. One producer warpgroup (one thread
//    issues the copies) and two consumer warpgroups of 64 channels each;
//    persistent blocks walk the tiles in wgmma_gemm.cuh's raster, so the
//    token tiles of one channel tile run together and read its weight from
//    L2. Each consumer thread reads its A fragment (rows g and g + 8, k =
//    2c, 2c + 1, 2c + 8, 2c + 9 of each 16-deep step) from the int8 tile
//    and widens it to bf16 in registers, exactly: the byte goes into the
//    fp32 pattern of 2^23 + (b + 128) by one `prmt`, one subtract leaves
//    b, and the high halves of two such floats are a bf16 pair. The
//    fragments are double-buffered across slices, since `wgmma` reads its
//    registers after issue. The epilogue multiplies each channel by its
//    scale, rounds once, and stages the tile transposed ([token][channel],
//    16-byte chunks swizzled by token) in shared memory, then writes y
//    rows in 16-byte stores.
//  - bf16 x, m <= 16 (decode): tensor cores, mma.sync m16n8k16 (bf16
//    operands, fp32 accumulators) from a cp.async ring with 16-byte copies.
//    Each thread reads its B fragment as one 32-bit word of four int8
//    values of one weight row (wq is [n, k], k contiguous: the `.col`
//    layout the B operand wants) and widens it to two bf16 pairs; int8 is
//    exact in bf16. The four values are k = 4c .. 4c + 3 of the 16-deep
//    step (c = lane % 4), where the fragment's own order is 2c, 2c + 1,
//    2c + 8, 2c + 9: the A fragment is read with the same permutation of
//    k, which leaves the sum unchanged and makes both reads single words
//    (A: two 8-byte reads per 16 rows). 16 x 32 block tiles, 4 warps that
//    split each 256-deep stage four ways (k groups) and add their partial
//    sums in a fixed order at the end, 4 stages. At n = 4096 that is 128
//    blocks for 132 SMs, each streaming 32 weight rows; rows 8..15 of the
//    tile are zero-filled without reading memory.
//  - fp32 x: real fp32 FMAs (64 x 64 tiles, 4 x 4 outputs a thread), as
//    the fp32 tolerance needs; the weight widens to fp32 in shared memory.
// A split over k across blocks (n = 4096 leaves SMs idle at decode) is
// later work.

#include <stdint.h>

#include "common.cuh"
#include "wgmma_gemm.cuh"

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

// ---------------------------------------------------------------------------
// bf16 x, m > 16: TMA + register-A `wgmma` (the weight widened in registers)
// ---------------------------------------------------------------------------

namespace prefill {

using namespace pt::hopper;

constexpr int BM = 128;              // channels: two consumer warpgroups
constexpr int BK = 64;               // k of a slice: 64 int8 bytes a row
constexpr int STAGES = 4;
constexpr int NTH = 384;
constexpr int A_BYTES = BM * BK;     // 8 KB of int8 weight

template <int BN>
struct Geo {
  static constexpr int B_BYTES = BN * BK * 2;     // bf16 x
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int OUT = BN * 64 * 2;         // a warpgroup's staging
  static constexpr int SMEM = STAGES * STAGE + 2 * OUT + 2 * STAGES * 8 +
                              1024;
  static_assert(SMEM <= pt::wg::SMEM_MAX, "shared memory");
};

// d[64 x 64] (+)= A . B: A from registers (bf16 pairs in the fragment
// order), B K-major from shared memory (descriptor)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d[64 x 128] (+)= A . B: A from registers (bf16 pairs in the fragment
// order), B K-major from shared memory (descriptor)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d[64 x 256] (+)= A . B: A from registers (bf16 pairs in the fragment
// order), B K-major from shared memory (descriptor)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "
      "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, "
      "%121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (BN == 256)
    wgmma_rs_n256(d, a, b, 1);
  else if constexpr (BN == 128)
    wgmma_rs_n128(d, a, b, 1);
  else
    wgmma_rs_n64(d, a, b, 1);
}

// four int8 values (bytes of q, low first) -> two bf16 pairs, exactly:
// byte b becomes the fp32 pattern of 2^23 + (b + 128), one subtract
// leaves b, and a bf16 pair is the high halves of two such floats
__device__ __forceinline__ void widen(uint32_t q, uint32_t& lo,
                                      uint32_t& hi) {
  q ^= 0x80808080u;
  constexpr float kMagic = 8388736.f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(q, 0x4B000000u, 0x7650)) -
                   kMagic;
  const float f1 = __uint_as_float(__byte_perm(q, 0x4B000000u, 0x7651)) -
                   kMagic;
  const float f2 = __uint_as_float(__byte_perm(q, 0x4B000000u, 0x7652)) -
                   kMagic;
  const float f3 = __uint_as_float(__byte_perm(q, 0x4B000000u, 0x7653)) -
                   kMagic;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// the A fragments of a slice's four 16-deep steps for weight rows r0 and
// r0 + 8 of the tile (lane quad c): bytes 2c, 2c + 1 and 2c + 8, 2c + 9 of
// each step's 16, read through the 64-byte swizzle (16-byte chunk j of
// row r at chunk j ^ ((r >> 1) & 3); r0 and r0 + 8 share it)
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4],
                                       const unsigned char* sa, int r0,
                                       int c) {
  const unsigned char* p0 = sa + r0 * BK;
  const unsigned char* p1 = p0 + 8 * BK;
  const int sw = (r0 >> 1) & 3;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int off = ((s ^ sw) << 4) + 2 * c;
    const uint32_t q0 =
        *reinterpret_cast<const uint16_t*>(p0 + off) |
        (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p0 + off +
                                                                  8))
         << 16);
    const uint32_t q1 =
        *reinterpret_cast<const uint16_t*>(p1 + off) |
        (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p1 + off +
                                                                  8))
         << 16);
    widen(q0, a[s][0], a[s][2]);   // row g: k 2c, 2c + 1 | 2c + 8, 2c + 9
    widen(q1, a[s][1], a[s][3]);   // row g + 8
  }
}

// One slice through fragment buffer BUF: wait for its stage, widen the
// weight, issue its four products, then wait for the previous slice's
// (whose fragments, in the other buffer, stay untouched until then) and
// free that slice's stage.
template <int BN, int BUF>
__device__ __forceinline__ void slice(float (&acc)[BN / 2],
                                      uint32_t (&a)[2][4][4],
                                      unsigned char* sm, uint64_t* full,
                                      uint64_t* empty, int it, int kt,
                                      int r0, int c, int t) {
  const int st = it % STAGES;
  mbar_wait(&full[st], (it / STAGES) & 1);
  const unsigned char* sa = sm + st * Geo<BN>::STAGE;
  load_a(a[BUF], sa, r0, c);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<BN>(acc, a[BUF][kk], pt::wg::b_desc<false>(sa + A_BYTES, kk));
  wg_commit();
  wg_wait<1>();
  keep(a[BUF ^ 1]);
  if (kt > 0 && t == 0) mbar_arrive(&empty[(it + STAGES - 1) % STAGES]);
}

template <int BN>
__global__ void __launch_bounds__(NTH, 1)
    int8_wgmma_kernel(const __grid_constant__ CUtensorMap tw,
                      const __grid_constant__ CUtensorMap tx,
                      const float* __restrict__ scale, bf* __restrict__ y,
                      int m, int n, int k) {
  using G = Geo<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* staging = sm + STAGES * G::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * G::OUT);
  uint64_t* empty = full + STAGES;
  const int tiles_m = (n + BM - 1) / BM, tiles_n = (m + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n;
  const int nk = (k + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int w = threadIdx.x / 128;
  if (w == 2) {
    // producer: the weight's and x's slices of every tile of this block
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int id = blockIdx.x; id < tiles; id += gridDim.x) {
        int tm, tn;
        pt::wg::raster(id, tiles_m, tiles_n, tm, tn);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int st = it % STAGES;
          mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
          unsigned char* sa = sm + st * G::STAGE;
          mbar_expect_tx(&full[st], G::STAGE);
          tma_load2(sa, &tw, &full[st], kt * BK, tm * BM);
          tma_load2(sa + A_BYTES, &tx, &full[st], kt * BK, tn * BN);
        }
      }
    }
    return;
  }
  // consumers: warpgroup w owns channels 64 w .. 64 w + 63 of each tile
  setmaxnreg_inc<232>();
  const int t = threadIdx.x & 127, lane = t & 31, c = lane & 3;
  const int cl = 16 * (t >> 5) + (lane >> 2);  // channel, of the 64
  const int r0 = 64 * w + cl;                  // row of the weight tile
  unsigned char* out = staging + w * G::OUT;   // [BN tokens][64 channels]
  float acc[BN / 2];
  uint32_t a[2][4][4];
  int it = 0;
  for (int id = blockIdx.x; id < tiles; id += gridDim.x) {
    int tm, tn;
    pt::wg::raster(id, tiles_m, tiles_n, tm, tn);
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    int kt = 0;
    for (; kt + 1 < nk; kt += 2, it += 2) {
      slice<BN, 0>(acc, a, sm, full, empty, it, kt, r0, c, t);
      slice<BN, 1>(acc, a, sm, full, empty, it + 1, kt + 1, r0, c, t);
    }
    if (kt < nk) {
      slice<BN, 0>(acc, a, sm, full, empty, it, kt, r0, c, t);
      ++it;
    }
    wg_wait<0>();
    keep(acc);
    if (nk > 0 && t == 0) mbar_arrive(&empty[(it + STAGES - 1) % STAGES]);

    // epilogue: scale, round once, stage [token][channel] with 16-byte
    // chunk j of token row r at j ^ (r & 7), then 16-byte stores of y
    const int ch = tm * BM + r0;
    const float s0 = ch < n ? scale[ch] : 0.f;
    const float s1 = ch + 8 < n ? scale[ch + 8] : 0.f;
    named_sync(1 + w, 128);  // the last tile's staging has been read
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tl = 8 * j + 2 * c + e;
        unsigned char* row = out + tl * 128 + (cl & 7) * 2;
        *reinterpret_cast<bf*>(row + (((cl >> 3) ^ (tl & 7)) << 4)) =
            __float2bfloat16(acc[4 * j + e] * s0);
        *reinterpret_cast<bf*>(row + ((((cl >> 3) + 1) ^ (tl & 7)) << 4)) =
            __float2bfloat16(acc[4 * j + 2 + e] * s1);
      }
    named_sync(1 + w, 128);
    for (int i = t; i < BN * 8; i += 128) {
      const int tl = i >> 3, q = i & 7;
      const int tok = tn * BN + tl, chq = tm * BM + 64 * w + 8 * q;
      if (tok < m && chq < n)
        *reinterpret_cast<uint4*>(y + static_cast<long long>(tok) * n + chq) =
            *reinterpret_cast<const uint4*>(out + tl * 128 +
                                            ((q ^ (tl & 7)) << 4));
    }
  }
}

template <int BN>
int launch(const void* x, const void* wq, const float* scale, void* y, int m,
           int n, int k, cudaStream_t stream) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return MAP_REFUSED;
  // the weight [n, k] int8: boxes of 64 bytes x 128 rows, 64-byte swizzle
  CUtensorMap tw, tx;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {BK, BM};
  const cuuint32_t estr[2] = {1, 1};
  if (enc(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wq), dims,
          strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return MAP_REFUSED;
  if (!pt::wg::map_bf16(&tx, {x, k, m, k}, BN)) return MAP_REFUSED + 1;
  const int tiles = ((n + BM - 1) / BM) * ((m + BN - 1) / BN);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(int8_wgmma_kernel<BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Geo<BN>::SMEM);
  if (e != cudaSuccess) return e;
  const int grid = tiles < sms ? tiles : sms;
  int8_wgmma_kernel<BN><<<grid, NTH, Geo<BN>::SMEM, stream>>>(
      tw, tx, scale, static_cast<bf*>(y), m, n, k);
  return cudaGetLastError();
}

// the token tile for m rows
int launch_any(const void* x, const void* wq, const float* scale, void* y,
               int m, int n, int k, cudaStream_t s) {
  if (m >= 256) return launch<256>(x, wq, scale, y, m, n, k, s);
  if (m > 64) return launch<128>(x, wq, scale, y, m, n, k, s);
  return launch<64>(x, wq, scale, y, m, n, k, s);
}

}  // namespace prefill

}  // namespace

// `route`: 0 fp32 x (FMAs), 1 bf16 x on the mma.sync decode tiling, 2 bf16
// x on TMA + `wgmma` (the wrapper takes 1 for m <= 16, else 2).
extern "C" int pt_int8_matmul(const void* x, const void* wq,
                              const void* scale, void* y, int m, int n, int k,
                              int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (m < 1 || n < 16 || k < 16 || n % 16 || k % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 2) return prefill::launch_any(x, wq, sc, y, m, n, k, s);
  if (route == 1)
    return static_cast<int>(launch_bf16<DecodeTile>(x, wq, sc, y, m, n, k,
                                                    s));
  if (route == 0) {
    const dim3 grid((n + F_BN - 1) / F_BN, (m + F_BM - 1) / F_BM);
    int8_mm_f32_kernel<<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(wq), sc,
        static_cast<float*>(y), m, n, k);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
