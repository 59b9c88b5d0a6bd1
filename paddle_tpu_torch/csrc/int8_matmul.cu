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
// Bound: at decode (m <= 16) bytes: the n x k int8 weight crosses device
// memory once and x, scale and y are small; at Llama-3-8B widths that is
// 7.5 / 5.0 / 35.0 / 17.5 / 156.8 us for qkv / o / gate_up / down /
// lm_head at 3.35 TB/s. At prefill (m of a page multiple, up to 1536)
// operations: 2 m n k on the tensor cores.
//
// The weight is widened from int8 in registers, right before the product,
// and never written back dequantized: that pass is what the kernel exists
// to avoid. Widening is exact: the byte, offset by 128, goes into the fp32
// pattern of 2^23 + (b + 128) by one `prmt`, one subtract leaves b, and
// the high halves of two such floats are a bf16 pair. The scale multiplies
// the fp32 sum once, in the epilogue, as the TPU kernel's `_epilogue` does.
// Three routes, which the wrapper chooses from m and x's type:
//  - bf16 x, m <= 16 (decode; namespace `decode`). The time is the
//    weight's bytes, so the design is about keeping HBM busy from every
//    SM with nothing else in the weight's way:
//    * operands swapped, y^T = wq . x^T, on mma.sync m16n8k16: the weight
//      is the A operand (16 channels x 16 k; [n, k] with k contiguous is
//      the `.row` layout) and x^T the B operand (8 tokens; [m, k] is the
//      `.col` layout), so one n8 tile holds m <= 8 and two hold m <= 16,
//      and no product is spent on rows of zeros. k is permuted inside
//      each 64-deep step so that a lane's fragments are 16 contiguous
//      bytes of weight rows g and g + 8 (k = 16c .. 16c + 15; its four
//      16-deep products take bytes 4j .. 4j + 3 as k 2c, 2c + 1, 2c + 8,
//      2c + 9) and 32 contiguous bytes of x row g: the same permutation
//      on both operands leaves the sum unchanged; each read is one
//      16-byte shared-memory load, conflict-free (rows 16 bytes past a
//      multiple of 128);
//    * blocks of 4 warps own 64 channels (16 a warp) and one k slice. The
//      block stages its slice of x (all m rows, zero past m) in shared
//      memory once, with `cp.async`, and its four warps read their B
//      fragments from there;
//    * each warp streams its own 16 weight rows through a ring of its own
//      (STAGES stages of W bytes a row): lanes 0..15 each issue one TMA
//      bulk copy (`cp.async.bulk`) of a row's next W bytes, completing on
//      the stage's mbarrier, so the copy engine keeps the bytes in flight
//      and the threads only widen and multiply; a warp needs no block
//      barrier until the end. The copies carry an L2 evict-first policy:
//      the weight is read once, so its lines are the ones to go. Loading
//      each lane's 16 bytes straight into registers (64-byte pieces of
//      each row a load) stayed well above a plain read of the weight at
//      gate_up, down and lm_head, and more bytes in flight made it slower
//      (PERF.md): the row pieces, not the bytes in flight, were the
//      limit. Whole 256-byte pieces a row, two stages deep, did best of
//      the geometries tried (128 to 512 bytes, one to four stages);
//    * split over k: the grid is (channel tiles x splits), planned on the
//      host from (m, n, k, SM count) alone (ops/kernels/int8_matmul.py
//      `split_plan`): the most splits whose blocks all fit the card in
//      one wave, at most 2.5 blocks an SM. More blocks streaming at once
//      ran slower, and a second, partial wave costs a whole block's time
//      (chip_smoke.py's plan sweep). Splits write fp32 partials in
//      fragment order to a workspace and take a ticket (one
//      acquire-release atomic a block); the last block of a channel tile
//      adds the partials in split order, applies the scale, stores y and
//      resets the ticket. So the route is one launch and bit-identical
//      between runs. A plan of one split stores y straight from the
//      accumulators.
//  - bf16 x, m > 16 (prefill; namespace `prefill`): TMA + `wgmma` with
//    warp specialisation (CUTLASS's mixed-input Hopper GEMM). The operands
//    are swapped, y^T = wq . x^T, so that the int8 weight is the M-side
//    operand, the only one `wgmma` takes from registers. Tiles of 128
//    channels x BN tokens (BN = 256 at m >= 256, 128 at m > 64, else 64),
//    64-deep k-slices in a 4-stage ring: TMA brings the weight as int8 in
//    64-byte rows in the 64-byte swizzle (conflict-free reads of the
//    fragment's bytes) and x as a bf16 K-major box in the 128-byte swizzle
//    that the `wgmma` descriptor reads in place. One producer warpgroup
//    (one thread issues the copies) and two consumer warpgroups of 64
//    channels each; persistent blocks walk the tiles in wgmma_gemm.cuh's
//    raster, so the token tiles of one channel tile run together and read
//    its weight from L2. Each consumer thread reads its A fragment (rows g
//    and g + 8, k = 2c, 2c + 1, 2c + 8, 2c + 9 of each 16-deep step) from
//    the int8 tile and widens it to bf16 in registers. The fragments are
//    double-buffered across slices, since `wgmma` reads its registers
//    after issue. The epilogue multiplies each channel by its scale,
//    rounds once, and stages the tile transposed ([token][channel],
//    16-byte chunks swizzled by token) in shared memory, then writes y
//    rows in 16-byte stores.
//  - fp32 x: real fp32 FMAs (64 x 64 tiles, 4 x 4 outputs a thread), as
//    the fp32 tolerance needs; the weight widens to fp32 in shared memory.

#include <stdint.h>

#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace {

using bf = __nv_bfloat16;

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

// d += a . b on one m16n8k16 tile: bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// bf16 x, m <= 16: split over k, the weight streamed into registers
// ---------------------------------------------------------------------------

namespace decode {

using namespace pt::hopper;

constexpr int WARPS = 4;
constexpr int NTH = 32 * WARPS;
constexpr int BN = 16 * WARPS;     // channels a block
constexpr int CK = 64;             // k of a step: 16 bytes a lane and row
constexpr int W = 256;             // bytes of a weight row a stage
constexpr int STAGES = 2;          // stages of a warp's ring
constexpr int ROW = W + 16;        // row stride: 16 bytes past 128 n
constexpr int STAGE = 16 * ROW;    // a warp's 16 rows
constexpr int RING = WARPS * STAGES * STAGE;
constexpr int BARS = WARPS * STAGES * 8;

// the weight's L2 policy: it is read once, so its lines go first and
// leave what else L2 holds (activations, KV pages, dirty lines) in place
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

// `bytes` from device memory into shared memory by the copy engine,
// completing on `bar`, under L2 policy `pol`
__device__ __forceinline__ void bulk_load_hint(void* dst, const void* src,
                                               uint32_t bytes, uint64_t* bar,
                                               uint64_t pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(pol)
      : "memory");
}

// shared memory of a block: the warps' rings, their mbarriers and the
// x slice (8 NT rows of `steps` CK elements, a row 16 bytes past a
// multiple of 128)
__host__ __device__ constexpr int smem_bytes(int nt, int steps) {
  return RING + BARS + nt * 8 * (steps * CK + 8) * 2;
}

// NT n8 tiles of tokens (m <= 8 NT). Block (tile, split) computes
// channels [64 tile, 64 tile + 64) over k [kps split, kps split + kps).
template <int NT>
__global__ void __launch_bounds__(NTH)
int8_decode_kernel(const bf* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, bf* __restrict__ y,
                   float* __restrict__ part, int* __restrict__ tickets,
                   int m, int n, int k, int kps) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int k0 = split * kps;
  const int kl = min(kps, k - k0);          // a multiple of 16
  const int steps = (kl + CK - 1) / CK;
  const int stages = (kl + W - 1) / W;
  const int ldx = steps * CK + 8;           // x row stride, elements
  const int ch = tile * BN + warp * 16;     // the warp's first channel
  const bool live = ch < n;                 // n is a multiple of 16
  unsigned char* ring = smem + warp * STAGES * STAGE;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + RING) + warp * STAGES;
  bf* xs = reinterpret_cast<bf*>(smem + RING + BARS);

  if (lane == 0)
    for (int st = 0; st < STAGES; ++st) mbar_init(&bar[st], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncwarp();
  // stage st of the warp's 16 rows: one bulk copy a row (lanes 0..15),
  // completing on the stage's mbarrier
  const uint64_t pol = l2_evict_first();
  auto issue = [&](int st) {
    if (!live || st >= stages) return;
    const int bytes = min(W, kl - st * W);
    uint64_t* b = &bar[st % STAGES];
    if (lane == 0) mbar_expect_tx(b, 16 * bytes);
    if (lane < 16)
      bulk_load_hint(ring + (st % STAGES) * STAGE + lane * ROW,
                     w + static_cast<size_t>(ch + lane) * k + k0 + st * W,
                     bytes, b, pol);
  };
#pragma unroll
  for (int st = 0; st < STAGES; ++st) issue(st);

  // the block's slice of x, 16 bytes a copy, zero past m and past kl
  const int pieces = steps * CK / 8;
  for (int v = tid; v < NT * 8 * pieces; v += NTH) {
    const int r = v / pieces, p = v - r * pieces;
    const bool ok = r < m && p * 8 < kl;
    pt::cp_async16(xs + r * ldx + p * 8,
                   ok ? x + static_cast<size_t>(r) * k + k0 + p * 8 : x, ok);
  }
  pt::cp_async_commit();
  pt::cp_async_wait<0>();
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  const bf* xr = xs + g * ldx + 16 * c;     // token g, k 16c .. 16c + 15
  for (int st = 0; live && st < stages; ++st) {
    mbar_wait(&bar[st % STAGES], (st / STAGES) & 1);
    const unsigned char* ra = ring + (st % STAGES) * STAGE + g * ROW + 16 * c;
    const int used = min(W, kl - st * W);
#pragma unroll
    for (int u = 0; u < W / CK; ++u) {
      if (u * CK >= used) break;
      // bytes past the slice are stale or never written: finite int8
      // values, multiplied by x's zeros
      const uint4 qa = *reinterpret_cast<const uint4*>(ra + u * CK);
      const uint4 qb = *reinterpret_cast<const uint4*>(ra + 8 * ROW + u * CK);
      const uint32_t wa[4] = {qa.x, qa.y, qa.z, qa.w};
      const uint32_t wb[4] = {qb.x, qb.y, qb.z, qb.w};
      uint32_t a[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        widen(wa[j], a[j][0], a[j][2]);   // row g: k 2c, 2c+1 | 2c+8, 2c+9
        widen(wb[j], a[j][1], a[j][3]);   // row g + 8
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const bf* p = xr + t * 8 * ldx + st * W + u * CK;
        const uint4 x0 = *reinterpret_cast<const uint4*>(p);
        const uint4 x1 = *reinterpret_cast<const uint4*>(p + 8);
        mma_bf16(acc[t], a[0], x0.x, x0.y);
        mma_bf16(acc[t], a[1], x0.z, x0.w);
        mma_bf16(acc[t], a[2], x1.x, x1.y);
        mma_bf16(acc[t], a[3], x1.z, x1.w);
      }
    }
    __syncwarp();   // every lane has read the stage: refill it
    issue(st + STAGES);
  }

  // acc[t]: channel ch + g, tokens 8t + 2c, 8t + 2c + 1 (0, 1) and
  // channel ch + g + 8 (2, 3); the scale on the sum, rounded once
  auto store = [&](const float (&v)[NT][4]) {
    if (!live) return;
    const float s0 = scale[ch + g], s1 = scale[ch + g + 8];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tok = 8 * t + 2 * c + e;
        if (tok < m) {
          bf* row = y + static_cast<size_t>(tok) * n + ch + g;
          row[0] = __float2bfloat16(v[t][e] * s0);
          row[8] = __float2bfloat16(v[t][2 + e] * s1);
        }
      }
  };
  if (splits == 1) {
    store(acc);
    return;
  }
  // partials in fragment order: [tile][split][warp][t][lane] float4
  const size_t per_split = static_cast<size_t>(WARPS) * NT * 32;
  float4* base = reinterpret_cast<float4*>(part) +
                 static_cast<size_t>(tile) * splits * per_split +
                 (warp * NT) * 32 + lane;
#pragma unroll
  for (int t = 0; t < NT; ++t)
    base[split * per_split + t * 32] =
        make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
  // the last split of the tile to finish merges: each thread's partials
  // are fenced, the block's barrier orders them before thread 0's
  // acquire-release ticket, and the merging block's reads after it
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(tickets + tile)
                 : "memory");
    s_last = prev == splits - 1;
  }
  __syncthreads();
  if (!s_last) return;
  if (tid == 0) tickets[tile] = 0;
  float sum[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const float4 v = __ldcg(base + t * 32);
    sum[t][0] = v.x;
    sum[t][1] = v.y;
    sum[t][2] = v.z;
    sum[t][3] = v.w;
  }
#pragma unroll 4
  for (int sp = 1; sp < splits; ++sp)
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float4 v = __ldcg(base + sp * per_split + t * 32);
      sum[t][0] += v.x;
      sum[t][1] += v.y;
      sum[t][2] += v.z;
      sum[t][3] += v.w;
    }
  store(sum);
}

template <int NT>
int launch(const void* x, const void* wq, const float* scale, void* y,
           float* part, int* tickets, int m, int n, int k, int kps,
           cudaStream_t stream) {
  if (kps <= 0 || kps % 16) return cudaErrorInvalidValue;
  const int splits = (k + kps - 1) / kps;
  if (splits > 65535 || (splits > 1 && (part == nullptr ||
                                        tickets == nullptr)))
    return cudaErrorInvalidValue;
  const int smem = smem_bytes(NT, ((kps < k ? kps : k) + CK - 1) / CK);
  if (smem > pt::wg::SMEM_MAX - 1024) return cudaErrorInvalidValue;
  auto kernel = int8_decode_kernel<NT>;
  // the attributes once a device (for the largest slice so far)
  static int ready_smem[32] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (ready_smem[dev] < smem) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    ready_smem[dev] = smem;
  }
  const dim3 grid((n + BN - 1) / BN, splits);
  kernel<<<grid, NTH, smem, stream>>>(
      static_cast<const bf*>(x), static_cast<const int8_t*>(wq), scale,
      static_cast<bf*>(y), part, tickets, m, n, k, kps);
  return cudaGetLastError();
}

}  // namespace decode

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

// `route`: 0 fp32 x (FMAs), 1 bf16 x on the split-k decode kernel (m <=
// 16), 2 bf16 x on TMA + `wgmma` (the wrapper takes 1 for m <= 16, else
// 2). kps: route 1's k a split (a multiple of 16; splits = ceil(k / kps)),
// ignored otherwise. part: route 1's fp32 workspace of ceil(n / 64) x
// splits x 512 x ceil(m / 8) floats when splits > 1; tickets: int32
// [ceil(n / 64)], zero (the kernel leaves them zero).
extern "C" int pt_int8_matmul(const void* x, const void* wq,
                              const void* scale, void* y, void* part,
                              void* tickets, int m, int n, int k, int route,
                              int kps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (m < 1 || n < 16 || k < 16 || n % 16 || k % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 2) return prefill::launch_any(x, wq, sc, y, m, n, k, s);
  if (route == 1) {
    if (m > 16) return static_cast<int>(cudaErrorInvalidValue);
    float* pf = static_cast<float*>(part);
    int* tk = static_cast<int*>(tickets);
    return m <= 8 ? decode::launch<1>(x, wq, sc, y, pf, tk, m, n, k, kps, s)
                  : decode::launch<2>(x, wq, sc, y, pf, tk, m, n, k, kps, s);
  }
  if (route == 0) {
    const dim3 grid((n + F_BN - 1) / F_BN, (m + F_BM - 1) / F_BM);
    int8_mm_f32_kernel<<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(wq), sc,
        static_cast<float*>(y), m, n, k);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
