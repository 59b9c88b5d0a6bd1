// A TMA + `wgmma` GEMM mainloop for Hopper (sm_90a), bf16 operands and
// fp32 accumulators, shared by the fused vocab-CE backward's three
// products. C = A . B, A(m, k) and B(k, n) each K-major (k contiguous) or
// MN-major (m or n contiguous), as the template says; the caller's
// epilogue functor takes the accumulator fragment in registers and writes
// what it wants (nothing goes through a shared-memory fp32 tile).
//
// Design (the shape of CUTLASS's warp-specialised Hopper GEMM):
//   - 128 x 256 output tiles, 64-deep k-slices;
//   - 384 threads: warpgroups 0 and 1 consume (`setmaxnreg` 232), each
//     computing 64 rows x 256 columns with `wgmma` m64n256k16 from shared
//     memory into 128 fp32 registers a thread; warpgroup 2 produces
//     (`setmaxnreg` 40), one thread issuing every TMA copy;
//   - a ring of STAGES = 4 slices, (128 + 256) x 64 bf16 = 48 KB each, in
//     the 128-byte swizzle that the `wgmma` descriptors read in place;
//     mbarriers carry completion (full) and release (empty, one arrival a
//     consumer warpgroup);
//   - persistent: min(tiles, SMs) blocks walk the tiles in a raster that
//     keeps GROUP row tiles of one column tile together in L2, and the
//     producer runs ahead into the next tile's slices while the consumers
//     write the last one;
//   - operands come from 2-D tensor maps over the whole row-major
//     matrices; TMA fills what lies outside them with zeros, so ragged M,
//     N and K need masking only in the epilogue.
// Shared-memory layout of a slice: A is [128 rows][64 k] (K-major, one box)
// or two panels of [64 k][64 m] (MN-major, one box each); B is
// [256 rows][64 k] (K-major, one box) or four panels of [64 k][64 n]
// (MN-major). A row of every box is 128 bytes, one swizzle atom.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "hopper.cuh"

namespace pt {
namespace wg {

using namespace pt::hopper;

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int NTH = 384;                  // 2 consumer warpgroups, 1 producer
constexpr int PANEL = 64 * 128;           // one [64][64] bf16 box, bytes
constexpr int A_BYTES = BM * BK * 2;      // 16 KB
constexpr int B_BYTES = BN * BK * 2;      // 32 KB
constexpr int STAGE = A_BYTES + B_BYTES;  // 48 KB
constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
constexpr int ACC = BN / 2;               // fp32 accumulators a thread

// Output tile (tm, tn) of tile index id: consecutive ids walk down GROUP
// row tiles of one column tile before moving right, so the tiles in
// flight together share their A rows and B columns in L2.
__host__ __device__ __forceinline__ void raster(int id, int tiles_m,
                                                int tiles_n, int& tm,
                                                int& tn) {
  constexpr int GROUP = 8;
  const int per_group = GROUP * tiles_n;
  const int first = (id / per_group) * GROUP;
  const int gm = tiles_m - first < GROUP ? tiles_m - first : GROUP;
  tm = first + (id % per_group) % gm;
  tn = (id % per_group) / gm;
}

// d[64 x 256] (+)= A . B, both from shared memory (descriptors); TA / TB
// set the transpose bits (1: MN-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[ACC], uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
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
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

// descriptors of k-step kk (16 deep) of a slice, for consumer warpgroup w
template <bool MN>
__device__ __forceinline__ uint64_t a_desc(const unsigned char* sa, int w,
                                           int kk) {
  // MN-major: panel w is this warpgroup's 64 rows, one atom wide
  return MN ? gdesc(sa + w * PANEL + kk * 16 * 128, 1024, 1024, 1)
            : gdesc(sa + w * 64 * 128 + kk * 32, 16, 1024, 1);
}
template <bool MN>
__device__ __forceinline__ uint64_t b_desc(const unsigned char* sb, int kk) {
  // MN-major: four atoms of 64 columns, PANEL bytes apart
  return MN ? gdesc(sb + kk * 16 * 128, PANEL, 1024, 1)
            : gdesc(sb + kk * 32, 16, 1024, 1);
}

struct Shape {
  int M, N, K;
  int tiles_m, tiles_n;
  int boff;  // added to B's contiguous coordinate (a column offset)
};

// The accumulator fragment of a consumer warpgroup's 64 x 256 tile: thread
// t (warp w = t / 32, lane) holds, for i in {0, 1} and c in 0 .. 31, the
// pair acc[4 c + 2 i], acc[4 c + 2 i + 1] at row 16 w + lane / 4 + 8 i,
// columns 8 c + 2 (lane % 4) + {0, 1}. The epilogue functor gives per
// row `row(r)` (a state with `ok`), per pair of columns an `addend(state,
// col)` to add (a float2; every one of a row is read before the first
// pair is stored, so the reads of the row are in flight together), and
// stores a pair with `pair(state, col, x0, x1)`.
template <class Epi>
__device__ __forceinline__ void store_tile(const Epi& epi,
                                           const float (&acc)[ACC], int r0,
                                           int c0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const typename Epi::Row row = epi.row(r0 + 8 * i);
    if (!row.ok) continue;
    float2 add[BN / 8];
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) add[c] = epi.addend(row, c0 + 8 * c);
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
      epi.pair(row, c0 + 8 * c, acc[4 * c + 2 * i] + add[c].x,
               acc[4 * c + 2 * i + 1] + add[c].y);
  }
}

template <bool A_MN, bool B_MN, class Epi>
__global__ void __launch_bounds__(NTH, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb, const Shape s,
                const Epi epi) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int tiles = s.tiles_m * s.tiles_n;
  const int nk = (s.K + BK - 1) / BK;

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
    // producer: every slice of every tile of this block, through the ring
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int tm, tn;
        raster(tile, s.tiles_m, s.tiles_n, tm, tn);
        const int m0 = tm * BM, n0 = tn * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int st = it % STAGES;
          mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
          unsigned char* sa = sm + st * STAGE;
          unsigned char* sb = sa + A_BYTES;
          const int k0 = kt * BK;
          mbar_expect_tx(&full[st], STAGE);
          if (A_MN) {
            tma_load2(sa, &ta, &full[st], m0, k0);
            tma_load2(sa + PANEL, &ta, &full[st], m0 + 64, k0);
          } else {
            tma_load2(sa, &ta, &full[st], k0, m0);
          }
          if (B_MN) {
#pragma unroll
            for (int p = 0; p < BN / 64; ++p)
              tma_load2(sb + p * PANEL, &tb, &full[st], s.boff + n0 + 64 * p,
                        k0);
          } else {
            tma_load2(sb, &tb, &full[st], s.boff + k0, n0);
          }
        }
      }
    }
  } else {
    // consumers: warpgroup w owns rows m0 + 64 w .. + 63 of each tile
    setmaxnreg_inc<232>();
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    float acc[ACC];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int tm, tn;
      raster(tile, s.tiles_m, s.tiles_n, tm, tn);
#pragma unroll
      for (int j = 0; j < ACC; ++j) acc[j] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int st = it % STAGES;
        mbar_wait(&full[st], (it / STAGES) & 1);
        const unsigned char* sa = sm + st * STAGE;
        const unsigned char* sb = sa + A_BYTES;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss_n256<A_MN, B_MN>(acc, a_desc<A_MN>(sa, w, kk),
                                    b_desc<B_MN>(sb, kk), 1);
        wg_commit();
        // the previous slice's products are done: its stage is free
        wg_wait<1>();
        if (kt > 0 && t == 0) mbar_arrive(&empty[(it + STAGES - 1) % STAGES]);
      }
      wg_wait<0>();
      keep(acc);
      if (nk > 0 && t == 0) mbar_arrive(&empty[(it + STAGES - 1) % STAGES]);
      store_tile(epi, acc, tm * BM + 64 * w + 16 * warp + (lane >> 2),
                 tn * BN + 2 * (lane & 3));
    }
  }
}

// A row-major bf16 matrix [rows, cols] with a row stride of ld elements
struct Operand {
  const void* base;
  int cols, rows;
  long long ld;
};

// its tensor map, read in boxes of 64 columns (128 bytes) by box_rows rows
// in the 128-byte swizzle; boxes reaching outside it are filled with 0
inline bool map_bf16(CUtensorMap* m, const Operand& o, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(o.cols),
                              static_cast<cuuint64_t>(o.rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(o.ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(o.base),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// C [M, N] = A [M, K] . B [K, N] into `epi`. A is K-major (storage a =
// [M rows, K cols]) or, with A_MN, MN-major (a = [K rows, M cols]); B is
// K-major (b = [N rows, K cols]) or, with B_MN, MN-major (b = [K rows,
// N cols]); boff is added to B's column coordinate. Returns a CUDA error
// code, or MAP_REFUSED (+ 1 for B) when a tensor map is refused.
template <bool A_MN, bool B_MN, class Epi>
int gemm(const Operand& a, const Operand& b, int M, int N, int K, int boff,
         const Epi& epi, cudaStream_t stream) {
  CUtensorMap ta, tb;
  if (!map_bf16(&ta, a, A_MN ? 64 : BM)) return MAP_REFUSED;
  if (!map_bf16(&tb, b, B_MN ? 64 : BN)) return MAP_REFUSED + 1;
  const Shape s = {M, N, K, (M + BM - 1) / BM, (N + BN - 1) / BN, boff};
  const int tiles = s.tiles_m * s.tiles_n;
  if (tiles == 0) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gemm_kernel<A_MN, B_MN, Epi>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (e != cudaSuccess) return e;
  const int grid = tiles < sms ? tiles : sms;
  gemm_kernel<A_MN, B_MN, Epi><<<grid, NTH, SMEM, stream>>>(ta, tb, s, epi);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace pt
