// A TMA + `wgmma` GEMM mainloop for Hopper (sm_90a), bf16 operands and
// fp32 accumulators, shared by the fused vocab-CE forward, the CE
// backward's three products and the grouped matmul's forward, dx and dW.
// C = A . B, A(m, k) and B(k, n) each K-major (k contiguous) or MN-major
// (m or n contiguous), as the template says; the caller's epilogue
// functor takes the accumulator fragment in registers and writes what it
// wants (nothing goes through a shared-memory fp32 tile).
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
//   - persistent: min(tiles, SMs) blocks walk the tiles of a scheduler,
//     and the producer runs ahead into the next tile's slices while the
//     consumers write the last one;
//   - operands come from tensor maps over whole row-major matrices; TMA
//     fills what lies outside them with zeros, so ragged M, N and K need
//     masking only in the epilogue.
// The epilogue stores from registers, or (Store below) stages a bf16 tile
// in shared memory and stores it by TMA while the next tile runs.
// The scheduler (a template parameter) says which tiles there are, where
// each one's slices come from and how many it has: `Dense` walks one
// product in a raster that keeps GROUP row tiles of one column tile
// together in L2; the grouped matmul's schedulers (grouped_matmul.cu)
// read the runs' offsets on the device into a table in shared memory at
// block start. A scheduler whose contraction runs over a ragged range of
// rows (RAGGED_K, MN-major A and B) has the consumers zero the rows of a
// slice past the range before its products.
// Shared-memory layout of a slice: A is [128 rows][64 k] (K-major, one box)
// or two panels of [64 k][64 m] (MN-major, one box each); B is
// [256 rows][64 k] (K-major, one box) or four panels of [64 k][64 n]
// (MN-major). A row of every box is 128 bytes, one swizzle atom.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include <type_traits>

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
constexpr int SMEM_MAX = 232448;          // a block's limit on sm_90
// a TMA-store epilogue's staging: per consumer warpgroup half its
// 64 x 256 bf16 tile, two [64][64] boxes in the 128-byte swizzle
constexpr int STAGING = 2 * 2 * PANEL;

// How an epilogue stores the accumulator (its member STORE; PAIRS if it
// has none): PAIRS calls pair() with two columns a lane; QUADS calls
// quad() with four bf16 columns a lane (8 bytes: whole 32-byte sectors a
// row and store), after an exchange within each quad of lanes; TMA
// stages the tile as bf16 in shared memory and calls store_box() to
// store each [64][64] box by TMA, asynchronously, so the next tile's
// products start at once; ROWS hands row_frag() a lane's whole share of
// a row (64 fp32 values, the other 192 columns in the three other lanes
// of its quad) to reduce in registers.
enum Store { PAIRS = 0, QUADS = 1, TMA = 2, ROWS = 3 };
template <class E, class = void>
struct store_of {
  static constexpr int value = PAIRS;
};
template <class E>
struct store_of<E, std::void_t<decltype(E::STORE)>> {
  static constexpr int value = E::STORE;
};

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

// One output tile: rows m0.., columns n0.., nk slices of BK. The grouped
// schedulers also say which run (expert) it is and the rows [lo, hi) that
// bound it: the forward's output rows, dW's contraction rows.
struct Tile {
  int m0, n0, nk;
  int run, lo, hi;
};

// One product C [M, N] = A . B over K; boff is added to B's contiguous
// coordinate (a column offset).
struct Dense {
  int M, N, K;
  int tiles_m, tiles_n;
  int boff;
  static constexpr bool RAGGED_K = false;

  __host__ __device__ int table_bytes() const { return 0; }
  __device__ void setup(int*, unsigned char*) const {}
  __device__ int count(const int*) const { return tiles_m * tiles_n; }
  __device__ Tile tile(const int*, int id) const {
    int tm, tn;
    raster(id, tiles_m, tiles_n, tm, tn);
    return {tm * BM, tn * BN, (K + BK - 1) / BK, 0, 0, 0};
  }
  template <bool A_MN, bool B_MN>
  __device__ void load(const Tile& t, int kt, const CUtensorMap* ta,
                       const CUtensorMap* tb, unsigned char* sa,
                       unsigned char* sb, uint64_t* bar) const {
    const int k0 = kt * BK;
    if (A_MN) {
      tma_load2(sa, ta, bar, t.m0, k0);
      tma_load2(sa + PANEL, ta, bar, t.m0 + 64, k0);
    } else {
      tma_load2(sa, ta, bar, k0, t.m0);
    }
    if (B_MN) {
#pragma unroll
      for (int p = 0; p < BN / 64; ++p)
        tma_load2(sb + p * PANEL, tb, bar, boff + t.n0 + 64 * p, k0);
    } else {
      tma_load2(sb, tb, bar, boff + k0, t.n0);
    }
  }
};

// The accumulator fragment of a consumer warpgroup's 64 x 256 tile: thread
// t (warp w = t / 32, lane) holds, for i in {0, 1} and c in 0 .. 31, the
// pair acc[4 c + 2 i], acc[4 c + 2 i + 1] at row 16 w + lane / 4 + 8 i,
// columns 8 c + 2 (lane % 4) + {0, 1}. The epilogue functor gives per
// row `row(tile, r)` (a state with `ok`), per pair of columns an
// `addend(state, col)` to add (a float2; every one of a row is read
// before the first pair is stored, so the reads of the row are in flight
// together), and stores a pair with `pair(state, col, x0, x1)`; a QUADS
// epilogue stores four bf16 columns with `quad(state, col, v)` instead.
// A ROWS epilogue gets `row_frag(tile, r, c0, x)` for each of the lane's
// two rows, x[2 c + e] at column c0 + 8 c + e (c < 32, e < 2); every lane
// calls it, whether or not row r exists, so it may shuffle within a quad.
template <class Epi>
__device__ __forceinline__ void store_tile(const Epi& epi, const Tile& t,
                                           const float (&acc)[ACC], int r0,
                                           int c0) {
  if constexpr (store_of<Epi>::value == ROWS) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x[BN / 4];
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        x[2 * c] = acc[4 * c + 2 * i];
        x[2 * c + 1] = acc[4 * c + 2 * i + 1];
      }
      epi.row_frag(t, r0 + 8 * i, c0, x);
    }
  } else if constexpr (store_of<Epi>::value == QUADS) {
    // lane c of a quad holds pair c of column groups j and j + 1 (a, b);
    // two exchanges give lane c columns 8 j + 4 c .. + 3: lanes 0, 1 the
    // pairs of group j, lanes 2, 3 those of group j + 1
    const int c = threadIdx.x & 3;
    const bool lo2 = c < 2, odd = c & 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const typename Epi::Row row = epi.row(t, r0 + 8 * i);
#pragma unroll
      for (int j = 0; j < BN / 8; j += 2) {
        const uint32_t a =
            pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        const uint32_t b =
            pack_bf16(acc[4 * j + 4 + 2 * i], acc[4 * j + 4 + 2 * i + 1]);
        const uint32_t got = __shfl_xor_sync(0xffffffffu, lo2 ? b : a, 2);
        const uint32_t lo = lo2 ? a : got, hi = lo2 ? got : b;
        const uint32_t got2 = __shfl_xor_sync(0xffffffffu, odd ? lo : hi, 1);
        if (row.ok)
          epi.quad(row, c0 - 2 * c + 8 * j + 4 * c,
                   odd ? make_uint2(got2, hi) : make_uint2(lo, got2));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const typename Epi::Row row = epi.row(t, r0 + 8 * i);
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
}

// A TMA epilogue: consumer warpgroup w (thread t of 128) stages its
// 64 x 256 tile as bf16 in two halves of 128 columns through `stage`
// (two [64][64] boxes in the 128-byte swizzle, conflict-free writes), and
// thread 0 stores each box by TMA. A half waits only until the last
// stores from `stage` have read it.
template <class Epi>
__device__ __forceinline__ void store_tile_tma(const Epi& epi,
                                               const CUtensorMap* tc,
                                               const Tile& tl,
                                               const float (&acc)[ACC],
                                               unsigned char* stage, int w,
                                               int t) {
  const int g = (t & 31) >> 2, c = t & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (t == 0) bulk_wait<0, true>();
    named_sync(2 + w, 128);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * (t >> 5) + g + 8 * i;  // row of the 64; r % 8 = g
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int cc = 16 * h + q;
        *reinterpret_cast<uint32_t*>(stage + (q >> 3) * PANEL + r * 128 +
                                     (((q & 7) ^ g) << 4) + 4 * c) =
            pack_bf16(acc[4 * cc + 2 * i], acc[4 * cc + 2 * i + 1]);
      }
    }
    fence_async_shared();
    named_sync(2 + w, 128);
    if (t == 0) {
      epi.store_box(tc, stage, tl, tl.m0 + 64 * w, tl.n0 + 128 * h);
      epi.store_box(tc, stage + PANEL, tl, tl.m0 + 64 * w,
                    tl.n0 + 128 * h + 64);
      bulk_commit();
    }
  }
}

// rows [from, 64) of `panels` consecutive [64 k][64] MN-major panels set
// to 0 by the 128 threads of a warpgroup (thread t): whole 128-byte rows,
// which the swizzle permutes only within themselves
__device__ __forceinline__ void zero_panel_rows(unsigned char* p, int panels,
                                               int from, int t) {
  const int per = (64 - from) * 8;  // 16-byte words of one panel
  for (int i = t; i < panels * per; i += 128) {
    const int q = i / per, j = i % per;
    *reinterpret_cast<uint4*>(p + q * PANEL + from * 128 + j * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// tc: the output's tensor map, read by TMA epilogues only
template <bool A_MN, bool B_MN, class Sched, class Epi>
__global__ void __launch_bounds__(NTH, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tc, const Sched sched,
                const Epi epi) {
  static_assert(!Sched::RAGGED_K || (A_MN && B_MN),
                "a ragged contraction needs MN-major A and B");
  constexpr bool TMA_OUT = store_of<Epi>::value == TMA;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* staging = sm + STAGES * STAGE;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(staging + (TMA_OUT ? STAGING : 0));
  uint64_t* empty = full + STAGES;
  int* table = reinterpret_cast<int*>(empty + STAGES);

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // (the ring is the scheduler's scratch until the producer starts)
  sched.setup(table, sm);
  __syncthreads();
  const int tiles = sched.count(table);

  const int w = threadIdx.x / 128;
  if (w == 2) {
    // producer: every slice of every tile of this block, through the ring
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int id = blockIdx.x; id < tiles; id += gridDim.x) {
        const Tile t = sched.tile(table, id);
        for (int kt = 0; kt < t.nk; ++kt, ++it) {
          const int st = it % STAGES;
          mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
          unsigned char* sa = sm + st * STAGE;
          mbar_expect_tx(&full[st], STAGE);
          sched.template load<A_MN, B_MN>(t, kt, &ta, &tb, sa, sa + A_BYTES,
                                          &full[st]);
        }
      }
    }
  } else {
    // consumers: warpgroup w owns rows m0 + 64 w .. + 63 of each tile
    setmaxnreg_inc<232>();
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    float acc[ACC];
    int it = 0;
    for (int id = blockIdx.x; id < tiles; id += gridDim.x) {
      const Tile tl = sched.tile(table, id);
#pragma unroll
      for (int j = 0; j < ACC; ++j) acc[j] = 0.f;
      for (int kt = 0; kt < tl.nk; ++kt, ++it) {
        const int st = it % STAGES;
        mbar_wait(&full[st], (it / STAGES) & 1);
        unsigned char* sa = sm + st * STAGE;
        unsigned char* sb = sa + A_BYTES;
        if constexpr (Sched::RAGGED_K) {
          // the slice's rows past the contraction range belong to another
          // run: zero them (A panel w, B panels 2 w and 2 w + 1), make the
          // writes visible to `wgmma`, and wait for the other warpgroup's
          const int valid = sched.valid_k(tl, kt);
          if (valid < BK) {
            zero_panel_rows(sa + w * PANEL, 1, valid, t);
            zero_panel_rows(sb + 2 * w * PANEL, 2, valid, t);
            fence_async_shared();
            named_sync(1, 256);
          }
        }
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
      if (tl.nk > 0 && t == 0)
        mbar_arrive(&empty[(it + STAGES - 1) % STAGES]);
      if constexpr (TMA_OUT)
        store_tile_tma(epi, &tc, tl, acc, staging + w * (STAGING / 2), w, t);
      else
        store_tile(epi, tl, acc, tl.m0 + 64 * w + 16 * warp + (lane >> 2),
                   tl.n0 + 2 * (lane & 3));
    }
    // the last stores have left shared memory before the block ends
    if (TMA_OUT && t == 0) bulk_wait<0, false>();
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

// the same over `depth` contiguous row-major matrices [rows, cols] (a
// batch, such as the experts' weights [g, rows, cols]), read a box of one
// matrix at a time: TMA's zero fill ends each at its own edges
inline bool map_bf16_3d(CUtensorMap* m, const void* base, int cols, int rows,
                        int depth, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * 2,
      static_cast<cuuint64_t>(cols) * static_cast<cuuint64_t>(rows) * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch the mainloop over the scheduler's tiles: min(max_tiles, SMs)
// persistent blocks, with a TMA epilogue's staging and the scheduler's
// table after the ring. max_tiles bounds the tiles from above where only
// the device knows their count; tc is the output's tensor map (read by a
// TMA epilogue only).
template <bool A_MN, bool B_MN, class Sched, class Epi>
int launch(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tc,
           const Sched& sched, const Epi& epi, long long max_tiles,
           cudaStream_t stream) {
  if (max_tiles <= 0) return cudaSuccess;
  const int smem = SMEM + (store_of<Epi>::value == TMA ? STAGING : 0) +
                   sched.table_bytes();
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gemm_kernel<A_MN, B_MN, Sched, Epi>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return e;
  const int grid = max_tiles < sms ? static_cast<int>(max_tiles) : sms;
  gemm_kernel<A_MN, B_MN, Sched, Epi>
      <<<grid, NTH, smem, stream>>>(ta, tb, tc, sched, epi);
  return cudaGetLastError();
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
  const Dense s = {M, N, K, (M + BM - 1) / BM, (N + BN - 1) / BN, boff};
  return launch<A_MN, B_MN>(ta, tb, CUtensorMap{}, s, epi,
                            static_cast<long long>(s.tiles_m) * s.tiles_n,
                            stream);
}

}  // namespace wg
}  // namespace pt
