// One block tile of a matrix product, shared by the port's GEMM-shaped
// kernels (the fused vocab-CE head's fp32 route and the grouped matmul's
// fp32 and odd-width routes): C = A . B for a BM x BN tile, left in
// shared memory as fp32 Cs[BM][LDC] for the caller's own epilogue. bf16
// runs on the tensor cores (ldmatrix + mma.sync m16n8k16, fp32
// accumulators, a 4-stage cp.async ring), fp32 as real fp32 FMAs. Blocks are NT = 256 threads. `GemmOf<T, AR, BR>::type`
// picks the tile for the element type T; AR / BR say whether A(m, k) and
// B(k, n) are row-major (their second index contiguous).
#pragma once

#include "common.cuh"

namespace pt {
namespace tile {

constexpr int NT = 256;  // threads per block
using bf = __nv_bfloat16;

// rows r0.. (stride ld) by contiguous columns c0.. of a [RL, CL] matrix
// into dst[ROWS][LD], 0 outside it: 16-byte copies when `vec` (the caller
// has checked CL, ld and the base for multiples of 8 elements), else one
// element at a time
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void stage_tile(bf* dst, const bf* src,
                                           long long ld, int r0, int c0,
                                           int RL, int CL, bool vec) {
  if (vec) {
    for (int v = threadIdx.x; v < ROWS * COLS / 8; v += NT) {
      const int r = v / (COLS / 8), c = (v % (COLS / 8)) * 8;
      const bool ok = r0 + r < RL && c0 + c < CL;
      cp_async16(dst + r * LD + c,
                 ok ? src + static_cast<long long>(r0 + r) * ld + c0 + c
                    : src,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      dst[r * LD + c] =
          r0 + r < RL && c0 + c < CL
              ? src[static_cast<long long>(r0 + r) * ld + c0 + c]
              : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
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

// One block tile of C = A . B on the tensor cores, left in shared memory
// as fp32 Cs[BM][LDC] (aliasing the operand ring). A(m, k) is row-major
// (k contiguous) when AR, else column-major; B(k, n) is row-major (n
// contiguous) when BR, else column-major. Warp w computes the 64 x 64
// patch at rows 64 (w / 4), columns 64 (w % 4): per 16-deep step, four
// A and four B fragment loads (ldmatrix, transposed where the tile's
// contiguous dimension is not the fragment's) feed 32 m16n8k16 MMAs.
template <bool AR, bool BR>
struct TcGemm {
  static constexpr int BM = 128, BN = 256, BK = 32, STAGES = 4;
  static constexpr int LDA = AR ? BK + 8 : BM + 8;
  static constexpr int LDB = BR ? BN + 8 : BK + 8;
  static constexpr int A_ELEMS = AR ? BM * LDA : BK * LDA;
  static constexpr int B_ELEMS = BR ? BK * LDB : BN * LDB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr int LDC = BN + 4;
  static constexpr size_t PIPE_BYTES = size_t(STAGES) * STAGE * 2;
  static constexpr size_t C_BYTES = size_t(BM) * LDC * 4;
  static constexpr size_t SMEM = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;

  static __device__ __forceinline__ void load(bf* st, const bf* A,
                                              long long lda, const bf* B,
                                              long long ldb, int M, int N,
                                              int K, int m0, int n0, int k0,
                                              bool vec) {
    bf* As = st;
    bf* Bs = st + A_ELEMS;
    if (AR)
      stage_tile<BM, BK, LDA>(As, A, lda, m0, k0, M, K, vec);
    else
      stage_tile<BK, BM, LDA>(As, A, lda, k0, m0, K, M, vec);
    if (BR)
      stage_tile<BK, BN, LDB>(Bs, B, ldb, k0, n0, K, N, vec);
    else
      stage_tile<BN, BK, LDB>(Bs, B, ldb, n0, k0, N, K, vec);
  }

  static __device__ void run(const bf* A, long long lda, const bf* B,
                             long long ldb, int M, int N, int K, int m0,
                             int n0, bool vec, unsigned char* smem) {
    bf* pipe = reinterpret_cast<bf*>(smem);
    float* Cs = reinterpret_cast<float*>(smem);
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int wm = (w >> 2) * 64, wn = (w & 3) * 64;
    const int q = lane >> 3, l8 = lane & 7;
    float acc[4][8][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    const int KT = (K + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < KT) load(pipe + s * STAGE, A, lda, B, ldb, M, N, K, m0, n0,
                       s * BK, vec);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // slice kt landed; slice kt - 1's stage is free
      const bf* As = pipe + (kt % STAGES) * STAGE;
      const bf* Bs = As + A_ELEMS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        unsigned a[4][4], b[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // matrices (m 0-7 | 8-15) x (k 0-7 | 8-15), m fastest
          if (AR)
            ldsm_x4(a[i], As + (wm + i * 16 + (q & 1) * 8 + l8) * LDA + kk +
                              (q >> 1) * 8);
          else
            ldsm_x4_t(a[i], As + (kk + (q >> 1) * 8 + l8) * LDA + wm +
                                i * 16 + (q & 1) * 8);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // matrices (k 0-7 | 8-15) x (n 0-7 | 8-15), k fastest: the two
          // k halves of n-tiles 2j and 2j + 1
          if (BR)
            ldsm_x4_t(b[j], Bs + (kk + (q & 1) * 8 + l8) * LDB + wn +
                                j * 16 + (q >> 1) * 8);
          else
            ldsm_x4(b[j], Bs + (wn + j * 16 + (q >> 1) * 8 + l8) * LDB + kk +
                              (q & 1) * 8);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mma_bf16(acc[i][2 * j], a[i], b[j][0], b[j][1]);
            mma_bf16(acc[i][2 * j + 1], a[i], b[j][2], b[j][3]);
          }
      }
      const int nk = kt + STAGES - 1;
      if (nk < KT) load(pipe + (nk % STAGES) * STAGE, A, lda, B, ldb, M, N,
                        K, m0, n0, nk * BK, vec);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring that Cs aliases
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* c = Cs + (wm + i * 16 + g) * LDC + wn + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(c) = make_float2(acc[i][j][0],
                                                    acc[i][j][1]);
        *reinterpret_cast<float2*>(c + 8 * LDC) =
            make_float2(acc[i][j][2], acc[i][j][3]);
      }
    __syncthreads();
  }
};

// The same tile in fp32 FMAs (no TF32): As[k][m] and Bs[k][n] staged from
// either layout, thread (ty, tx) owns rows ty + 16 i and columns
// tx + 16 j of the 64 x 64 tile.
template <bool AR, bool BR>
struct FmaGemm {
  static constexpr int BM = 64, BN = 64, BK = 16;
  static constexpr int LDS = BM + 4;
  static constexpr int LDC = BN + 4;
  static constexpr size_t PIPE_BYTES = size_t(2) * BK * LDS * 4;
  static constexpr size_t C_BYTES = size_t(BM) * LDC * 4;
  static constexpr size_t SMEM = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;

  static __device__ void run(const float* A, long long lda, const float* B,
                             long long ldb, int M, int N, int K, int m0,
                             int n0, bool, unsigned char* smem) {
    float* As = reinterpret_cast<float*>(smem);
    float* Bs = As + BK * LDS;
    float* Cs = reinterpret_cast<float*>(smem);
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += BK) {
      __syncthreads();  // the previous slice is consumed
      for (int i = threadIdx.x; i < BM * BK; i += NT) {
        int m, k;
        long long at;
        if (AR) {
          m = i / BK, k = i % BK;
          at = static_cast<long long>(m0 + m) * lda + k0 + k;
        } else {
          k = i / BM, m = i % BM;
          at = static_cast<long long>(k0 + k) * lda + m0 + m;
        }
        As[k * LDS + m] = m0 + m < M && k0 + k < K ? A[at] : 0.f;
      }
      for (int i = threadIdx.x; i < BN * BK; i += NT) {
        int n, k;
        long long at;
        if (BR) {
          k = i / BN, n = i % BN;
          at = static_cast<long long>(k0 + k) * ldb + n0 + n;
        } else {
          n = i / BK, k = i % BK;
          at = static_cast<long long>(n0 + n) * ldb + k0 + k;
        }
        Bs[k * LDS + n] = n0 + n < N && k0 + k < K ? B[at] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[k * LDS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[k * LDS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Cs[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
    __syncthreads();
  }
};

template <typename T, bool AR, bool BR>
struct GemmOf;
template <bool AR, bool BR>
struct GemmOf<bf, AR, BR> {
  using type = TcGemm<AR, BR>;
};
template <bool AR, bool BR>
struct GemmOf<float, AR, BR> {
  using type = FmaGemm<AR, BR>;
};

}  // namespace tile
}  // namespace pt
