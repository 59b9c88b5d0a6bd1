// Fused vocabulary projection + cross entropy for Hopper: four kernels.
//
// Replace the TPU kernels of paddle_tpu/ops/pallas/fused_vocab_ce.py:
//   vocab_ce_fwd_kernel  <- `_fwd_kernel`     (call in `_fwd_pallas`)
//   vocab_ce_dlog_kernel <- `_dlog_block`, the logits recompute that
//                           `_bwd_dh_kernel` and `_bwd_dw_kernel` share
//   vocab_ce_dh_kernel   <- `_bwd_dh_kernel`  (call in `_bwd_pallas`)
//   vocab_ce_dw_kernel   <- `_bwd_dw_kernel`  (call in `_bwd_pallas`)
// and compute what they compute, on h [N, H] and W [H, V] (both row-major,
// one element type) and labels [N] int32:
//   fwd:  per row, lse = logsumexp_v(h . W[:, v]) and tgt = the logit at
//         the label (0 for a label outside [0, V)), fp32; columns >= V are
//         -1e30 and entries <= -5e29 weigh exactly 0; the online (m, s)
//         recurrence of the TPU kernel, s = 0 -> lse = m;
//   dlog: for a chunk of the vocabulary, dlog = g_lse * exp(logit - lse)
//         + g_tgt * onehot(label), rounded to the element type (the cast
//         both TPU backward kernels make before their products), written
//         to a [N, chunk] workspace;
//   dh:   dh (+)= dlog . W[:, chunk]^T, summed over the chunks in order in
//         an fp32 buffer; the last chunk writes h's type;
//   dw:   dW[:, chunk] = h^T . dlog, fp32 sums, written in W's type.
//
// Bound: operations. Every kernel is a matrix product with a contraction
// of H (fwd, dlog), of the chunk (dh) or of N (dw): at the training shape
// (N = 8192, H = 4096, V = 128256, bf16) each of the four does
// 2 N H V = 8.6 TFLOP on at most 1.1 GB.
// Design: the TPU kernels keep an fp32 accumulator of [rows, H] (dh) or
// [H, vocab block] (dW) in VMEM across the sequential grid axis; at
// H = 4096 neither fits one block's shared memory here. So the backward
// streams the vocabulary in chunks: the dlog kernel recomputes the chunk's
// logits once and writes dlog, the dh kernel adds dlog . W_chunk^T to an
// fp32 dh in device memory (chunk after chunk, no atomics, so the result
// does not depend on block order), and the dw kernel writes its columns
// of dW. The forward splits the vocabulary over the blocks of a row tile
// (64 row tiles alone would not fill 132 SMs); each block keeps its rows'
// (m, s, t) in shared memory over its tiles, and the wrapper merges the
// splits' partials, as the RMSNorm backward's partial sum is finished
// outside its kernel. Every product is one tile loop shared by the four
// kernels: bf16 on the tensor cores (mma.sync m16n8k16 fed by ldmatrix,
// fp32 accumulators, 128 x 256 block tiles of eight 64 x 64 warp tiles,
// a 4-stage cp.async ring of 32-deep slices), fp32 as real fp32 FMAs
// (64 x 64 tiles), as the fp32 tolerance needs. The tile lands in shared
// memory as fp32, where the kernel's own epilogue reads it. `wgmma`, TMA
// and warp specialisation are later work.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per block
constexpr float NEG_INF = -1e30f;
using bf = __nv_bfloat16;

using pt::cp_async16;
using pt::cp_async_commit;
using pt::cp_async_wait;

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

struct Args {
  const void* h;       // [N, H]
  const void* w;       // [H, V]
  const int* labels;   // [N]
  const float* lse;    // [N]
  const float* glse;   // [N]
  const float* gtgt;   // [N]
  void* dlog;          // [N, C] workspace
  float* acc;          // [N, H] fp32 dh sums (dh kernel; may alias out)
  void* out;           // dh [N, H] or dW [H, V]
  float* part;         // forward partials [3][N][splits]: m, s, t
  int N, H, V;
  int c0, C, cw;       // chunk: first column, workspace width, columns
  int splits;
  int first, last;     // dh: first and last chunk
  int vec;             // 16-byte operand copies (bf16)
};

// Output tile (tm, tn) of block blockIdx.x: consecutive blocks walk down
// GROUP row tiles of one column tile before moving right, so the blocks
// resident together share their A rows and B columns in L2.
__device__ __forceinline__ void tile_of(int tiles_m, int tiles_n, int& tm,
                                        int& tn) {
  constexpr int GROUP = 8;
  const int id = blockIdx.x;
  const int per_group = GROUP * tiles_n;
  const int first = (id / per_group) * GROUP;
  const int gm = min(tiles_m - first, GROUP);
  tm = first + (id % per_group) % gm;
  tn = (id % per_group) / gm;
}

// grid (splits, row tiles): block (sp, rt) runs vocabulary tiles
// [ntiles sp / splits, ntiles (sp + 1) / splits) of row tile rt
template <typename T>
__global__ void __launch_bounds__(NT, 1) vocab_ce_fwd_kernel(Args a) {
  using G = typename GemmOf<T, true, true>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem);
  float* m_s = reinterpret_cast<float*>(smem + G::SMEM);
  float* s_s = m_s + G::BM;
  float* t_s = s_s + G::BM;
  int* lab_s = reinterpret_cast<int*>(t_s + G::BM);
  const int sp = blockIdx.x, m0 = blockIdx.y * G::BM;
  const int ntiles = (a.V + G::BN - 1) / G::BN;
  const int t0 = static_cast<int>(static_cast<long long>(ntiles) * sp /
                                  a.splits);
  const int t1 = static_cast<int>(static_cast<long long>(ntiles) * (sp + 1) /
                                  a.splits);
  for (int r = threadIdx.x; r < G::BM; r += NT) {
    m_s[r] = NEG_INF;
    s_s[r] = 0.f;
    t_s[r] = 0.f;
    lab_s[r] = m0 + r < a.N ? a.labels[m0 + r] : -1;
  }
  const T* h = static_cast<const T*>(a.h);
  const T* w = static_cast<const T*>(a.w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int PER = G::BN / 32;
  for (int t = t0; t < t1; ++t) {
    const int n0 = t * G::BN;
    G::run(h, a.H, w, a.V, a.N, a.V, a.H, m0, n0, a.vec != 0, smem);
    // one warp a row: the tile's max, the target logit and the rescaled
    // sum of exponentials (the TPU kernel's block update)
    for (int r = warp; r < G::BM; r += NT / 32) {
      float x[PER], mx = NEG_INF, tg = 0.f;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int col = n0 + lane + 32 * j;
        x[j] = col < a.V ? Cs[r * G::LDC + lane + 32 * j] : NEG_INF;
        mx = fmaxf(mx, x[j]);
        if (col == lab_s[r]) tg += x[j];
      }
      mx = pt::warp_max(mx);
      tg = pt::warp_sum(tg);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < PER; ++j)
        ps += x[j] <= NEG_INF * 0.5f ? 0.f : expf(x[j] - m_new);
      ps = pt::warp_sum(ps);
      if (lane == 0) {
        s_s[r] = s_s[r] * expf(m_old - m_new) + ps;
        m_s[r] = m_new;
        t_s[r] += tg;
      }
    }
    __syncthreads();  // Cs is read before the next tile's ring reuses it
  }
  const long long NS = static_cast<long long>(a.N) * a.splits;
  for (int r = threadIdx.x; r < G::BM; r += NT) {
    if (m0 + r >= a.N) continue;
    const long long at = static_cast<long long>(m0 + r) * a.splits + sp;
    a.part[at] = m_s[r];
    a.part[NS + at] = s_s[r];
    a.part[2 * NS + at] = t_s[r];
  }
}

// dlog[:, :cw] of the chunk starting at column c0: the logits tile
// h . W[:, c0 + n0 ..] and the softmax cotangent
template <typename T>
__global__ void __launch_bounds__(NT, 1) vocab_ce_dlog_kernel(Args a) {
  using G = typename GemmOf<T, true, true>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem);
  int tm, tn;
  tile_of((a.N + G::BM - 1) / G::BM, (a.cw + G::BN - 1) / G::BN, tm, tn);
  const int m0 = tm * G::BM, n0 = tn * G::BN;
  G::run(static_cast<const T*>(a.h), a.H, static_cast<const T*>(a.w) + a.c0,
         a.V, a.N, a.cw, a.H, m0, n0, a.vec != 0, smem);
  T* dlog = static_cast<T*>(a.dlog);
  for (int i = threadIdx.x; i < G::BM * G::BN; i += NT) {
    const int r = i / G::BN, c = i % G::BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= a.N || gc >= a.cw) continue;
    const float logit = Cs[r * G::LDC + c];
    const float p =
        logit <= NEG_INF * 0.5f ? 0.f : expf(logit - a.lse[gr]);
    const float d = a.glse[gr] * p +
                    (a.c0 + gc == a.labels[gr] ? a.gtgt[gr] : 0.f);
    dlog[static_cast<long long>(gr) * a.C + gc] = pt::from_f<T>(d);
  }
}

// dh (+)= dlog[:, :cw] . W[:, c0 .. c0 + cw)^T
template <typename T>
__global__ void __launch_bounds__(NT, 1) vocab_ce_dh_kernel(Args a) {
  using G = typename GemmOf<T, true, false>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem);
  int tm, tn;
  tile_of((a.N + G::BM - 1) / G::BM, (a.H + G::BN - 1) / G::BN, tm, tn);
  const int m0 = tm * G::BM, n0 = tn * G::BN;
  // B(k, n) = W[n, c0 + k]: column-major with leading dimension V
  G::run(static_cast<const T*>(a.dlog), a.C,
         static_cast<const T*>(a.w) + a.c0, a.V, a.N, a.H, a.cw, m0, n0,
         a.vec != 0, smem);
  T* out = static_cast<T*>(a.out);
  for (int i = threadIdx.x; i < G::BM * G::BN; i += NT) {
    const int r = i / G::BN, c = i % G::BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= a.N || gc >= a.H) continue;
    const long long at = static_cast<long long>(gr) * a.H + gc;
    float x = Cs[r * G::LDC + c];
    if (!a.first) x += a.acc[at];
    if (a.last)
      out[at] = pt::from_f<T>(x);
    else
      a.acc[at] = x;
  }
}

// dW[:, c0 .. c0 + cw) = h^T . dlog[:, :cw]
template <typename T>
__global__ void __launch_bounds__(NT, 1) vocab_ce_dw_kernel(Args a) {
  using G = typename GemmOf<T, false, true>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem);
  int tm, tn;
  tile_of((a.H + G::BM - 1) / G::BM, (a.cw + G::BN - 1) / G::BN, tm, tn);
  const int m0 = tm * G::BM, n0 = tn * G::BN;
  // A(m, k) = h[k, m]: column-major with leading dimension H
  G::run(static_cast<const T*>(a.h), a.H, static_cast<const T*>(a.dlog),
         a.C, a.H, a.cw, a.N, m0, n0, a.vec != 0, smem);
  T* out = static_cast<T*>(a.out);
  for (int i = threadIdx.x; i < G::BM * G::BN; i += NT) {
    const int r = i / G::BN, c = i % G::BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= a.H || gc >= a.cw) continue;
    out[static_cast<long long>(gr) * a.V + a.c0 + gc] =
        pt::from_f<T>(Cs[r * G::LDC + c]);
  }
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, const Args& a,
                   cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
unsigned grid_2d(int M, int N) {
  using G = typename GemmOf<T, true, true>::type;
  return static_cast<unsigned>(((M + G::BM - 1) / G::BM) *
                               ((N + G::BN - 1) / G::BN));
}

template <typename T>
cudaError_t run(int which, const Args& a, cudaStream_t s) {
  using G = typename GemmOf<T, true, true>::type;  // BM, BN of every kernel
  switch (which) {
    case 0: {
      const dim3 grid(a.splits, (a.N + G::BM - 1) / G::BM);
      return launch(vocab_ce_fwd_kernel<T>, grid, G::SMEM + 4 * G::BM * 4,
                    a, s);
    }
    case 1:
      return launch(vocab_ce_dlog_kernel<T>, dim3(grid_2d<T>(a.N, a.cw)),
                    G::SMEM, a, s);
    case 2:
      return launch(vocab_ce_dh_kernel<T>, dim3(grid_2d<T>(a.N, a.H)),
                    GemmOf<T, true, false>::type::SMEM, a, s);
    default:
      return launch(vocab_ce_dw_kernel<T>, dim3(grid_2d<T>(a.H, a.cw)),
                    GemmOf<T, false, true>::type::SMEM, a, s);
  }
}

int dispatch(int which, int dtype, const Args& a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(run<float>(which, a, s));
  if (dtype == 1) return static_cast<int>(run<bf>(which, a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(int N, int H, int V) {
  Args a = {};
  a.N = N;
  a.H = H;
  a.V = V;
  return a;
}

}  // namespace

// The forward's vocabulary splits for N rows: enough blocks for about
// four waves of two blocks an SM on the current device, at most one
// split a vocabulary tile. Negative on a CUDA error.
extern "C" int pt_vocab_ce_splits(int N, int V, int dtype) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const int bm = dtype == 0 ? FmaGemm<true, true>::BM : TcGemm<true, true>::BM;
  const int bn = dtype == 0 ? FmaGemm<true, true>::BN : TcGemm<true, true>::BN;
  const int row_tiles = (N + bm - 1) / bm;
  const int ntiles = (V + bn - 1) / bn;
  int splits = (8 * sms + row_tiles - 1) / row_tiles;
  if (splits > ntiles) splits = ntiles;
  return splits < 1 ? 1 : splits;
}

extern "C" int pt_vocab_ce_fwd(const void* h, const void* w,
                               const void* labels, void* part, int N, int H,
                               int V, int splits, int dtype, int vec,
                               void* stream) {
  Args a = make_args(N, H, V);
  a.h = h;
  a.w = w;
  a.labels = static_cast<const int*>(labels);
  a.part = static_cast<float*>(part);
  a.splits = splits;
  a.vec = vec;
  return dispatch(0, dtype, a, stream);
}

extern "C" int pt_vocab_ce_dlog(const void* h, const void* w,
                                const void* labels, const void* lse,
                                const void* glse, const void* gtgt,
                                void* dlog, int N, int H, int V, int c0,
                                int C, int cw, int dtype, int vec,
                                void* stream) {
  Args a = make_args(N, H, V);
  a.h = h;
  a.w = w;
  a.labels = static_cast<const int*>(labels);
  a.lse = static_cast<const float*>(lse);
  a.glse = static_cast<const float*>(glse);
  a.gtgt = static_cast<const float*>(gtgt);
  a.dlog = dlog;
  a.c0 = c0;
  a.C = C;
  a.cw = cw;
  a.vec = vec;
  return dispatch(1, dtype, a, stream);
}

extern "C" int pt_vocab_ce_dh(const void* dlog, const void* w, void* acc,
                              void* out, int N, int H, int V, int c0, int C,
                              int cw, int first, int last, int dtype,
                              int vec, void* stream) {
  Args a = make_args(N, H, V);
  a.dlog = const_cast<void*>(dlog);
  a.w = w;
  a.acc = static_cast<float*>(acc);
  a.out = out;
  a.c0 = c0;
  a.C = C;
  a.cw = cw;
  a.first = first;
  a.last = last;
  a.vec = vec;
  return dispatch(2, dtype, a, stream);
}

extern "C" int pt_vocab_ce_dw(const void* h, const void* dlog, void* out,
                              int N, int H, int V, int c0, int C, int cw,
                              int dtype, int vec, void* stream) {
  Args a = make_args(N, H, V);
  a.h = h;
  a.dlog = const_cast<void*>(dlog);
  a.out = out;
  a.c0 = c0;
  a.C = C;
  a.cw = cw;
  a.vec = vec;
  return dispatch(3, dtype, a, stream);
}
