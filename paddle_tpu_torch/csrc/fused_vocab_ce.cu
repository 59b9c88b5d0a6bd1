// Fused vocabulary projection + cross entropy for Hopper: four kernels.
//
// Replace the TPU kernels of paddle_tpu/ops/pallas/fused_vocab_ce.py:
//   fwd                 <- `_fwd_kernel`     (call in `_fwd_pallas`)
//   dlog                <- `_dlog_block`, the logits recompute that
//                          `_bwd_dh_kernel` and `_bwd_dw_kernel` share
//   dh                  <- `_bwd_dh_kernel`  (call in `_bwd_pallas`)
//   dw                  <- `_bwd_dw_kernel`  (call in `_bwd_pallas`)
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
// streams the vocabulary in chunks: dlog recomputes the chunk's logits
// once and writes dlog, dh adds dlog . W_chunk^T to an fp32 dh in device
// memory (chunk after chunk, no atomics, so the result does not depend on
// block order and is the same on every run), and dw writes its columns
// of dW.
//   bf16 backward: the three products run on one TMA + `wgmma` mainloop
//     (wgmma_gemm.cuh: 128 x 256 tiles, a 4-stage mbarrier ring, one
//     producer and two consumer warpgroups, persistent blocks), each with
//     its own epilogue on the accumulator fragment in registers:
//     dlog  A = h (K-major), B = W[:, c0 ..] (MN-major); exp, one-hot,
//           bf16 pairs into the workspace;
//     dh    A = the workspace (K-major), B(k, n) = W[n, c0 + k]
//           (K-major); adds the earlier chunks' fp32 sums and writes them
//           back, or bf16 for the last chunk;
//     dw    A(m, k) = h[k, m] (MN-major), B = the workspace (MN-major);
//           bf16 into dW[:, c0 ..] with row stride V.
//     The workspace's tensor map is cw columns wide, so TMA reads zeros
//     past the chunk and dh's contraction ends at its edge. TMA needs
//     16-byte aligned bases and row strides: the wrapper pads W to a
//     multiple of 8 columns, rounds the workspace up to 64, and refuses an
//     H that is not a multiple of 8.
//   bf16 forward: the same mainloop, A = h (K-major), B = W (MN-major),
//     with a row-reducing epilogue (ROWS in wgmma_gemm.cuh) on the
//     accumulator in registers: a row's 256 tile columns lie in the four
//     lanes of a quad, 64 a lane, so the tile's row max, its sum of
//     exponentials (relative to that max) and the target logit take one
//     pass a lane and two shuffles within the quad; no fp32 tile goes
//     through shared memory and no barrier spans warps. Each (row, column
//     tile) leaves its (m, s, t) in part[3][tiles][N] (49 MB at the
//     Llama shape, against 13 ms of products) and the wrapper merges the
//     tiles in order, as it merges the fp32 route's splits. That was
//     chosen over keeping (m, s, t) in registers across a block's range
//     of column tiles: the persistent scheduler stays the backward's, the
//     partials cost a few tens of microseconds, and the merge order is
//     fixed either way, so lse and tgt are the same on every run. W is
//     read with a row stride of a multiple of 8 columns (the wrapper pads
//     it); columns >= V are masked in the epilogue.
//   fp32 (all four kernels) runs the tile loop of tile_gemm.cuh as real
//     fp32 FMAs (64 x 64 tiles), as the fp32 tolerance needs; its forward
//     splits the vocabulary over the blocks of a row tile (row tiles alone
//     would not fill 132 SMs), each block keeping its rows' (m, s, t) in
//     shared memory over its tiles, and leaves part[3][splits][N].

#include <stdint.h>

#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
using pt::tile::bf;
using pt::tile::FmaGemm;
using pt::tile::NT;

struct Args {
  const void* h;       // [N, H]
  const void* w;       // [H, V], row stride ldw
  const int* labels;   // [N]
  const float* lse;    // [N]
  const float* glse;   // [N]
  const float* gtgt;   // [N]
  void* dlog;          // [N, C] workspace
  float* acc;          // [N, H] fp32 dh sums (dh kernel; may alias out)
  void* out;           // dh [N, H] or dW [H, V]
  float* part;         // forward partials [3][parts][N]: m, s, t
  int N, H, V, ldw;
  int c0, C, cw;       // chunk: first column, workspace width, columns
  int parts;           // forward: splits (fp32) or column tiles (bf16)
  int first, last;     // dh: first and last chunk
};

// fp32 forward, grid (splits, row tiles): block (sp, rt) runs vocabulary
// tiles [ntiles sp / splits, ntiles (sp + 1) / splits) of row tile rt
__global__ void __launch_bounds__(NT, 1) fwd_fma_kernel(Args a) {
  using G = FmaGemm<true, true>;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem);
  float* m_s = reinterpret_cast<float*>(smem + G::SMEM);
  float* s_s = m_s + G::BM;
  float* t_s = s_s + G::BM;
  int* lab_s = reinterpret_cast<int*>(t_s + G::BM);
  const int sp = blockIdx.x, m0 = blockIdx.y * G::BM;
  const int ntiles = (a.V + G::BN - 1) / G::BN;
  const int t0 = static_cast<int>(static_cast<long long>(ntiles) * sp /
                                  a.parts);
  const int t1 = static_cast<int>(static_cast<long long>(ntiles) * (sp + 1) /
                                  a.parts);
  for (int r = threadIdx.x; r < G::BM; r += NT) {
    m_s[r] = NEG_INF;
    s_s[r] = 0.f;
    t_s[r] = 0.f;
    lab_s[r] = m0 + r < a.N ? a.labels[m0 + r] : -1;
  }
  const float* h = static_cast<const float*>(a.h);
  const float* w = static_cast<const float*>(a.w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int PER = G::BN / 32;
  for (int t = t0; t < t1; ++t) {
    const int n0 = t * G::BN;
    G::run(h, a.H, w, a.ldw, a.N, a.V, a.H, m0, n0, false, smem);
    // one warp a row: the tile's max, the target logit and the rescaled
    // sum of exponentials (the TPU kernel's block update)
    for (int r = warp; r < G::BM; r += NT / 32) {
      float x[PER], mx = NEG_INF, tg = 0.f;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int col = n0 + lane + 32 * j;
        x[j] = col < a.V ? Cs[r * G::LDC + lane + 32 * j] : NEG_INF;
        mx = fmaxf(mx, x[j]);
        if (col == lab_s[r] && col < a.V) tg += x[j];
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
  const long long NS = static_cast<long long>(a.N) * a.parts;
  for (int r = threadIdx.x; r < G::BM; r += NT) {
    if (m0 + r >= a.N) continue;
    const long long at = static_cast<long long>(sp) * a.N + m0 + r;
    a.part[at] = m_s[r];
    a.part[NS + at] = s_s[r];
    a.part[2 * NS + at] = t_s[r];
  }
}

// ---------------------------------------------------------------------------
// fp32 backward: real fp32 FMAs (FmaGemm, 64 x 64 tiles)
// ---------------------------------------------------------------------------

// dlog[:, :cw] of the chunk starting at column c0: the logits tile
// h . W[:, c0 + n0 ..] and the softmax cotangent
__global__ void __launch_bounds__(NT, 1) dlog_fma_kernel(Args a) {
  using G = FmaGemm<true, true>;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem);
  int tm, tn;
  pt::wg::raster(blockIdx.x, (a.N + G::BM - 1) / G::BM,
                 (a.cw + G::BN - 1) / G::BN, tm, tn);
  const int m0 = tm * G::BM, n0 = tn * G::BN;
  G::run(static_cast<const float*>(a.h), a.H,
         static_cast<const float*>(a.w) + a.c0, a.V, a.N, a.cw, a.H, m0, n0,
         false, smem);
  float* dlog = static_cast<float*>(a.dlog);
  for (int i = threadIdx.x; i < G::BM * G::BN; i += NT) {
    const int r = i / G::BN, c = i % G::BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= a.N || gc >= a.cw) continue;
    const float logit = Cs[r * G::LDC + c];
    const float p =
        logit <= NEG_INF * 0.5f ? 0.f : expf(logit - a.lse[gr]);
    dlog[static_cast<long long>(gr) * a.C + gc] =
        a.glse[gr] * p + (a.c0 + gc == a.labels[gr] ? a.gtgt[gr] : 0.f);
  }
}

// dh (+)= dlog[:, :cw] . W[:, c0 .. c0 + cw)^T
__global__ void __launch_bounds__(NT, 1) dh_fma_kernel(Args a) {
  using G = FmaGemm<true, false>;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem);
  int tm, tn;
  pt::wg::raster(blockIdx.x, (a.N + G::BM - 1) / G::BM,
                 (a.H + G::BN - 1) / G::BN, tm, tn);
  const int m0 = tm * G::BM, n0 = tn * G::BN;
  // B(k, n) = W[n, c0 + k]: column-major with leading dimension V
  G::run(static_cast<const float*>(a.dlog), a.C,
         static_cast<const float*>(a.w) + a.c0, a.V, a.N, a.H, a.cw, m0, n0,
         false, smem);
  float* out = static_cast<float*>(a.out);
  for (int i = threadIdx.x; i < G::BM * G::BN; i += NT) {
    const int r = i / G::BN, c = i % G::BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= a.N || gc >= a.H) continue;
    const long long at = static_cast<long long>(gr) * a.H + gc;
    float x = Cs[r * G::LDC + c];
    if (!a.first) x += a.acc[at];
    if (a.last)
      out[at] = x;
    else
      a.acc[at] = x;
  }
}

// dW[:, c0 .. c0 + cw) = h^T . dlog[:, :cw]
__global__ void __launch_bounds__(NT, 1) dw_fma_kernel(Args a) {
  using G = FmaGemm<false, true>;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem);
  int tm, tn;
  pt::wg::raster(blockIdx.x, (a.H + G::BM - 1) / G::BM,
                 (a.cw + G::BN - 1) / G::BN, tm, tn);
  const int m0 = tm * G::BM, n0 = tn * G::BN;
  // A(m, k) = h[k, m]: column-major with leading dimension H
  G::run(static_cast<const float*>(a.h), a.H,
         static_cast<const float*>(a.dlog), a.C, a.H, a.cw, a.N, m0, n0,
         false, smem);
  float* out = static_cast<float*>(a.out);
  for (int i = threadIdx.x; i < G::BM * G::BN; i += NT) {
    const int r = i / G::BN, c = i % G::BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= a.H || gc >= a.cw) continue;
    out[static_cast<long long>(gr) * a.V + a.c0 + gc] = Cs[r * G::LDC + c];
  }
}

// ---------------------------------------------------------------------------
// bf16 backward: epilogues of the TMA + `wgmma` mainloop (wgmma_gemm.cuh),
// applied to the accumulator fragment a pair of columns at a time
// ---------------------------------------------------------------------------

// (in a namespace of their own, so that a profiler's kernel names say
// which head the mainloop ran for)
namespace vocab_ce {

// the forward's row reduction (STORE = ROWS): for each row and 256-column
// tile, the tile's max m, the sum s of exp(logit - m) over columns < V
// (entries <= -5e29 weigh 0) and the logit at the row's label (0 if it
// lies outside the tile), into part[3][tiles][N]
struct FwdEpi {
  static constexpr int STORE = pt::wg::ROWS;
  float* part;
  const int* labels;
  int N, V, tiles;

  __device__ __forceinline__ void row_frag(const pt::wg::Tile& t, int r,
                                           int c0,
                                           const float (&x)[pt::wg::BN / 4])
      const {
    const bool ok = r < N;
    const int lab = ok ? labels[r] : -1;
    const bool full = t.n0 + pt::wg::BN <= V;  // no column past V
    float mx = NEG_INF, tg = 0.f;
#pragma unroll
    for (int c = 0; c < pt::wg::BN / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * c + e;
        const bool in = full || col < V;
        mx = fmaxf(mx, in ? x[2 * c + e] : NEG_INF);
        tg = in && col == lab ? x[2 * c + e] : tg;
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < pt::wg::BN / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * c + e;
        const float v = full || col < V ? x[2 * c + e] : NEG_INF;
        s += v <= NEG_INF * 0.5f ? 0.f : __expf(v - mx);
      }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    tg += __shfl_xor_sync(0xffffffffu, tg, 1);
    tg += __shfl_xor_sync(0xffffffffu, tg, 2);
    if (ok && (threadIdx.x & 3) == 0) {
      const long long at = static_cast<long long>(t.n0 / pt::wg::BN) * N + r;
      const long long plane = static_cast<long long>(tiles) * N;
      part[at] = mx;
      part[plane + at] = s;
      part[2 * plane + at] = tg;
    }
  }
};

// dlog of chunk columns 0 .. cw - 1 (vocabulary c0 ..), rounded to bf16,
// into the workspace (row stride ld)
struct DlogEpi {
  bf* out;
  const int* labels;
  const float* lse;
  const float* glse;
  const float* gtgt;
  long long ld;
  int N, c0, cw;

  struct Row {
    bf* out;
    float lse, glse, gtgt;
    int lab;  // the label's column in the chunk (may lie outside it)
    bool ok;
  };
  __device__ __forceinline__ Row row(const pt::wg::Tile&, int r) const {
    Row x = {nullptr, 0.f, 0.f, 0.f, -1, r < N};
    if (x.ok) {
      x.out = out + static_cast<long long>(r) * ld;
      x.lse = lse[r];
      x.glse = glse[r];
      x.gtgt = gtgt[r];
      x.lab = labels[r] - c0;
    }
    return x;
  }
  __device__ __forceinline__ float2 addend(const Row&, int) const {
    return make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ float value(const Row& r, int col,
                                         float logit) const {
    const float p = logit <= NEG_INF * 0.5f ? 0.f : expf(logit - r.lse);
    return r.glse * p + (col == r.lab ? r.gtgt : 0.f);
  }
  __device__ __forceinline__ void pair(const Row& r, int col, float x0,
                                       float x1) const {
    if (col >= cw) return;
    const float d0 = value(r, col, x0);
    if (col + 1 < cw)
      *reinterpret_cast<__nv_bfloat162*>(r.out + col) =
          __floats2bfloat162_rn(d0, value(r, col + 1, x1));
    else
      r.out[col] = __float2bfloat16(d0);
  }
};

// dh columns (H a multiple of 8, so a pair never straddles the edge):
// the earlier chunks' fp32 sums added unless `first` (the tile's sum plus
// them, as the FMA route adds them); fp32 back into acc, or bf16 into out
// for the `last` chunk
struct DhEpi {
  float* acc;
  bf* out;
  int N, H, first, last;

  struct Row {
    long long at;
    bool ok;
  };
  __device__ __forceinline__ Row row(const pt::wg::Tile&, int r) const {
    return {static_cast<long long>(r) * H, r < N};
  }
  __device__ __forceinline__ float2 addend(const Row& r, int col) const {
    if (first || col >= H) return make_float2(0.f, 0.f);
    return *reinterpret_cast<const float2*>(acc + r.at + col);
  }
  __device__ __forceinline__ void pair(const Row& r, int col, float x0,
                                       float x1) const {
    if (col >= H) return;
    const long long at = r.at + col;
    if (last)
      *reinterpret_cast<__nv_bfloat162*>(out + at) =
          __floats2bfloat162_rn(x0, x1);
    else
      *reinterpret_cast<float2*>(acc + at) = make_float2(x0, x1);
  }
};

// dW[:, c0 + col] for chunk columns col < cw, bf16, row stride V; pairs
// are stored together where V and c0 are even (4-byte aligned)
struct DwEpi {
  bf* out;
  long long V;
  int H, c0, cw, pairs;

  struct Row {
    bf* out;
    bool ok;
  };
  __device__ __forceinline__ Row row(const pt::wg::Tile&, int r) const {
    return {out + static_cast<long long>(r) * V + c0, r < H};
  }
  __device__ __forceinline__ float2 addend(const Row&, int) const {
    return make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ void pair(const Row& r, int col, float x0,
                                       float x1) const {
    if (col >= cw) return;
    if (pairs && col + 1 < cw) {
      *reinterpret_cast<__nv_bfloat162*>(r.out + col) =
          __floats2bfloat162_rn(x0, x1);
    } else {
      r.out[col] = __float2bfloat16(x0);
      if (col + 1 < cw) r.out[col + 1] = __float2bfloat16(x1);
    }
  }
};

}  // namespace vocab_ce

int bwd_bf16(int which, const Args& a, cudaStream_t s) {
  using pt::wg::gemm;
  using pt::wg::Operand;
  const Operand h = {a.h, a.H, a.N, a.H};         // [N, H]
  const Operand w = {a.w, a.V, a.H, a.V};         // [H, V]
  const Operand dlog = {a.dlog, a.cw, a.N, a.C};  // [N, cw] of [N, C]
  if (which == 1) {
    const vocab_ce::DlogEpi e = {static_cast<bf*>(a.dlog), a.labels, a.lse,
                                 a.glse, a.gtgt, a.C, a.N, a.c0, a.cw};
    return gemm<false, true>(h, w, a.N, a.cw, a.H, a.c0, e, s);
  }
  if (which == 2) {
    const vocab_ce::DhEpi e = {a.acc, static_cast<bf*>(a.out), a.N, a.H,
                               a.first, a.last};
    return gemm<false, false>(dlog, w, a.N, a.H, a.cw, a.c0, e, s);
  }
  const vocab_ce::DwEpi e = {static_cast<bf*>(a.out), a.V, a.H, a.c0, a.cw,
                             (a.V % 2 == 0 && a.c0 % 2 == 0) ? 1 : 0};
  return gemm<true, true>(h, dlog, a.H, a.cw, a.N, 0, e, s);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

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

cudaError_t fwd_fp32(const Args& a, cudaStream_t s) {
  using G = FmaGemm<true, true>;
  const dim3 grid(a.parts, (a.N + G::BM - 1) / G::BM);
  return launch(fwd_fma_kernel, grid, G::SMEM + 4 * G::BM * 4, a, s);
}

// bf16 forward: h [N, H] (K-major) times W [H, V] (MN-major, row stride
// ldw) on the wgmma mainloop, reduced per row in the epilogue
int fwd_bf16(const Args& a, cudaStream_t s) {
  using pt::wg::Operand;
  const Operand h = {a.h, a.H, a.N, a.H};
  const Operand w = {a.w, a.ldw, a.H, a.ldw};
  const vocab_ce::FwdEpi e = {a.part, a.labels, a.N, a.V, a.parts};
  return pt::wg::gemm<false, true>(h, w, a.N, a.V, a.H, 0, e, s);
}

cudaError_t bwd_fp32(int which, const Args& a, cudaStream_t s) {
  using G = FmaGemm<true, true>;  // BM, BN of the three
  auto grid = [](int M, int N) {
    return dim3(static_cast<unsigned>(((M + G::BM - 1) / G::BM) *
                                      ((N + G::BN - 1) / G::BN)));
  };
  if (which == 1)
    return launch(dlog_fma_kernel, grid(a.N, a.cw), G::SMEM, a, s);
  if (which == 2)
    return launch(dh_fma_kernel, grid(a.N, a.H),
                  FmaGemm<true, false>::SMEM, a, s);
  return launch(dw_fma_kernel, grid(a.H, a.cw), FmaGemm<false, true>::SMEM,
                a, s);
}

// which: 0 forward, 1 dlog, 2 dh, 3 dw
int dispatch(int which, int dtype, const Args& a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(which == 0 ? fwd_fp32(a, s)
                                       : bwd_fp32(which, a, s));
  if (dtype == 1) return which == 0 ? fwd_bf16(a, s) : bwd_bf16(which, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(int N, int H, int V) {
  Args a = {};
  a.N = N;
  a.H = H;
  a.V = V;
  a.ldw = V;
  return a;
}

}  // namespace

// The forward's partials a row: bf16, one a 256-column tile; fp32, the
// vocabulary splits, enough blocks for about four waves of two blocks an
// SM on the current device, at most one split a vocabulary tile.
// Negative on a CUDA error.
extern "C" int pt_vocab_ce_splits(int N, int V, int dtype) {
  if (dtype == 1) return (V + pt::wg::BN - 1) / pt::wg::BN;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  using G = FmaGemm<true, true>;
  const int row_tiles = (N + G::BM - 1) / G::BM;
  const int ntiles = (V + G::BN - 1) / G::BN;
  int splits = (8 * sms + row_tiles - 1) / row_tiles;
  if (splits > ntiles) splits = ntiles;
  return splits < 1 ? 1 : splits;
}

// part: fp32 [3][parts][N] (parts from pt_vocab_ce_splits); ldw: W's row
// stride (V for fp32; a multiple of 8 for bf16, columns >= V ignored)
extern "C" int pt_vocab_ce_fwd(const void* h, const void* w,
                               const void* labels, void* part, int N, int H,
                               int V, int ldw, int parts, int dtype,
                               void* stream) {
  Args a = make_args(N, H, V);
  a.h = h;
  a.w = w;
  a.ldw = ldw;
  a.labels = static_cast<const int*>(labels);
  a.part = static_cast<float*>(part);
  a.parts = parts;
  return dispatch(0, dtype, a, stream);
}

extern "C" int pt_vocab_ce_dlog(const void* h, const void* w,
                                const void* labels, const void* lse,
                                const void* glse, const void* gtgt,
                                void* dlog, int N, int H, int V, int c0,
                                int C, int cw, int dtype, void* stream) {
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
  return dispatch(1, dtype, a, stream);
}

extern "C" int pt_vocab_ce_dh(const void* dlog, const void* w, void* acc,
                              void* out, int N, int H, int V, int c0, int C,
                              int cw, int first, int last, int dtype,
                              void* stream) {
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
  return dispatch(2, dtype, a, stream);
}

extern "C" int pt_vocab_ce_dw(const void* h, const void* dlog, void* out,
                              int N, int H, int V, int c0, int C, int cw,
                              int dtype, void* stream) {
  Args a = make_args(N, H, V);
  a.h = h;
  a.dlog = const_cast<void*>(dlog);
  a.out = out;
  a.c0 = c0;
  a.C = C;
  a.cw = cw;
  return dispatch(3, dtype, a, stream);
}
