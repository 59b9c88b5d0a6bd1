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
// outside its kernel. Every product is one tile loop (tile_gemm.cuh,
// shared with the grouped matmul): bf16 on the tensor cores (mma.sync m16n8k16 fed by ldmatrix,
// fp32 accumulators, 128 x 256 block tiles of eight 64 x 64 warp tiles,
// a 4-stage cp.async ring of 32-deep slices), fp32 as real fp32 FMAs
// (64 x 64 tiles), as the fp32 tolerance needs. The tile lands in shared
// memory as fp32, where the kernel's own epilogue reads it. `wgmma`, TMA
// and warp specialisation are later work.

#include <stdint.h>

#include "tile_gemm.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
using pt::tile::bf;
using pt::tile::FmaGemm;
using pt::tile::GemmOf;
using pt::tile::NT;
using pt::tile::TcGemm;

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
