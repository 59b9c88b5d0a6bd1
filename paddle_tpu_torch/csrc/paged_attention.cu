// One-token paged decode attention over head-major page pools, for
// Hopper.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// `_decode_kernel` (called from `paged_decode_attention`), both halves:
// native (float) pools, and int8 pools with per-page fp32 scales (its
// `quant` branch), where K and V rows widen from int8 in the kernel, each
// score is multiplied by scale * kscale[page] and each token's p * V term
// by vscale[page] (the TPU kernel scales P.V per page: the same sum). A
// page whose scale is 0 (never written) reads as zeros.
//   q       [B, H, D]
//   k/v     [H_kv, num_pages, page_size, D], q's type or int8
//   k/vscale [num_pages] fp32 (int8 pools)
//   tables  [B, max_pages] int32, logical page -> pool page (< 0 -> 0)
//   lens    [B] int64; row b attends positions 0..lens[b] INCLUSIVE
//   out     [B, H, D] in q's type
//
// Bound: bytes. Each attended K and V row is read once for the whole GQA
// group of H / H_kv query heads; the work per byte is 2 * group
// multiply-adds, below the card's ratio of operations to bandwidth. Int8
// pools halve the bytes of bf16 ones (16.8 MB at B = 8, 8 KV heads of
// 128, context 1024: 5.0 us).
//
// Design: one block of 128 threads (4 warps) per (b, kv head), holding
// the group's queries. The block walks the row's tokens in chunks,
// stopping at lens[b] (the TPU kernel walks the whole table and masks).
// Per chunk:
//   0. the block copies the chunk's K and V rows into shared memory with
//      16-byte loads, all issued before the first is consumed, so many
//      loads are in flight at once (a chunk is 16 KB of K and 16 KB of
//      V: 64 tokens at D = 128 in bf16, 128 in int8, fewer tokens for
//      wider rows); with int8 pools each token's K and V page scale goes
//      beside its row offset, since a chunk spans pages when the page is
//      smaller than the chunk;
//   1. each warp takes tokens in turn; its lanes read the token's K row
//      from shared memory (D / 32 elements a lane) and reduce the
//      group's dot products with shuffles;
//   2. each warp takes group rows and does the online-softmax update in
//      fp32 (running max, sum, and the rescale factor of the
//      accumulator);
//   3. each thread owns output columns d and accumulates p * V[t][d] for
//      the chunk from shared memory.
// A whole 128 x 128 bf16 page pair (64 KB, above the 48 KB of static
// shared memory) is never staged: the chunk streams a part of a page at
// a time. At B = 8 and H_kv = 8 the grid is 64 blocks for 132 SMs:
// splitting the sequence across blocks (flash-decoding) is later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStageBytes = 16384;   // shared memory for K (and for V)
constexpr float kNegInf = -1e30f;

// tokens of a staged chunk: 16 KB of K rows, at most 64 tokens for
// float pools and 128 for int8 ones
template <typename P, int D>
__host__ __device__ constexpr int chunk_tokens() {
  constexpr int fit = kStageBytes / (D * static_cast<int>(sizeof(P)));
  constexpr int cap = sizeof(P) == 1 ? 128 : 64;
  return fit < cap ? fit : cap;
}

// T: q and out; P: the pools (T, or int8 with page scales)
template <typename T, typename P, int D, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                    const P* __restrict__ vp,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const int* __restrict__ tables,
                    const long long* __restrict__ lens, T* __restrict__ out,
                    int H, int num_pages, int page_size, int max_pages,
                    float scale) {
  constexpr bool kQuant = sizeof(P) == 1;
  constexpr int EPL = D / 32;                       // K elements per lane
  constexpr int NPT = (D + kThreads - 1) / kThreads;  // V columns a thread
  constexpr int kChunk = chunk_tokens<P, D>();
  constexpr int VEC = 16 / sizeof(P);               // elements a 16 B load
  constexpr int VPR = D / VEC;                      // 16 B loads a row
  constexpr int LOADS = (kChunk * VPR + kThreads - 1) / kThreads;
  const int b = blockIdx.x, hk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  __shared__ float s_q[G][D];
  __shared__ float s_p[G][kChunk];
  __shared__ long long s_row[kChunk];
  __shared__ float s_ks[kQuant ? kChunk : 1], s_vs[kQuant ? kChunk : 1];
  __shared__ float s_m[G], s_l[G], s_alpha[G];
  __shared__ __align__(16) P s_k[kChunk][D];
  __shared__ __align__(16) P s_v[kChunk][D];

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    s_q[g][d] = pt::to_f(q[(static_cast<size_t>(b) * H + hk * G + g) * D + d]);
  }
  if (tid < G) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }
  __syncthreads();

  float qr[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] = s_q[g][lane * EPL + e];

  float acc[NPT][G];
#pragma unroll
  for (int i = 0; i < NPT; ++i)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[i][g] = 0.f;

  long long n_tok = lens[b] + 1;
  const long long cap = static_cast<long long>(max_pages) * page_size;
  n_tok = n_tok < 1 ? 1 : (n_tok > cap ? cap : n_tok);
  const size_t head_off = static_cast<size_t>(hk) * num_pages * page_size * D;
  const int* row_table = tables + static_cast<size_t>(b) * max_pages;

  for (long long t0 = 0; t0 < n_tok; t0 += kChunk) {
    const int nvalid = static_cast<int>(
        n_tok - t0 < kChunk ? n_tok - t0 : kChunk);
    // 0. page-table lookups, then the chunk's K and V rows into shared
    //    memory, every 16-byte load issued before any is stored
    for (int j = tid; j < nvalid; j += kThreads) {
      const long long t = t0 + j;
      int phys = row_table[t / page_size];
      phys = phys < 0 ? 0 : (phys >= num_pages ? num_pages - 1 : phys);
      s_row[j] = (static_cast<long long>(phys) * page_size + t % page_size)
                 * D;
      if constexpr (kQuant) {
        s_ks[j] = kscale[phys];
        s_vs[j] = vscale[phys];
      }
    }
    __syncthreads();
    {
      uint4 kr[LOADS], vr[LOADS];
#pragma unroll
      for (int it = 0; it < LOADS; ++it) {
        const int i = tid + it * kThreads;
        const int j = i / VPR, c = (i - j * VPR) * VEC;
        if (i < kChunk * VPR && j < nvalid) {
          kr[it] = *reinterpret_cast<const uint4*>(kp + head_off + s_row[j]
                                                   + c);
          vr[it] = *reinterpret_cast<const uint4*>(vp + head_off + s_row[j]
                                                   + c);
        }
      }
#pragma unroll
      for (int it = 0; it < LOADS; ++it) {
        const int i = tid + it * kThreads;
        const int j = i / VPR, c = (i - j * VPR) * VEC;
        if (i < kChunk * VPR && j < nvalid) {
          *reinterpret_cast<uint4*>(&s_k[j][c]) = kr[it];
          *reinterpret_cast<uint4*>(&s_v[j][c]) = vr[it];
        }
      }
    }
    __syncthreads();
    // 1. scores of the chunk
    for (int j = warp; j < kChunk; j += kWarps) {
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
      if (j < nvalid) {                              // warp-uniform
        const P* krow = &s_k[j][lane * EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const float kv = pt::to_f(krow[e]);
#pragma unroll
          for (int g = 0; g < G; ++g) dot[g] += qr[g][e] * kv;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) dot[g] = pt::warp_sum(dot[g]);
      }
      if (lane == 0) {
        float sc = scale;
        if constexpr (kQuant) sc = j < nvalid ? scale * s_ks[j] : 0.f;
#pragma unroll
        for (int g = 0; g < G; ++g)
          s_p[g][j] = j < nvalid ? dot[g] * sc : kNegInf;
      }
    }
    __syncthreads();
    // 2. online softmax update, one group row per warp in turn
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < kChunk; j += 32) mx = fmaxf(mx, s_p[g][j]);
      mx = pt::warp_max(mx);
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kChunk; j += 32) {
        const float p = expf(s_p[g][j] - m_new);
        s_p[g][j] = p;
        sum += p;
      }
      sum = pt::warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        s_alpha[g] = alpha;
        s_l[g] = alpha * s_l[g] + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();
    // 3. rescale and accumulate p * V
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      const int d = tid + i * kThreads;
      if (d < D) {
#pragma unroll
        for (int g = 0; g < G; ++g) acc[i][g] *= s_alpha[g];
        for (int j = 0; j < nvalid; ++j) {
          float vv = pt::to_f(s_v[j][d]);
          if constexpr (kQuant) vv *= s_vs[j];
#pragma unroll
          for (int g = 0; g < G; ++g) acc[i][g] += s_p[g][j] * vv;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int d = tid + i * kThreads;
    if (d < D) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float l = s_l[g] == 0.f ? 1.f : s_l[g];
        out[(static_cast<size_t>(b) * H + hk * G + g) * D + d] =
            pt::from_f<T>(acc[i][g] / l);
      }
    }
  }
}

// the launch's arguments, passed through the dispatch on type, D and G
struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int* tables;
  const long long* lens;
  void* out;
  int B, H, H_kv, num_pages, page_size, max_pages;
  float scale;
  cudaStream_t s;
};

template <typename T, typename P, int D, int G>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.B, a.H_kv);
  paged_decode_kernel<T, P, D, G><<<grid, kThreads, 0, a.s>>>(
      static_cast<const T*>(a.q), static_cast<const P*>(a.kp),
      static_cast<const P*>(a.vp), a.ks, a.vs, a.tables, a.lens,
      static_cast<T*>(a.out), a.H, a.num_pages, a.page_size, a.max_pages,
      a.scale);
  return cudaGetLastError();
}

template <typename T, typename P, int D>
cudaError_t by_group(int G, const Args& a) {
  switch (G) {
    case 1: return launch<T, P, D, 1>(a);
    case 2: return launch<T, P, D, 2>(a);
    case 4: return launch<T, P, D, 4>(a);
    case 8: return launch<T, P, D, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename P>
cudaError_t by_dim(int D, int G, const Args& a) {
  switch (D) {
    case 64: return by_group<T, P, 64>(G, a);
    case 128: return by_group<T, P, 128>(G, a);
    case 256: return by_group<T, P, 256>(G, a);
    default: return cudaErrorInvalidValue;
  }
}

// q's type T, pools of T or (with page scales) int8
template <typename T>
cudaError_t by_pool(int D, int G, const Args& a) {
  return a.ks != nullptr ? by_dim<T, signed char>(D, G, a)
                         : by_dim<T, T>(D, G, a);
}

}  // namespace

// kscale / vscale: null for native pools, [num_pages] fp32 for int8 ones;
// dtype is q's (and out's)
extern "C" int pt_paged_decode(const void* q, const void* kp, const void* vp,
                               const void* kscale, const void* vscale,
                               const void* tables, const void* lens,
                               void* out, int B, int H, int H_kv, int D,
                               int num_pages, int page_size, int max_pages,
                               float scale, int dtype, void* stream) {
  if (H_kv <= 0 || H % H_kv != 0 || (kscale == nullptr) != (vscale == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, kp, vp, static_cast<const float*>(kscale),
               static_cast<const float*>(vscale),
               static_cast<const int*>(tables),
               static_cast<const long long*>(lens), out, B, H, H_kv,
               num_pages, page_size, max_pages, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return static_cast<int>(by_pool<float>(D, H / H_kv, a));
  if (dtype == 1)
    return static_cast<int>(by_pool<__nv_bfloat16>(D, H / H_kv, a));
  return static_cast<int>(cudaErrorInvalidValue);
}
