// One-token paged decode attention over head-major page pools, for
// Hopper, split over the context (flash-decoding).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// `_decode_kernel` (called from `paged_decode_attention`), both halves:
// native (float) pools, and int8 pools with per-page fp32 scales (its
// `quant` branch), where K and V rows widen from int8 in registers, each
// score is multiplied by scale * kscale[page] and each token's p * V term
// by vscale[page] (the TPU kernel scales P.V per page: the same sum). A
// page whose scale is 0 (never written) reads as zeros.
//   q       [B, H, D]
//   k/v     [H_kv, num_pages, page_size, D], q's type or int8
//   k/vscale [num_pages] fp32 (int8 pools)
//   tables  [B, max_pages] int32, logical page -> pool page (< 0 -> 0)
//   lens    [B] int64; row b attends positions 0..lens[b] INCLUSIVE
//   out     [B, H, D] in q's type
// Any group H / H_kv and D in {32, 64, 128, 256}, any page_size.
//
// Bound: bytes. Each attended K and V row is read once for the whole GQA
// group; the work is 2 * group multiply-adds a K or V element, about 4
// operations a byte in bf16, far below the card's ratio of operations to
// bandwidth. So fp32 FMAs are enough and tensor cores are not needed for
// the products: what matters is many bytes in flight on every SM. Int8
// pools halve the bytes of bf16 ones (16.8 MB at B = 8, 8 KV heads of
// 128, context 1024: 5.0 us) but not the work a token, which then sets
// the time (PERF.md).
//
// Design. The TPU kernel walks a sequence's pages one grid step after
// another, carrying (m, l, acc) in VMEM. Here that sequential axis
// becomes parallel blocks and a merge:
//   - grid (split, kv head x group slice, b): split s covers the table's
//     pages [s pps, (s + 1) pps). The host sets pps from the table width,
//     page_size, B, H_kv and the SM count (never from `lens`, which lies
//     on the device: reading it would sync every decode step), so that
//     full tables give at least four blocks an SM (16 splits of one page
//     at B = 8, 8 KV heads, 16 pages of 128). A split that begins past
//     lens[b] exits at once: ragged lengths cost only their pages.
//   - a group of more than 8 query rows is cut into slices of at most 8
//     (GS, a template parameter of 1, 2, 4 or 8; a slice's unused rows
//     compute on zeros and are not written), so any group is admitted.
//   - 4 warps a block; each warp takes every fourth chunk of the split
//     (a chunk is 2 KB of K rows and 2 KB of V rows: 8 tokens at D = 128
//     in bf16, 16 in int8) and streams them through a ring of 3 stages of
//     its own in dynamic shared memory, two chunks ahead of the one it
//     scores (48 KB a block, four blocks an SM). One lane issues TMA bulk
//     copies (`cp.async.bulk`, completion on the stage's mbarrier): one of
//     K rows and one of V rows for each page the chunk touches, since a
//     page's rows are contiguous in the head-major pool, so the copy engine
//     and not the threads keeps the bytes in flight. Pages come from the
//     split's page table (and page scales), staged in shared memory once
//     at block start, so a chunk may span pages of any size. Only mbarrier
//     waits and `__syncwarp` order a warp's ring: no block barrier until
//     the end.
//   - a warp scores a batch of 32 / GS tokens for all GS rows at once:
//     each lane holds D/32 elements of q and of a K row, so each (token,
//     row) is a sum over the 32 lanes. One reduce-scatter of the 32 partial
//     sums (16 + 8 + .. + 1 shuffles, not 32 x 5) leaves one score a lane;
//     the batch's online-softmax update (max, sum) is a shuffle reduction
//     over the lanes of one row, the rescale factor and each p are
//     broadcast by a shuffle, and each lane accumulates p * V for its D/32
//     columns of every row. Int8 codes widen exactly by a byte permute into
//     the mantissa of 2^23 and a subtract (no integer-to-float convert).
//   - the four warps' (m, l, acc) are combined once, in warp order,
//     through shared memory. A sequence that fits one split writes its
//     output there. Otherwise each split writes fp32 partials (m, l,
//     acc[GS][D]) and takes a ticket (one acquire-release atomic); the
//     last split of a (b, kv head, slice) to finish merges all of them in
//     split order and resets the ticket. That keeps the merge inside the
//     one launch: a second, merging launch would add a launch to each of
//     the 32 calls of a decode step. Fixed orders everywhere: the output
//     is the same bit for bit on every run, whatever order the blocks run
//     in.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;
constexpr int kStageBytes = 2048;  // K (and as much V) of a warp's chunk
constexpr int kRingBytes = kWarps * kStages * 2 * kStageBytes;  // 48 KB
constexpr float kNegInf = -1e30f;
// splits a (b, kv head, slice) at most: the merge keeps each one's (m, l)
// for 8 rows in the ring's shared memory
constexpr int kMaxSplits = 512;

// tokens of a warp's chunk
template <typename P, int D>
__host__ __device__ constexpr int chunk_tokens() {
  return kStageBytes / (D * static_cast<int>(sizeof(P)));
}

// EPL consecutive elements at p (aligned to their size) widened to fp32;
// int8 codes four at a time, exactly: each byte, offset by 128, becomes
// the low mantissa byte of 2^23 (one byte permute), then one subtract
template <typename P, int EPL>
__device__ __forceinline__ void load_lane(const P* p, float (&f)[EPL]) {
  if constexpr (sizeof(P) == 1 && EPL % 4 == 0) {
#pragma unroll
    for (int w = 0; w < EPL / 4; ++w) {
      const unsigned x = reinterpret_cast<const unsigned*>(p)[w] ^ 0x80808080u;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        f[4 * w + i] = __uint_as_float(__byte_perm(x, 0x4B00u, 0x5440u + i)) -
                       8388736.f;
    }
  } else {
    struct alignas(EPL * sizeof(P)) Pack {
      P v[EPL];
    };
    const Pack pk = *reinterpret_cast<const Pack*>(p);
#pragma unroll
    for (int e = 0; e < EPL; ++e) f[e] = pt::to_f(pk.v[e]);
  }
}

__host__ __device__ constexpr int log2i(int n) {
  return n <= 1 ? 0 : 1 + log2i(n / 2);
}

// One level of reduce_scatter: the first N of the NV values, offset
// 16 N / NV; a lane keeps the half of them its partner does not and adds
// its partner's copy of that half (levels by recursion, so that every
// index is a constant and v stays in registers)
template <int NV, int N>
__device__ __forceinline__ void reduce_level(float (&v)[NV], int lane) {
  if constexpr (N > 1) {
    constexpr int n = N / 2, o = 16 * N / NV;
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = up ? v[i] : v[i + n];
      const float keep = up ? v[i + n] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    reduce_level<NV, n>(v, lane);
  }
}

// The warp's NV (a power of two <= 32) partial sums v, each summed over
// the 32 lanes, one sum a lane: lane l gets sum number l >> (5 - log2 NV)
// (NV / 2 + NV / 4 + ... shuffles in place of NV x 5), then plain
// butterfly sums over the lanes that hold the same number.
template <int NV>
__device__ __forceinline__ float reduce_scatter(float (&v)[NV], int lane) {
  reduce_level<NV, NV>(v, lane);
  float r = v[0];
#pragma unroll
  for (int o = 16 >> log2i(NV); o > 0; o >>= 1)
    r += __shfl_xor_sync(0xffffffffu, r, o);
  return r;
}

struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int* tables;
  const long long* lens;
  void* out;
  float* part;   // [pairs][splits][GS][D + 2]: m, l, acc (splits > 1)
  int* tickets;  // [pairs], 0 between launches
  int B, H, H_kv, G, slices, num_pages, page_size, page_shift, max_pages;
  int pps, splits;  // table pages a split; splits a pair
  float scale;
  cudaStream_t s;
};

// T: q and out; P: the pools (T, or int8 with page scales); GS: query
// rows of a group slice
template <typename T, typename P, int D, int GS>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const Args a) {
  constexpr bool kQuant = sizeof(P) == 1;
  constexpr int EPL = D / 32;                 // elements a lane
  constexpr int WT = chunk_tokens<P, D>();    // tokens a chunk
  constexpr int SB = WT < 32 / GS ? WT : 32 / GS;  // tokens a batch
  constexpr int NV = SB * GS;                 // scores a batch
  constexpr int LV = log2i(NV), LG = log2i(GS);
  constexpr int SH = 5 - LV;                  // lanes a score: 1 << SH
  static_assert(WT % SB == 0, "chunk shape");

  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kRingBytes);
  int* s_page = reinterpret_cast<int*>(bars + kWarps * kStages);
  float* s_ks = reinterpret_cast<float*>(s_page + a.pps);
  float* s_vs = s_ks + a.pps;
  __shared__ int s_last;

  const int split = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / a.slices;
  const int g0 = (blockIdx.y - hk * a.slices) * GS;
  const int gn = a.G - g0 < GS ? a.G - g0 : GS;
  const int h0 = hk * a.G + g0;
  const int pair = b * gridDim.y + blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const long long len = a.lens[b];  // (its load, q's and the table's
                                    // in flight together)
  float qr[GS][EPL];
  {
    const T* q = static_cast<const T*>(a.q) +
                 (static_cast<size_t>(b) * a.H + h0) * D + lane * EPL;
#pragma unroll
    for (int g = 0; g < GS; ++g) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] = 0.f;
      if (g < gn) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) qr[g][e] = pt::to_f(q[g * D + e]);
      }
    }
  }
  // the split's pages (and scales, with scale folded into k's), whatever
  // the length
  {
    const int np = a.max_pages - split * a.pps < a.pps
                       ? a.max_pages - split * a.pps : a.pps;
    const int* row_table = a.tables + static_cast<size_t>(b) * a.max_pages +
                           static_cast<size_t>(split) * a.pps;
    for (int i = tid; i < np; i += kThreads) {
      int phys = row_table[i];
      phys = phys < 0 ? 0 : (phys >= a.num_pages ? a.num_pages - 1 : phys);
      s_page[i] = phys;
      if constexpr (kQuant) {
        s_ks[i] = a.ks[phys] * a.scale;
        s_vs[i] = a.vs[phys];
      }
    }
  }
  long long n_tok = len + 1;
  const long long cap = static_cast<long long>(a.max_pages) * a.page_size;
  n_tok = n_tok < 1 ? 1 : (n_tok > cap ? cap : n_tok);
  const long long split_tok = static_cast<long long>(a.pps) * a.page_size;
  const long long t_begin = split * split_tok;
  if (t_begin >= n_tok) return;  // past the sequence
  const int n = static_cast<int>(
      n_tok - t_begin < split_tok ? n_tok - t_begin : split_tok);
  const int n_used = static_cast<int>((n_tok + split_tok - 1) / split_tok);

  // the online softmax state of row (lane's score number) % GS, the same
  // in every lane that holds that row; acc for every row, D/32 columns
  float m_me = kNegInf, l_me = 0.f, acc[GS][EPL];
#pragma unroll
  for (int g = 0; g < GS; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  __syncthreads();  // s_page

  const float scale = a.scale;
  const size_t head = static_cast<size_t>(hk) * a.num_pages * a.page_size;
  const P* kbase = static_cast<const P*>(a.kp) + head * D;
  const P* vbase = static_cast<const P*>(a.vp) + head * D;
  unsigned char* ring = smem + warp * kStages * 2 * kStageBytes;
  const int nch = (n + WT - 1) / WT;
  const int mine = warp < nch ? (nch - 1 - warp) / kWarps + 1 : 0;
  const int page_size = a.page_size, page_shift = a.page_shift;
  // page of the split's token tl, and the token's row within it
  auto page_of = [page_size, page_shift](int tl, int& off) {
    int lp;
    if (page_shift >= 0) {
      lp = tl >> page_shift;
      off = tl & (page_size - 1);
    } else {
      lp = tl / page_size;
      off = tl - lp * page_size;
    }
    return lp;
  };

  // the warp's ring: stage st holds chunk i when i % kStages == st, its
  // bytes counted on bars[st] (phase i / kStages); lane 0 issues one bulk
  // copy of K rows and one of V rows for each page a chunk touches (the
  // rows of a page are contiguous), and only a chunk's tokens that lie in
  // the split: the rest of a stage is never read as a token
  uint64_t* wbar = bars + warp * kStages;
  if (lane == 0) {
    for (int st = 0; st < kStages; ++st) pt::hopper::mbar_init(&wbar[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  auto issue = [&](int i) {
    if (lane != 0 || i >= mine) return;
    const int c = warp + i * kWarps;
    const int t0 = c * WT, cnt = n - t0 < WT ? n - t0 : WT;
    constexpr int ROW = D * static_cast<int>(sizeof(P));  // bytes a row
    unsigned char* sk = ring + (i % kStages) * 2 * kStageBytes;
    uint64_t* bar = &wbar[i % kStages];
    pt::hopper::mbar_expect_tx(bar, 2 * cnt * ROW);
    for (int t = t0; t < t0 + cnt;) {
      int off;
      const int lp = page_of(t, off);
      const int run = page_size - off < t0 + cnt - t ? page_size - off
                                                     : t0 + cnt - t;
      const size_t at = (static_cast<size_t>(s_page[lp]) * page_size + off) *
                        D;
      pt::hopper::bulk_load(sk + (t - t0) * ROW, kbase + at, run * ROW, bar);
      pt::hopper::bulk_load(sk + kStageBytes + (t - t0) * ROW, vbase + at,
                            run * ROW, bar);
      t += run;
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < mine; ++i) {
    issue(i + kStages - 1);
    pt::hopper::mbar_wait(&wbar[i % kStages], (i / kStages) & 1);
    const P* sk = reinterpret_cast<const P*>(
        ring + (i % kStages) * 2 * kStageBytes);
    const P* sv = sk + kStageBytes / sizeof(P);
    const int c = warp + i * kWarps;
    const int valid = n - c * WT < WT ? n - c * WT : WT;
    for (int jb = 0; jb < valid; jb += SB) {
      // partial dots of SB tokens x GS rows, then one score a lane:
      // score k = j GS + g (token jb + j, row g) in lanes k << SH ..
      float d[NV];
#pragma unroll
      for (int j = 0; j < SB; ++j) {
        float kf[EPL];
        load_lane<P, EPL>(sk + (jb + j) * D + lane * EPL, kf);
#pragma unroll
        for (int g = 0; g < GS; ++g) {
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) x += qr[g][e] * kf[e];
          d[j * GS + g] = x;
        }
      }
      float sc = reduce_scatter<NV>(d, lane);
      const int tok = jb + ((lane >> SH) >> LG);  // this lane's token
      float ksc = scale, vsc = 1.f;
      if constexpr (kQuant) {
        if (tok < valid) {
          int off;
          const int lp = page_of(c * WT + tok, off);
          ksc = s_ks[lp];
          vsc = s_vs[lp];
        }
      }
      sc = tok < valid ? sc * ksc : kNegInf;
      // online softmax of the lane's row over the batch's tokens
      float mx = sc;
#pragma unroll
      for (int t = 0; t < LV - LG; ++t)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1 << (SH + LG + t)));
      const float m_new = fmaxf(m_me, mx);
      const float alpha = expf(m_me - m_new);
      const float p = sc <= kNegInf * 0.5f ? 0.f : expf(sc - m_new);
      float ps = p;
#pragma unroll
      for (int t = 0; t < LV - LG; ++t)
        ps += __shfl_xor_sync(0xffffffffu, ps, 1 << (SH + LG + t));
      l_me = l_me * alpha + ps;
      m_me = m_new;
      const float pv = p * vsc;  // the token's V scale on its p . V term
#pragma unroll
      for (int g = 0; g < GS; ++g) {
        const float a_g = __shfl_sync(0xffffffffu, alpha, g << SH);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= a_g;
      }
#pragma unroll
      for (int j = 0; j < SB; ++j) {
        if (jb + j >= valid) break;  // (rows past the split were not copied)
        float vf[EPL];
        load_lane<P, EPL>(sv + (jb + j) * D + lane * EPL, vf);
#pragma unroll
        for (int g = 0; g < GS; ++g) {
          const float pj = __shfl_sync(0xffffffffu, pv, (j * GS + g) << SH);
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] += pj * vf[e];
        }
      }
    }
    __syncwarp();  // the stage is read before a later issue refills it
  }

  // the warps' states combined in warp order, through the ring
  __syncthreads();
  float* cm = reinterpret_cast<float*>(smem);  // [kWarps][GS]
  float* cl = cm + kWarps * GS;                 // [kWarps][GS]
  float* ca = cl + kWarps * GS;                 // [kWarps][GS][D]
  if ((lane >> SH) < GS && (lane & ((1 << SH) - 1)) == 0) {  // g << SH
    cm[warp * GS + (lane >> SH)] = m_me;
    cl[warp * GS + (lane >> SH)] = l_me;
  }
#pragma unroll
  for (int g = 0; g < GS; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      ca[(warp * GS + g) * D + lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) + (static_cast<size_t>(b) * a.H + h0) * D;
  float* part = a.part + static_cast<size_t>(pair) * a.splits * GS * (D + 2);
  for (int i = tid; i < gn * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, cm[w * GS + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(cm[w * GS + g] - M);
      L += cl[w * GS + g] * f;
      A += ca[(w * GS + g) * D + d] * f;
    }
    if (n_used == 1) {
      out[i] = pt::from_f<T>(A / (L == 0.f ? 1.f : L));
    } else {
      float* ps = part + (static_cast<size_t>(split) * GS + g) * (D + 2);
      ps[2 + d] = A;
      if (d == 0) {
        ps[0] = M;
        ps[1] = L;
      }
    }
  }
  if (n_used == 1) return;

  // the last split of the pair to finish merges the splits in order:
  // thread 0 takes the ticket with acquire-release semantics after the
  // block's barrier, which orders every thread's partials before it (and
  // the merging block's reads after it)
  __syncthreads();
  if (tid == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(a.tickets + pair)
                 : "memory");
    s_last = prev == n_used - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // every split's (m, l) into shared memory in one pass; then per row
  // its maximum M, the splits' weights exp(m - M) and the sum L; then
  // each output column as the weighted sum of the splits' acc, the
  // splits' loads of a thread in flight together
  const size_t stride = static_cast<size_t>(GS) * (D + 2);
  float* wm = reinterpret_cast<float*>(smem);  // [n_used][GS]
  float* wl = wm + n_used * GS;                 // [n_used][GS]
  float* wL = wl + n_used * GS;                 // [GS]
  for (int i = tid; i < n_used * GS; i += kThreads) {
    const int sp = i / GS, g = i - sp * GS;
    const float* ps = part + sp * stride + g * (D + 2);
    wm[i] = __ldcg(ps);
    wl[i] = __ldcg(ps + 1);
  }
  __syncthreads();
  if (tid < GS) {
    float M = kNegInf;
    for (int sp = 0; sp < n_used; ++sp) M = fmaxf(M, wm[sp * GS + tid]);
    float L = 0.f;
    for (int sp = 0; sp < n_used; ++sp) {
      const float f = expf(wm[sp * GS + tid] - M);
      wm[sp * GS + tid] = f;
      L += wl[sp * GS + tid] * f;
    }
    wL[tid] = L == 0.f ? 1.f : L;
  }
  __syncthreads();
  constexpr int IT = (GS * D + kThreads - 1) / kThreads;  // columns a thread
  float A[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) A[it] = 0.f;
#pragma unroll 4
  for (int sp = 0; sp < n_used; ++sp) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = tid + it * kThreads;
      if (i < gn * D) {
        const int g = i / D, d = i - g * D;
        A[it] += wm[sp * GS + g] * __ldcg(part + sp * stride + g * (D + 2) +
                                          2 + d);
      }
    }
  }
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int i = tid + it * kThreads;
    if (i < gn * D) out[i] = pt::from_f<T>(A[it] / wL[i / D]);
  }
  if (tid == 0) a.tickets[pair] = 0;
}

template <typename T, typename P, int D, int GS>
cudaError_t launch(const Args& a) {
  auto kernel = paged_decode_kernel<T, P, D, GS>;
  const int smem = kRingBytes + kWarps * kStages * 8 +
                   a.pps * (sizeof(P) == 1 ? 12 : 4);
  // the attributes once a device (for the largest table of pps pages)
  static unsigned ready = 0;
  static int ready_smem[32] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(ready >> dev & 1u) || ready_smem[dev] < smem) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    ready |= 1u << dev;
    ready_smem[dev] = smem;
  }
  const dim3 grid(a.splits, a.H_kv * a.slices, a.B);
  kernel<<<grid, kThreads, smem, a.s>>>(a);
  return cudaGetLastError();
}

template <typename T, typename P, int D>
cudaError_t by_slice(int GS, const Args& a) {
  switch (GS) {
    case 1: return launch<T, P, D, 1>(a);
    case 2: return launch<T, P, D, 2>(a);
    case 4: return launch<T, P, D, 4>(a);
    case 8: return launch<T, P, D, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename P>
cudaError_t by_dim(int D, int GS, const Args& a) {
  switch (D) {
    case 32: return by_slice<T, P, 32>(GS, a);
    case 64: return by_slice<T, P, 64>(GS, a);
    case 128: return by_slice<T, P, 128>(GS, a);
    case 256: return by_slice<T, P, 256>(GS, a);
    default: return cudaErrorInvalidValue;
  }
}

// q's type T, pools of T or (with page scales) int8
template <typename T>
cudaError_t by_pool(int D, int GS, const Args& a) {
  return a.ks != nullptr ? by_dim<T, signed char>(D, GS, a)
                         : by_dim<T, T>(D, GS, a);
}

}  // namespace

// kscale / vscale: null for native pools, [num_pages] fp32 for int8 ones;
// dtype is q's (and out's). gs: query rows a group slice (1, 2, 4 or 8;
// ceil(group / gs) slices); pps: table pages a split, splits =
// ceil(max_pages / pps); part: fp32 [B * H_kv * slices * splits * gs *
// (D + 2)] when splits > 1; tickets: int32 [B * H_kv * slices], zero.
extern "C" int pt_paged_decode(const void* q, const void* kp, const void* vp,
                               const void* kscale, const void* vscale,
                               const void* tables, const void* lens,
                               void* out, void* part, void* tickets, int B,
                               int H, int H_kv, int D, int num_pages,
                               int page_size, int max_pages, int gs, int pps,
                               float scale, int dtype, void* stream) {
  if (B <= 0 || H_kv <= 0 || H % H_kv != 0 || page_size <= 0 ||
      max_pages <= 0 || pps <= 0 || gs <= 0 ||
      (kscale == nullptr) != (vscale == nullptr) || tickets == nullptr)
    return cudaErrorInvalidValue;
  const int G = H / H_kv;
  const int splits = (max_pages + pps - 1) / pps;
  if ((splits > 1 && part == nullptr) || splits > kMaxSplits)
    return cudaErrorInvalidValue;
  int shift = -1;
  if ((page_size & (page_size - 1)) == 0)
    for (shift = 0; (1 << shift) < page_size; ++shift) {
    }
  const Args a{q, kp, vp, static_cast<const float*>(kscale),
               static_cast<const float*>(vscale),
               static_cast<const int*>(tables),
               static_cast<const long long*>(lens), out,
               static_cast<float*>(part), static_cast<int*>(tickets), B, H,
               H_kv, G, (G + gs - 1) / gs, num_pages, page_size, shift,
               max_pages, pps, splits, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return static_cast<int>(by_pool<float>(D, gs, a));
  if (dtype == 1)
    return static_cast<int>(by_pool<__nv_bfloat16>(D, gs, a));
  return static_cast<int>(cudaErrorInvalidValue);
}
