// Flash attention forward and backward for Hopper.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py
// (`_fwd_kernel`, `_bwd_dq_kernel` and `_bwd_dkv_kernel`) and computes
// what they compute, on q [b, sq, h, d] and k/v [b, sk, hk, d] (GQA:
// query head h reads KV head h / (h / hk)):
//   s   = (q . k) * scale in fp32, masked to -1e30 where the bottom-right
//         causal mask (k_pos > q_pos + sk - sq), the segment ids
//         (q_seg[b, i] != kv_seg[b, j]) or the ragged edge forbid it;
//   fwd: online softmax in fp32 (running max m, denominator l); masked
//        entries give exactly 0; P cast to v's type for P.V, accumulated
//        in fp32; out = acc / l (l = 0 -> 1, so a fully masked row gives
//        out = 0 and lse = m), lse = m + log(l) fp32 [b, h, sq];
//   bwd: p = exp(s - lse), dp = dO . v, ds = p * (dp - delta) * scale;
//        dq = ds (cast to k's type) . k, dv = p_drop^T . dO and
//        dk = ds^T . q, dk and dv summed over the query heads of the KV
//        head's group.
// Dropout uses the keep mask of `_dropout_keep` bit for bit: the murmur3
// finalizer of (q_pos * sk + k_pos) ^ (seed * 0x9E3779B1 + b * 0x85EBCA77
// + h * 0xC2B2AE3D) in uint32 arithmetic, kept where >= threshold; kept
// probabilities are scaled by 1 / (1 - p), l stays unscaled.
//
// Bound: operations. At the training shape (b = 2, s = 4096, 32 query
// heads over 8 KV heads, d = 128, causal) the forward does 2 products of
// s^2 d / 2 multiply-adds per head, the backward 5, on O(s d) bytes: far
// above the card's 295 operations a byte, so only `wgmma` at the tensor
// cores' rate approaches the bound.
//
// Two routes, chosen by dtype:
//   fp32 (flash_fwd_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel):
//     fp32 FMAs from shared memory, real fp32 (no TF32, as the fp32
//     tolerance needs), deterministic: one 256-thread block per (batch *
//     head, 64-row query tile) for fwd and dq, one per (batch * KV head,
//     64-row key tile) for dk/dv, each thread owning a 4 x 4 patch of the
//     64 x 64 score tile.
//   bf16 (flash_fwd_wgmma_kernel, flash_bwd_wgmma_kernel), the design of
//     FlashAttention-2/3 for Hopper: 384 threads, warpgroups 0 and 1
//     consume (64 rows each, `setmaxnreg` 240), warpgroup 2 produces
//     (`setmaxnreg` 24; one thread issues every TMA copy). Tiles come by
//     TMA from 4-D tensor maps over the strided [b, s, heads, d] views
//     (so v may be a split of the fused qkv projection; rows past the
//     sequence arrive as zeros and are masked), swizzled (128 B, or 64 B
//     at d = 32) in panels of 64 (32) columns that the `wgmma`
//     descriptors read in place; mbarriers carry completion and release.
//     fwd: one block per (batch * head, 128-row query tile), longest
//       causal rows first; Q loaded once, K and V through a 2-stage ring
//       of 128-row tiles; S = Q K^T by `wgmma` m64n128k16 from shared
//       memory; the online softmax on the accumulator fragment (each row
//       across its quad of lanes by shuffles), masking only the tiles that
//       need it and skipping the tiles past the diagonal; P rounded to
//       bf16 in registers is the A operand of P V (V read through the
//       descriptor's transpose bit); O stays in registers.
//     bwd: one kernel in place of dq + dk/dv: one block per (batch * KV
//       head, 128-row key tile) loops over the 64-row query tiles that
//       reach the key tile, last tile first, and over its group's query
//       heads within each (Q, dO, lse and delta through a 2-stage ring);
//       S^T = K Q^T and dP^T = V dO^T are recomputed once (5 products per
//       tile instead of the 7 of two kernels); dV += P^T dO and dK +=
//       dS^T Q stay in `wgmma` accumulators; dS^T goes to shared memory
//       for dQ = dS K: each warpgroup's 64 x 64 fp32 dQ tile (its half of
//       d at d = 128, its half of the key tile at d <= 64) goes to a
//       staging tile in shared memory, and the dQ writer, one thread of
//       the producer warpgroup, adds it into an fp32 workspace with one
//       bulk reduce-add (`cp.reduce.async.bulk .add.f32`). The workspace
//       holds each (batch, head, query tile, panel) as a contiguous
//       64 x 64 block; the wrapper permutes it to [b, sq, h, d] and casts
//       it to bf16.
//     The dQ adds go in a fixed order, so dq is the same in every run
//       (FlashAttention-3's deterministic backward, with its dQ writer
//       warp): one int32 counter per (batch, head, 64-row query tile),
//       after the workspace and zeroed with it, counts the blocks that
//       have added into that tile. The key tiles that reach a query tile
//       are 0 .. n (the causal first query tile grows with the key
//       tile), so key tile y's turn is y: the writer spins
//       (`ld.acquire`) until the counter reaches y, issues the reduce
//       (at d <= 64 warpgroup 0's, waits for it, then warpgroup 1's on
//       the same elements), waits for completion and releases one
//       (`red.release`, as CUTLASS's GenericBarrier). dq is thus the sum
//       over ascending key tiles. The consumers never wait on the
//       order: they wait only for their staging tile to be free.
//       Deadlock freedom rests on in-order dispatch: a block waits only
//       on blocks of the same blockIdx.x and lower blockIdx.y, which
//       have a lower linear index and so are resident or done when it
//       is. Each block's (query tile, head) list is a prefix of the list
//       of the block before it (last query tile first), so block y lags
//       block y - 1 by one add, not by a tile's whole work. A wait longer
//       than DQ_TURN_LIMIT_NS traps: a broken order fails the launch
//       instead of hanging the card.
//     Per element, the mask and the dropout are compiled in only for the
//     tiles that need them (ragged edges, causal diagonals, segment ids,
//     dropout); the other tiles run the bare softmax.
//     Every route is deterministic: dq, dk and dv are the same bits in
//     every run, as the fp32 route's and the JAX kernels' are.
// TMA needs 16-byte aligned rows and strides; the wrapper checks them and
// raises. Ragged sq and sk are masked inside, so every length is taken.

#include <cuda.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace pt::hopper;

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // key rows per tile
constexpr int NT = 256;  // threads per block, as 16 x 16
constexpr int LDP = BK + 1;  // row stride of the score-sized tiles
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;  // contiguous [b, sq, h, d]
  const int* qseg;   // [b, sq] or null
  const int* kseg;   // [b, sk] or null
  const float* lse_in;
  const float* delta;
  void* out;
  float* lse;
  void* dq;          // bf16 backward: the fp32 workspace [b, sq, h, d]
  void* dk;
  void* dv;
  int B, H, HK, SQ, SK;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float scale;
  int causal;
  int dropout;
  uint32_t seed, threshold;
  float keep_div;  // 1 - p   (forward and dq divide by it)
  float keep_mul;  // 1/(1-p) (dk/dv multiply by it)
};

__device__ __forceinline__ bool dropout_keep(const Args& a, int b, int h,
                                             int qpos, int kpos) {
  const uint32_t cell = static_cast<uint32_t>(qpos) *
                            static_cast<uint32_t>(a.SK) +
                        static_cast<uint32_t>(kpos);
  const uint32_t key = a.seed * 0x9E3779B1u +
                       static_cast<uint32_t>(b) * 0x85EBCA77u +
                       static_cast<uint32_t>(h) * 0xC2B2AE3Du;
  uint32_t x = cell ^ key;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= a.threshold;
}

// rows row0 .. row0 + 63 of an fp32 [rows, HD] slice (row stride `rs`
// elements) into dst [64][HD + 1]; rows at or past `limit` become 0
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long rs, int row0, int limit) {
  for (int idx = threadIdx.x; idx < 64 * HD; idx += NT) {
    const int r = idx / HD, c = idx % HD;
    const int row = row0 + r;
    dst[r * (HD + 1) + c] =
        row < limit ? base[static_cast<long long>(row) * rs + c] : 0.f;
  }
}

__device__ __forceinline__ void load_seg(int* dst, const int* seg, int row0,
                                         int limit) {
  for (int i = threadIdx.x; i < 64; i += NT)
    dst[i] = row0 + i < limit ? seg[row0 + i] : 0;
}

// sum / max over the 16 lanes that share a score row
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ bool allowed(const Args& a, int qpos, int kpos,
                                        int offset, const int* qseg_s,
                                        const int* kseg_s, int r, int c) {
  if (qpos >= a.SQ || kpos >= a.SK) return false;
  if (a.causal && kpos > qpos + offset) return false;
  if (a.qseg != nullptr && qseg_s[r] != kseg_s[c]) return false;
  return true;
}

template <int HD>
constexpr size_t fwd_smem() {
  return (BQ * (HD + 1) + 2 * BK * (HD + 1) + BQ * LDP + BQ + BK) * 4;
}
template <int HD>
constexpr size_t dq_smem() {
  return (2 * BQ * (HD + 1) + 2 * BK * (HD + 1) + BQ * LDP + BQ + BK) * 4;
}
template <int HD>
constexpr size_t dkv_smem() {
  return (2 * BQ * (HD + 1) + 2 * BK * (HD + 1) + 2 * BQ * LDP + 3 * BQ +
          BK) * 4;
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Args a) {
  constexpr int LD = HD + 1;
  constexpr int JO = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  int* qseg_s = reinterpret_cast<int*>(Ps + BQ * LDP);
  int* kseg_s = qseg_s + BQ;

  const int nq = (a.SQ + BQ - 1) / BQ;
  // the longest causal rows first
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.HK);
  const int offset = a.SK - a.SQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + hk * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + hk * a.vsh;
  load_tile<HD>(Qs, qb, a.qss, q0, a.SQ);
  if (a.qseg != nullptr) load_seg(qseg_s, a.qseg + b * a.SQ, q0, a.SQ);

  float m[4], l[4], acc[4][JO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < JO; ++jj) acc[i][jj] = 0.f;
  }

  const int k_end = a.causal ? min(a.SK, q0 + BQ + offset) : a.SK;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<HD>(Ks, kb, a.kss, k0, a.SK);
    load_tile<HD>(Vs, vb, a.vss, k0, a.SK);
    if (a.qseg != nullptr) load_seg(kseg_s, a.kseg + b * a.SK, k0, a.SK);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qpos = q0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float sv = allowed(a, qpos, k0 + c, offset, qseg_s, kseg_s, r,
                                 c)
                             ? s[i][j] * a.scale
                             : NEG_INF;
        s[i][j] = sv;
        mx = fmaxf(mx, sv);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float p = s[i][j] <= NEG_INF * 0.5f ? 0.f : expf(s[i][j] - m_new);
        ps += p;
        if (a.dropout)
          p = dropout_keep(a, b, h, qpos, k0 + c) ? p / a.keep_div : 0.f;
        Ps[r * LDP + c] = p;
      }
      ps = row_sum16(ps);
      l[i] = alpha * l[i] + ps;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < JO; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[JO];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int jj = 0; jj < JO; ++jj) vv[jj] = Vs[c * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < JO; ++jj)
          acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
  }

  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= a.SQ) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    const long long row = (static_cast<long long>(b) * a.SQ + qpos) * a.H + h;
#pragma unroll
    for (int jj = 0; jj < JO; ++jj)
      out[row * HD + tx + 16 * jj] = acc[i][jj] / safe_l;
    if (tx == 0)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.SQ + qpos] =
          m[i] + logf(safe_l);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(Args a) {
  constexpr int LD = HD + 1;
  constexpr int JO = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* DSs = Vs + BK * LD;
  int* qseg_s = reinterpret_cast<int*>(DSs + BQ * LDP);
  int* kseg_s = qseg_s + BQ;

  const int nq = (a.SQ + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.HK);
  const int offset = a.SK - a.SQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + hk * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + hk * a.vsh;
  const long long dos = static_cast<long long>(a.H) * HD;  // dout row stride
  const float* dob = static_cast<const float*>(a.dout) +
                 static_cast<long long>(b) * a.SQ * dos + h * HD;
  load_tile<HD>(Qs, qb, a.qss, q0, a.SQ);
  load_tile<HD>(dOs, dob, dos, q0, a.SQ);
  if (a.qseg != nullptr) load_seg(qseg_s, a.qseg + b * a.SQ, q0, a.SQ);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    const long long at = (static_cast<long long>(b) * a.H + h) * a.SQ + qpos;
    lse_r[i] = qpos < a.SQ ? a.lse_in[at] : 0.f;
    delta_r[i] = qpos < a.SQ ? a.delta[at] : 0.f;
  }

  float acc[4][JO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < JO; ++jj) acc[i][jj] = 0.f;

  const int k_end = a.causal ? min(a.SK, q0 + BQ + offset) : a.SK;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile<HD>(Ks, kb, a.kss, k0, a.SK);
    load_tile<HD>(Vs, vb, a.vss, k0, a.SK);
    if (a.qseg != nullptr) load_seg(kseg_s, a.kseg + b * a.SK, k0, a.SK);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * LD + d];
        ov[i] = dOs[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * LD + d];
        vv[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        const float sv =
            allowed(a, qpos, kpos, offset, qseg_s, kseg_s, r, c)
                ? s[i][j] * a.scale
                : NEG_INF;
        const float p = sv <= NEG_INF * 0.5f ? 0.f : expf(sv - lse_r[i]);
        float dpv = dp[i][j];
        if (a.dropout)
          dpv = dropout_keep(a, b, h, qpos, kpos) ? dpv / a.keep_div : 0.f;
        DSs[r * LDP + c] = p * (dpv - delta_r[i]) * a.scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[4], kv[JO];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = DSs[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int jj = 0; jj < JO; ++jj) kv[jj] = Ks[c * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < JO; ++jj)
          acc[i][jj] = fmaf(dsv[i], kv[jj], acc[i][jj]);
    }
  }

  float* dq = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= a.SQ) continue;
    const long long row = (static_cast<long long>(b) * a.SQ + qpos) * a.H + h;
#pragma unroll
    for (int jj = 0; jj < JO; ++jj)
      dq[row * HD + tx + 16 * jj] = acc[i][jj];
  }
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(Args a) {
  constexpr int LD = HD + 1;
  constexpr int JO = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* DSs = Ps + BQ * LDP;
  float* lse_s = DSs + BQ * LDP;
  float* delta_s = lse_s + BQ;
  int* qseg_s = reinterpret_cast<int*>(delta_s + BQ);
  int* kseg_s = qseg_s + BQ;

  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / a.HK, hk = bh % a.HK;
  const int group = a.H / a.HK;
  const int nq = (a.SQ + BQ - 1) / BQ;
  const int offset = a.SK - a.SQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + hk * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + hk * a.vsh;
  load_tile<HD>(Ks, kb, a.kss, k0, a.SK);
  load_tile<HD>(Vs, vb, a.vss, k0, a.SK);
  if (a.qseg != nullptr) load_seg(kseg_s, a.kseg + b * a.SK, k0, a.SK);
  const long long dos = static_cast<long long>(a.H) * HD;

  // rows 4 ty .. 4 ty + 3 of the key tile, columns tx + 16 jj
  float dk[4][JO], dv[4][JO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < JO; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
    const float* dob = static_cast<const float*>(a.dout) +
                   static_cast<long long>(b) * a.SQ * dos + h * HD;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      // causal: the whole query tile lies above this key tile
      if (a.causal && q0 + BQ - 1 + offset < k0) continue;
      __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
      load_tile<HD>(Qs, qb, a.qss, q0, a.SQ);
      load_tile<HD>(dOs, dob, dos, q0, a.SQ);
      if (a.qseg != nullptr) load_seg(qseg_s, a.qseg + b * a.SQ, q0, a.SQ);
      for (int i = threadIdx.x; i < BQ; i += NT) {
        const int qpos = q0 + i;
        const long long at =
            (static_cast<long long>(b) * a.H + h) * a.SQ + qpos;
        lse_s[i] = qpos < a.SQ ? a.lse_in[at] : 0.f;
        delta_s[i] = qpos < a.SQ ? a.delta[at] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = Qs[(ty * 4 + i) * LD + d];
          ov[i] = dOs[(ty * 4 + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv[j] = Ks[(tx + 16 * j) * LD + d];
          vv[j] = Vs[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i, qpos = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, kpos = k0 + c;
          const float sv =
              allowed(a, qpos, kpos, offset, qseg_s, kseg_s, r, c)
                  ? s[i][j] * a.scale
                  : NEG_INF;
          const float p = sv <= NEG_INF * 0.5f ? 0.f : expf(sv - lse_s[r]);
          float pd = p, dpv = dp[i][j];
          if (a.dropout) {
            const bool keep = dropout_keep(a, b, h, qpos, kpos);
            pd = keep ? p * a.keep_mul : 0.f;
            dpv = keep ? dpv * a.keep_mul : 0.f;
          }
          Ps[r * LDP + c] = pd;
          DSs[r * LDP + c] = p * (dpv - delta_s[r]) * a.scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[4], dsv[4], ov[JO], qv[JO];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[r * LDP + ty * 4 + i];
          dsv[i] = DSs[r * LDP + ty * 4 + i];
        }
#pragma unroll
        for (int jj = 0; jj < JO; ++jj) {
          ov[jj] = dOs[r * LD + tx + 16 * jj];
          qv[jj] = Qs[r * LD + tx + 16 * jj];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < JO; ++jj) {
            dv[i][jj] = fmaf(pv[i], ov[jj], dv[i][jj]);
            dk[i][jj] = fmaf(dsv[i], qv[jj], dk[i][jj]);
          }
      }
    }
  }

  float* dkp = static_cast<float*>(a.dk);
  float* dvp = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= a.SK) continue;
    const long long row =
        (static_cast<long long>(b) * a.SK + kpos) * a.HK + hk;
#pragma unroll
    for (int jj = 0; jj < JO; ++jj) {
      dkp[row * HD + tx + 16 * jj] = dk[i][jj];
      dvp[row * HD + tx + 16 * jj] = dv[i][jj];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the Hopper kernels (TMA, mbarrier ring, `wgmma`, warp
// specialisation). Fragment conventions of a warpgroup's m64nN `wgmma`
// accumulator, for thread t (warp w = t / 32, lane): element j lies in
// row 16 w + lane / 4 + 8 ((j / 2) % 2) and column 8 (j / 4) + 2 (lane %
// 4) + j % 2. Its bf16 A operand for k-step kk (columns 16 kk .. 16 kk +
// 15 of such an accumulator) is the four pairs (8 kk, +1), (8 kk + 2, +3),
// (8 kk + 4, +5), (8 kk + 6, +7).
// ---------------------------------------------------------------------------

constexpr int HB = 128;     // forward query tile rows; backward key tile rows
constexpr int BQB = 64;     // backward query tile rows
constexpr int STAGES = 2;   // depth of the TMA rings
constexpr int NTH = 384;    // two consumer warpgroups and one producer
constexpr float LOG2E = 1.4426950408889634f;

// A tile of `rows` rows of d bf16 values is stored as NP panels of PW
// columns, each `rows` x SW bytes in the TMA swizzle of SW bytes.
template <int HD>
struct Geo {
  static constexpr int SW = HD >= 64 ? 128 : 64;
  static constexpr int PW = SW / 2;
  static constexpr int NP = HD / PW;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;  // wgmma swizzle
  static constexpr int KSTEPS = PW / 16;                  // k-steps a panel
};

// rows row0 .. row0 + rows - 1 of (head, batch), all d columns, as NP
// swizzled panels at dst
template <int HD>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int rows, int row0,
                                         int head, int batch) {
  using G = Geo<HD>;
#pragma unroll
  for (int p = 0; p < G::NP; ++p)
    tma_load4(dst + p * rows * G::SW, map, bar, p * G::PW, row0, head,
              batch);
}

// d[64 x 32] (+)= A . B, both from shared memory (descriptors)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

// d[64 x 64] (+)= A . B, both from shared memory (descriptors)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

// d[64 x 128] (+)= A . B, both from shared memory (descriptors)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

// d[64 x 32] (+)= A . B, A from registers (bf16 pairs), B from shared
// memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d[64 x 64] (+)= A . B, A from registers (bf16 pairs), B from shared
// memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// the panel-wide products: A from registers (or, transposed, from shared
// memory), B an MN-major panel of PW columns
template <int HD>
__device__ __forceinline__ void wgmma_rs_panel(
    float (&d)[Geo<HD>::PW / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (Geo<HD>::PW == 64)
    wgmma_rs_n64(d, a, b, 1);
  else
    wgmma_rs_n32(d, a, b, 1);
}
template <int HD>
__device__ __forceinline__ void wgmma_tt_panel(float (&d)[Geo<HD>::PW / 2],
                                               uint64_t a, uint64_t b,
                                               int acc) {
  if constexpr (Geo<HD>::PW == 64)
    wgmma_ss_n64<1, 1>(d, a, b, acc);
  else
    wgmma_ss_n32<1, 1>(d, a, b, acc);
}

// shared memory of the forward, byte offsets from a 1024-aligned base
template <int HD>
struct FwdSmem {
  static constexpr int TILE = HB * HD * 2;
  static constexpr int Q = 0;
  static constexpr int K = Q + TILE;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BAR = V + STAGES * TILE;
  static constexpr int BYTES = BAR + 8 * (1 + 3 * STAGES) + 1024;
};

// S = Q K^T for one warpgroup's 64 rows (both K-major, 128 columns),
// issued and committed, not waited for
template <int HD>
__device__ __forceinline__ void fwd_scores(float (&s)[HB / 2],
                                           const unsigned char* qw,
                                           const unsigned char* kt) {
  using G = Geo<HD>;
  constexpr uint32_t SB = 8 * G::SW;  // 8-row group stride
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int p = kk / G::KSTEPS, off = (kk % G::KSTEPS) * 32;
    wgmma_ss_n128<0, 0>(s,
                        gdesc(qw + p * HB * G::SW + off, 16, SB, G::LAYOUT),
                        gdesc(kt + p * HB * G::SW + off, 16, SB, G::LAYOUT),
                        kk > 0);
  }
  wg_commit();
}

// O += P V (P from registers, V MN-major, one panel at a time), issued
// and committed
template <int HD>
__device__ __forceinline__ void fwd_pv(float (&o)[Geo<HD>::NP][Geo<HD>::PW / 2],
                                       uint32_t (&pa)[HB / 16][4],
                                       const unsigned char* vt) {
  using G = Geo<HD>;
  constexpr uint32_t SB = 8 * G::SW;
  // the rescaled O and the packed P are final before the fence
#pragma unroll
  for (int p = 0; p < G::NP; ++p) keep(o[p]);
  keep(pa);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HB / 16; ++kk)
#pragma unroll
    for (int p = 0; p < G::NP; ++p)
      wgmma_rs_panel<HD>(o[p], pa[kk],
                         gdesc(vt + p * HB * G::SW + kk * 16 * G::SW, SB, SB,
                               G::LAYOUT));
  wg_commit();
}

// whether a forward tile at key k0 needs the mask: the ragged edge,
// segment ids, or a causal diagonal within this warpgroup's rows
__device__ __forceinline__ bool fwd_need(const Args& a, int k0, int qmin,
                                         int offset) {
  return k0 + HB > a.SK || a.qseg != nullptr ||
         (a.causal && k0 + HB - 1 > qmin + offset);
}

// P (fp32 accumulator layout) to the bf16 A operand of P V
__device__ __forceinline__ void pack_p(uint32_t (&pa)[HB / 16][4],
                                       const float (&s)[HB / 2]) {
#pragma unroll
  for (int kk = 0; kk < HB / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// The online softmax of one tile of scores s (this thread's two rows qr
// and qr + 8): scale, mask where `need`, update the running max m and
// denominator l, leave p (dropped and scaled where dropout is on) in s
// and the rescale factors of the running sums in alpha. p = exp(s - m)
// is taken as 2^(s log2(e) - m log2(e)); a row masked so far (m still
// -1e30) takes 0 in place of m log2(e), so its p and alpha are 0.
template <bool MASK, bool DROP, int N>
__device__ __forceinline__ void online_softmax_t(
    const Args& a, float (&s)[N], float (&m)[2], float (&l)[2],
    float (&alpha)[2], int k0, int qr, int cq, int offset,
    const int (&qs)[2], int b, int h) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = qr + 8 * i;
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < N / 4; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 4 * c + 2 * i + e;
        float sv = s[j] * a.scale;
        if (MASK) {
          const int kpos = k0 + 8 * c + cq + e;
          bool ok = kpos < a.SK && !(a.causal && kpos > qpos + offset);
          if (ok && a.qseg != nullptr) ok = a.kseg[b * a.SK + kpos] == qs[i];
          if (!ok) sv = NEG_INF;
        }
        s[j] = sv;
        mx = fmaxf(mx, sv);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[i], mx);
    const float ml = mn <= NEG_INF * 0.5f ? 0.f : mn * LOG2E;
    alpha[i] = exp2f(fmaf(m[i], LOG2E, -ml));
    float ps = 0.f;
#pragma unroll
    for (int c = 0; c < N / 4; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 4 * c + 2 * i + e;
        float p = exp2f(fmaf(s[j], LOG2E, -ml));
        ps += p;
        if (DROP)
          p = dropout_keep(a, b, h, qpos, k0 + 8 * c + cq + e)
                  ? p / a.keep_div
                  : 0.f;
        s[j] = p;
      }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l[i] = alpha[i] * l[i] + ps;
    m[i] = mn;
  }
}

// online_softmax_t with the mask and the dropout compiled in only where
// a tile needs them (the branch is uniform over the block): the common
// tile runs the bare softmax
template <int N>
__device__ __forceinline__ void online_softmax(
    const Args& a, float (&s)[N], float (&m)[2], float (&l)[2],
    float (&alpha)[2], bool need, int k0, int qr, int cq, int offset,
    const int (&qs)[2], int b, int h) {
  if (a.dropout)
    online_softmax_t<true, true>(a, s, m, l, alpha, k0, qr, cq, offset, qs,
                                 b, h);
  else if (need)
    online_softmax_t<true, false>(a, s, m, l, alpha, k0, qr, cq, offset, qs,
                                  b, h);
  else
    online_softmax_t<false, false>(a, s, m, l, alpha, k0, qr, cq, offset,
                                   qs, b, h);
}

template <int HD>
__global__ void __launch_bounds__(NTH, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const Args a) {
  using G = Geo<HD>;
  using L = FwdSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int nqt = (a.SQ + HB - 1) / HB;
  // the longest causal rows first
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.y)) * HB;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int hk = h / (a.H / a.HK);
  const int offset = a.SK - a.SQ;
  const int k_end = a.causal ? min(a.SK, q0 + HB + offset) : a.SK;
  const int ntiles = (k_end + HB - 1) / HB;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: Q once, then K and V of every tile through the ring
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, L::TILE);
      tma_tile<HD>(sm + L::Q, &tq, q_full, HB, q0, h, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], L::TILE);
        tma_tile<HD>(sm + L::K + s * L::TILE, &tk, &k_full[s], HB, t * HB,
                     hk, b);
        mbar_expect_tx(&v_full[s], L::TILE);
        tma_tile<HD>(sm + L::V + s * L::TILE, &tv, &v_full[s], HB, t * HB,
                     hk, b);
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    setmaxnreg_inc<240>();
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    const int cq = 2 * (lane & 3);
    const int qr = q0 + wg * 64 + warp * 16 + (lane >> 2);  // rows qr, +8
    int qs[2] = {0, 0};
    if (a.qseg != nullptr) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        qs[i] = qr + 8 * i < a.SQ ? a.qseg[b * a.SQ + qr + 8 * i] : 0;
    }
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float o[G::NP][G::PW / 2];
#pragma unroll
    for (int p = 0; p < G::NP; ++p)
#pragma unroll
      for (int j = 0; j < G::PW / 2; ++j) o[p][j] = 0.f;
    float s[HB / 2];
    uint32_t pa[HB / 16][4];
    const unsigned char* qw = sm + L::Q + wg * 64 * G::SW;
    const int qmin = q0 + wg * 64;  // this warpgroup's first row

    mbar_wait(q_full, 0);
    // software pipeline: S of tile t is computed while P V of tile t - 1
    // runs on the tensor cores, and the softmax of tile t overlaps it.
    // The first tile's scores and the last tile's P V are peeled off, so
    // the loop's commit groups are the same on every trip.
    if (ntiles > 0) {
      float alpha[2];
      mbar_wait(&k_full[0], 0);
      fwd_scores<HD>(s, qw, sm + L::K);
      wg_wait<0>();
      keep(s);
      online_softmax(a, s, m, l, alpha, fwd_need(a, 0, qmin, offset), 0, qr,
                     cq, offset, qs, b, h);
      pack_p(pa, s);
      for (int tt = 1; tt < ntiles; ++tt) {
        const int st = tt % STAGES, ph = (tt / STAGES) & 1;
        const int pst = (tt - 1) % STAGES, pph = ((tt - 1) / STAGES) & 1;
        mbar_wait(&k_full[st], ph);
        fwd_scores<HD>(s, qw, sm + L::K + st * L::TILE);
        mbar_wait(&v_full[pst], pph);
        fwd_pv<HD>(o, pa, sm + L::V + pst * L::TILE);
        wg_wait<1>();
        keep(s);
        const int k0 = tt * HB;
        online_softmax(a, s, m, l, alpha, fwd_need(a, k0, qmin, offset), k0,
                       qr, cq, offset, qs, b, h);
        wg_wait<0>();
#pragma unroll
        for (int p = 0; p < G::NP; ++p) keep(o[p]);
        keep(pa);
        mbar_arrive(&empty[pst]);
#pragma unroll
        for (int p = 0; p < G::NP; ++p)
#pragma unroll
          for (int j = 0; j < G::PW / 2; ++j) o[p][j] *= alpha[(j >> 1) & 1];
        pack_p(pa, s);
      }
      const int lst = (ntiles - 1) % STAGES;
      mbar_wait(&v_full[lst], ((ntiles - 1) / STAGES) & 1);
      fwd_pv<HD>(o, pa, sm + L::V + lst * L::TILE);
      wg_wait<0>();
#pragma unroll
      for (int p = 0; p < G::NP; ++p) keep(o[p]);
      keep(pa);
      mbar_arrive(&empty[lst]);
    }

    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = qr + 8 * i;
      if (qpos >= a.SQ) continue;
      const float safe_l = l[i] == 0.f ? 1.f : l[i];
      __nv_bfloat16* row =
          out + ((static_cast<long long>(b) * a.SQ + qpos) * a.H + h) * HD;
#pragma unroll
      for (int p = 0; p < G::NP; ++p)
#pragma unroll
        for (int c = 0; c < G::PW / 8; ++c) {
          const int j = 4 * c + 2 * i;
          *reinterpret_cast<__nv_bfloat162*>(row + p * G::PW + 8 * c + cq) =
              __floats2bfloat162_rn(o[p][j] / safe_l, o[p][j + 1] / safe_l);
        }
      if ((lane & 3) == 0)
        a.lse[(static_cast<long long>(b) * a.H + h) * a.SQ + qpos] =
            m[i] + logf(safe_l);
    }
  }
}

// The backward's elementwise step on this thread's fragment of S^T and
// dP^T (key rows kr, kr + 8; query columns q0 + 8 c + cq + e): P = exp(S
// scale - lse), masked to 0 where MASK forbids the pair; dS = P (dP -
// delta) scale; with DROP, P and dP kept and scaled by 1 / (1 - p). Leaves
// the dropped P in sT and dS in dpT.
template <bool MASK, bool DROP>
__device__ __forceinline__ void bwd_probs(const Args& a, float (&sT)[BQB / 2],
                                          float (&dpT)[BQB / 2],
                                          const float* lse_s,
                                          const float* delta_s, int q0,
                                          int kr, int cq, int offset,
                                          const int (&ks)[2], int b, int h) {
  // this thread's 16 query columns' lse (times log2(e)) and delta
  float lse2[BQB / 4], dlt[BQB / 4];
#pragma unroll
  for (int c = 0; c < BQB / 8; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      lse2[2 * c + e] = lse_s[8 * c + cq + e] * LOG2E;
      dlt[2 * c + e] = delta_s[8 * c + cq + e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = kr + 8 * i;
#pragma unroll
    for (int c = 0; c < BQB / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 4 * c + 2 * i + e, col = 8 * c + cq + e;
        const int qpos = q0 + col;
        bool ok = true;
        if (MASK) {
          ok = qpos < a.SQ && kpos < a.SK &&
               !(a.causal && kpos > qpos + offset);
          if (ok && a.qseg != nullptr) ok = a.qseg[b * a.SQ + qpos] == ks[i];
        }
        const float p =
            ok ? exp2f(fmaf(sT[j] * a.scale, LOG2E, -lse2[2 * c + e])) : 0.f;
        float pd = p, dpv = dpT[j];
        if (DROP) {
          const bool kp = dropout_keep(a, b, h, qpos, kpos);
          pd = kp ? p * a.keep_mul : 0.f;
          dpv = kp ? dpv * a.keep_mul : 0.f;
        }
        sT[j] = pd;
        dpT[j] = p * (dpv - dlt[2 * c + e]) * a.scale;
      }
  }
}

// The ordered dQ adds (file header): the dQ writer waits for its turn on
// a query tile's counter and, after its adds have landed, passes the turn
// on. A wait longer than DQ_TURN_LIMIT_NS means the order is broken (a
// dependency never ran): trap rather than hang.
constexpr unsigned long long DQ_TURN_LIMIT_NS = 10000000000ull;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void dq_turn_wait(const int* turn, int target) {
  if (load_acquire(turn) >= target) return;
  const unsigned long long t0 = global_ns();
  while (load_acquire(turn) < target)
    if (global_ns() - t0 > DQ_TURN_LIMIT_NS) __trap();
}

__device__ __forceinline__ void dq_turn_pass(int* turn) {
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n"
               :
               : "l"(turn)
               : "memory");
}

// lse and delta rows are read from the 16-byte boundary at or before
// their first value (TMA reads boxes from 16-byte aligned addresses), so
// a box holds RB = BQB + 4 values
constexpr int RB = BQB + 4;
constexpr int LSLOT = 512;

// shared memory of the backward, byte offsets from a 1024-aligned base
template <int HD>
struct BwdSmem {
  static constexpr int KT = HB * HD * 2;    // a K or V tile
  static constexpr int QT = BQB * HD * 2;   // a Q or dO tile
  static constexpr int DST = HB * BQB * 2;  // a dS^T tile [keys][queries]
  static constexpr int K = 0;
  static constexpr int V = K + KT;
  static constexpr int Q = V + KT;
  static constexpr int DO = Q + STAGES * QT;
  static constexpr int DS = DO + STAGES * QT;  // two, alternating
  static constexpr int LSE = DS + 2 * DST;    // a slot of LSLOT bytes a stage
  static constexpr int DELTA = LSE + STAGES * LSLOT;
  static constexpr int DQT = BQB * Geo<HD>::PW * 4;  // a staged fp32 dQ tile
  static constexpr int DQ = DELTA + STAGES * LSLOT;  // one a warpgroup
  static constexpr int BAR = DQ + 2 * DQT;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES + 4) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(NTH, 1)
    flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tlse,
                           const __grid_constant__ CUtensorMap tdelta,
                           const Args a) {
  using G = Geo<HD>;
  using L = BwdSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* dq_full = empty + STAGES;  // a warpgroup's staged dQ is in
  uint64_t* dq_empty = dq_full + 2;    // the writer has added it

  const int b = blockIdx.x / a.HK, hk = blockIdx.x % a.HK;
  const int k0 = blockIdx.y * HB;
  const int group = a.H / a.HK;
  const int offset = a.SK - a.SQ;
  const int nq = (a.SQ + BQB - 1) / BQB;
  // causal: query tiles below `first` lie wholly above this key tile
  int first = 0;
  if (a.causal) {
    const int lo = k0 - offset - (BQB - 1);
    first = lo > 0 ? (lo + BQB - 1) / BQB : 0;
  }
  const int per = nq > first ? nq - first : 0;
  const int n_it = group * per;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(&dq_full[w], 128);
      mbar_init(&dq_empty[w], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: K and V once, then Q, dO, lse, delta of every iteration;
    // and the dQ writer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256 + 32) {
      // the dQ writer: each iteration's staged tiles, added in this key
      // tile's turn into the tile-contiguous workspace
      float* ws = static_cast<float*>(a.dq);
      int* turns = reinterpret_cast<int*>(
          ws + static_cast<long long>(a.B) * a.H * nq * BQB * HD);
      for (int it = 0; it < n_it; ++it) {
        const int h = hk * group + it % group;
        const int qt = nq - 1 - it / group;
        const long long tile =
            (static_cast<long long>(b) * a.H + h) * nq + qt;
        int* turn = turns + tile;
        float* dst = ws + tile * (BQB * HD);
        for (int w = 0; w < 2; ++w) mbar_wait(&dq_full[w], it & 1);
        dq_turn_wait(turn, static_cast<int>(blockIdx.y));
        // the earlier key tiles' adds, acquired, before this tile's
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        for (int w = 0; w < 2; ++w) {
          // d = 128: warpgroup w's panel; d <= 64: both warpgroups'
          // partial sums of the one tile, warpgroup 0's landed first
          bulk_reduce_add(dst + (G::NP == 2 ? w * BQB * G::PW : 0),
                          sm + L::DQ + w * L::DQT, L::DQT);
          bulk_commit();
          if (G::NP == 1 && w == 0) bulk_wait<0, false>();
        }
        bulk_wait<0, false>();
        mbar_arrive(&dq_empty[0]);
        mbar_arrive(&dq_empty[1]);
        // the adds landed (async proxy) before the release
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        dq_turn_pass(turn);
      }
    }
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 2 * L::KT);
      tma_tile<HD>(sm + L::K, &tk, kv_full, HB, k0, hk, b);
      tma_tile<HD>(sm + L::V, &tv, kv_full, HB, k0, hk, b);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        const int h = hk * group + it % group;
        const int q0 = (nq - 1 - it / group) * BQB;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::QT + 2 * RB * 4);
        tma_tile<HD>(sm + L::Q + s * L::QT, &tq, &full[s], BQB, q0, h, b);
        tma_tile<HD>(sm + L::DO + s * L::QT, &tdo, &full[s], BQB, q0, h, b);
        const int row = ((b * a.H + h) * a.SQ + q0) & ~3;
        tma_load2(sm + L::LSE + s * LSLOT, &tlse, &full[s], row, 0);
        tma_load2(sm + L::DELTA + s * LSLOT, &tdelta, &full[s], row, 0);
      }
    }
  } else {
    // consumers: warpgroup wg owns key rows k0 + 64 wg .. + 63
    setmaxnreg_inc<240>();
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    const int cq = 2 * (lane & 3);
    const int r_lo = warp * 16 + (lane >> 2);  // fragment rows r_lo, +8
    const int kmin = k0 + wg * 64;              // this warpgroup's first key
    const int kr = kmin + r_lo;                 // key rows kr, kr + 8
    int ks[2] = {0, 0};
    if (a.qseg != nullptr) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ks[i] = kr + 8 * i < a.SK ? a.kseg[b * a.SK + kr + 8 * i] : 0;
    }
    float dk[G::NP][G::PW / 2], dv[G::NP][G::PW / 2];
#pragma unroll
    for (int p = 0; p < G::NP; ++p)
#pragma unroll
      for (int j = 0; j < G::PW / 2; ++j) dk[p][j] = dv[p][j] = 0.f;
    constexpr uint32_t SB = 8 * G::SW;
    // dQ: at d = 128 warpgroup wg takes panel wg over all 128 keys; at
    // d <= 64 the one panel over its own 64 keys
    constexpr int DQ_STEPS = G::NP == 2 ? HB / 16 : 64 / 16;
    const int dq_panel = G::NP == 2 ? wg : 0;
    const int dq_key0 = G::NP == 2 ? 0 : wg * 64;
    float* stage = reinterpret_cast<float*>(sm + L::DQ + wg * L::DQT);

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % STAGES, ph = (it / STAGES) & 1;
      const int h = hk * group + it % group;
      const int q0 = (nq - 1 - it / group) * BQB;
      const unsigned char* qt = sm + L::Q + st * L::QT;
      const unsigned char* dot = sm + L::DO + st * L::QT;
      const int lsh = ((b * a.H + h) * a.SQ + q0) & 3;  // see RB
      const float* lse_s = reinterpret_cast<const float*>(
                               sm + L::LSE + st * LSLOT) + lsh;
      const float* delta_s = reinterpret_cast<const float*>(
                                 sm + L::DELTA + st * LSLOT) + lsh;
      unsigned char* dsb = sm + L::DS + (it & 1) * L::DST;

      // S^T = K Q^T and dP^T = V dO^T (K-major, 64 query columns)
      float sT[BQB / 2], dpT[BQB / 2];
      mbar_wait(&full[st], ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int p = kk / G::KSTEPS, off = (kk % G::KSTEPS) * 32;
        wgmma_ss_n64<0, 0>(
            sT, gdesc(sm + L::K + p * HB * G::SW + wg * 64 * G::SW + off, 16,
                      SB, G::LAYOUT),
            gdesc(qt + p * BQB * G::SW + off, 16, SB, G::LAYOUT), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int p = kk / G::KSTEPS, off = (kk % G::KSTEPS) * 32;
        wgmma_ss_n64<0, 0>(
            dpT, gdesc(sm + L::V + p * HB * G::SW + wg * 64 * G::SW + off,
                       16, SB, G::LAYOUT),
            gdesc(dot + p * BQB * G::SW + off, 16, SB, G::LAYOUT), kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      keep(sT);
      keep(dpT);

      // P^T (dropped) and dS^T, element by element
      const bool need = q0 + BQB > a.SQ || kmin + 64 > a.SK ||
                        a.qseg != nullptr ||
                        (a.causal && kmin + 63 > q0 + offset);
      if (a.dropout)
        bwd_probs<true, true>(a, sT, dpT, lse_s, delta_s, q0, kr, cq,
                              offset, ks, b, h);
      else if (need)
        bwd_probs<true, false>(a, sT, dpT, lse_s, delta_s, q0, kr, cq,
                               offset, ks, b, h);
      else
        bwd_probs<false, false>(a, sT, dpT, lse_s, delta_s, q0, kr, cq,
                                offset, ks, b, h);
      uint32_t pT[BQB / 16][4], dsT[BQB / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQB / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pT[kk][r] = pack_bf16(sT[8 * kk + 2 * r], sT[8 * kk + 2 * r + 1]);
          dsT[kk][r] =
              pack_bf16(dpT[8 * kk + 2 * r], dpT[8 * kk + 2 * r + 1]);
        }
      // dS^T [keys][queries] into shared memory in the 128-byte swizzle
      // (pair r of k-step kk: row r_lo + 8 (r % 2), 8-column chunk
      // 2 kk + r / 2)
#pragma unroll
      for (int kk = 0; kk < BQB / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = wg * 64 + r_lo + 8 * (r & 1);
          const int chunk = 2 * kk + (r >> 1);
          *reinterpret_cast<uint32_t*>(
              dsb + row * 128 + ((chunk ^ (row & 7)) << 4) + cq * 2) =
              dsT[kk][r];
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

      // dV += P^T dO and dK += dS^T Q (A from registers, B MN-major)
      keep(pT);
      keep(dsT);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQB / 16; ++kk)
#pragma unroll
        for (int p = 0; p < G::NP; ++p) {
          wgmma_rs_panel<HD>(
              dv[p], pT[kk],
              gdesc(dot + p * BQB * G::SW + kk * 16 * G::SW, SB, SB,
                    G::LAYOUT));
          wgmma_rs_panel<HD>(
              dk[p], dsT[kk],
              gdesc(qt + p * BQB * G::SW + kk * 16 * G::SW, SB, SB,
                    G::LAYOUT));
        }
      wg_commit();

      // both warpgroups' dS^T are in place
      asm volatile("bar.sync 1, 256;\n" ::: "memory");

      // dQ = dS K for this warpgroup's panel and keys (dS^T read
      // transposed, K MN-major)
      float dq[G::PW / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_STEPS; ++kk) {
        const int key = dq_key0 + kk * 16;
        wgmma_tt_panel<HD>(
            dq, gdesc(dsb + key * 128, 1024, 1024, 1),
            gdesc(sm + L::K + dq_panel * HB * G::SW + key * G::SW, SB, SB,
                  G::LAYOUT),
            kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      keep(dq);
#pragma unroll
      for (int p = 0; p < G::NP; ++p) {
        keep(dk[p]);
        keep(dv[p]);
      }
      keep(pT);
      keep(dsT);
      mbar_arrive(&empty[st]);

      // dQ into this warpgroup's staging tile [64 queries][PW] once the
      // writer has added the last one; the writer adds it in order
      mbar_wait(&dq_empty[wg], (it & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < G::PW / 8; ++c)
          *reinterpret_cast<float2*>(stage + (r_lo + 8 * i) * G::PW + 8 * c +
                                     cq) =
              make_float2(dq[4 * c + 2 * i], dq[4 * c + 2 * i + 1]);
      fence_async_shared();
      mbar_arrive(&dq_full[wg]);
    }

    // dK, dV of this warpgroup's keys, bf16 [b, sk, hk, d]
    __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(a.dk);
    __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(a.dv);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kpos = kr + 8 * i;
      if (kpos >= a.SK) continue;
      const long long at =
          ((static_cast<long long>(b) * a.SK + kpos) * a.HK + hk) * HD;
#pragma unroll
      for (int p = 0; p < G::NP; ++p)
#pragma unroll
        for (int c = 0; c < G::PW / 8; ++c) {
          const int j = 4 * c + 2 * i, col = p * G::PW + 8 * c + cq;
          *reinterpret_cast<__nv_bfloat162*>(dkp + at + col) =
              __floats2bfloat162_rn(dk[p][j], dk[p][j + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dvp + at + col) =
              __floats2bfloat162_rn(dv[p][j], dv[p][j + 1]);
        }
    }
  }
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

// fp32: the FMA kernels (forward, dq, dk/dv)
template <int HD>
cudaError_t run_fp32(int which, const Args& a, cudaStream_t stream) {
  const int nq = (a.SQ + BQ - 1) / BQ, nk = (a.SK + BK - 1) / BK;
  const dim3 gq(nq, a.B * a.H), gk(nk, a.B * a.HK);
  if (which == 0)
    return launch(flash_fwd_kernel<HD>, gq, fwd_smem<HD>(), a, stream);
  if (which == 1)
    return launch(flash_bwd_dq_kernel<HD>, gq, dq_smem<HD>(), a, stream);
  return launch(flash_bwd_dkv_kernel<HD>, gk, dkv_smem<HD>(), a, stream);
}

// a bf16 [batch, s, heads, HD] view with element strides (ss, sh, sb), read
// in boxes of `rows` rows by one panel of one head
template <int HD>
bool rows_map(CUtensorMap* m, const void* base, int S, int heads, int B,
              long long ss, long long sh, long long sb, int rows) {
  using G = Geo<HD>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(G::PW),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             G::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a flat fp32 vector of n values, read RB at a time (as one row of a
// [1, n] matrix)
bool vec_map(CUtensorMap* m, const void* base, long long n) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n), 1};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>((n * 4 + 15) / 16 *
                                                         16)};
  const cuuint32_t box[2] = {RB, 1};
  const cuuint32_t estr[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a refused tensor map of q, k, v, dout, or lse and delta returns
// MAP_REFUSED + 0 .. 4

// bf16: the forward (which 0) or the one backward kernel (which 3)
template <int HD>
int run_bf16(int which, const Args& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const int qrows = which == 0 ? HB : BQB;
  if (!rows_map<HD>(&tq, a.q, a.SQ, a.H, a.B, a.qss, a.qsh, a.qsb, qrows))
    return MAP_REFUSED;
  if (!rows_map<HD>(&tk, a.k, a.SK, a.HK, a.B, a.kss, a.ksh, a.ksb, HB))
    return MAP_REFUSED + 1;
  if (!rows_map<HD>(&tv, a.v, a.SK, a.HK, a.B, a.vss, a.vsh, a.vsb, HB))
    return MAP_REFUSED + 2;
  if (which == 0) {
    const size_t smem = FwdSmem<HD>::BYTES;
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    const dim3 grid(a.B * a.H, (a.SQ + HB - 1) / HB);
    flash_fwd_wgmma_kernel<HD><<<grid, NTH, smem, stream>>>(tq, tk, tv, a);
    return cudaGetLastError();
  }
  CUtensorMap tdo, tlse, tdelta;
  const long long hd = static_cast<long long>(a.H) * HD;  // dout row stride
  const long long rows = static_cast<long long>(a.B) * a.H * a.SQ;
  if (!rows_map<HD>(&tdo, a.dout, a.SQ, a.H, a.B, hd, HD, a.SQ * hd, BQB))
    return MAP_REFUSED + 3;
  if (!vec_map(&tlse, a.lse_in, rows) || !vec_map(&tdelta, a.delta, rows))
    return MAP_REFUSED + 4;
  const size_t smem = BwdSmem<HD>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(a.B * a.HK, (a.SK + HB - 1) / HB);
  flash_bwd_wgmma_kernel<HD><<<grid, NTH, smem, stream>>>(tq, tk, tv, tdo,
                                                          tlse, tdelta, a);
  return cudaGetLastError();
}

template <int HD>
int run(int which, int dtype, const Args& a, cudaStream_t stream) {
  if (dtype == 0 && which <= 2) return run_fp32<HD>(which, a, stream);
  if (dtype == 1 && (which == 0 || which == 3))
    return run_bf16<HD>(which, a, stream);
  return cudaErrorInvalidValue;
}

int run_d(int which, int dtype, int D, const Args& a,
          cudaStream_t stream) {
  if (D == 32) return run<32>(which, dtype, a, stream);
  if (D == 64) return run<64>(which, dtype, a, stream);
  if (D == 128) return run<128>(which, dtype, a, stream);
  return cudaErrorInvalidValue;
}

int dispatch(int which, const void* q, const void* k, const void* v,
             const void* dout, const void* qseg, const void* kseg,
             const void* lse_in, const void* delta, void* out, void* lse,
             void* dq, void* dk, void* dv, int B, int H, int HK, int SQ,
             int SK, int D, long long qsb, long long qss, long long qsh,
             long long ksb, long long kss, long long ksh, long long vsb,
             long long vss, long long vsh, float scale, int causal,
             int dropout, unsigned int seed, unsigned int threshold,
             float keep_div, float keep_mul, int dtype, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.lse_in = static_cast<const float*>(lse_in);
  a.delta = static_cast<const float*>(delta);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.H = H;
  a.HK = HK;
  a.SQ = SQ;
  a.SK = SK;
  a.qsb = qsb;
  a.qss = qss;
  a.qsh = qsh;
  a.ksb = ksb;
  a.kss = kss;
  a.ksh = ksh;
  a.vsb = vsb;
  a.vss = vss;
  a.vsh = vsh;
  a.scale = scale;
  a.causal = causal;
  a.dropout = dropout;
  a.seed = seed;
  a.threshold = threshold;
  a.keep_div = keep_div;
  a.keep_mul = keep_mul;
  return run_d(which, dtype, D, a, static_cast<cudaStream_t>(stream));
}

}  // namespace

#define PT_FLASH_PARAMS                                                      \
  const void *q, const void *k, const void *v, const void *dout,            \
      const void *qseg, const void *kseg, const void *lse_in,               \
      const void *delta, void *out, void *lse, void *dq, void *dk, void *dv, \
      int B, int H, int HK, int SQ, int SK, int D, long long qsb,           \
      long long qss, long long qsh, long long ksb, long long kss,           \
      long long ksh, long long vsb, long long vss, long long vsh,           \
      float scale, int causal, int dropout, unsigned int seed,              \
      unsigned int threshold, float keep_div, float keep_mul, int dtype,    \
      void *stream
#define PT_FLASH_ARGS                                                        \
  q, k, v, dout, qseg, kseg, lse_in, delta, out, lse, dq, dk, dv, B, H, HK,  \
      SQ, SK, D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, scale, causal, \
      dropout, seed, threshold, keep_div, keep_mul, dtype, stream

// The entry points share one argument list (pointers a kernel does not use
// may be null). pt_flash_fwd takes fp32 and bf16; pt_flash_bwd_dq and
// pt_flash_bwd_dkv are the fp32 backward, pt_flash_bwd the bf16 one (dq is
// then the zeroed fp32 workspace that it adds into, [b, h, ceil(sq / 64),
// d / PW, 64, PW] with PW = 64 (32 at d = 32), followed by
// b * h * ceil(sq / 64) zeroed int32 counters of the ordered adds).
extern "C" int pt_flash_fwd(PT_FLASH_PARAMS) {
  return dispatch(0, PT_FLASH_ARGS);
}
extern "C" int pt_flash_bwd_dq(PT_FLASH_PARAMS) {
  return dispatch(1, PT_FLASH_ARGS);
}
extern "C" int pt_flash_bwd_dkv(PT_FLASH_PARAMS) {
  return dispatch(2, PT_FLASH_ARGS);
}
extern "C" int pt_flash_bwd(PT_FLASH_PARAMS) {
  return dispatch(3, PT_FLASH_ARGS);
}
