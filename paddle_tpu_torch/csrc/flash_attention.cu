// Flash attention forward and backward for Hopper: three kernels.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_kernel     <- `_fwd_kernel`     (call in `_fwd`)
//   flash_bwd_dq_kernel  <- `_bwd_dq_kernel`  (call in `_bwd`)
//   flash_bwd_dkv_kernel <- `_bwd_dkv_kernel` (call in `_bwd`)
// and computes what they compute, on q [b, sq, h, d] and k/v
// [b, sk, hk, d] (GQA: query head h reads KV head h / (h / hk)):
//   s   = (q . k) * scale in fp32, masked to -1e30 where the bottom-right
//         causal mask (k_pos > q_pos + sk - sq), the segment ids
//         (q_seg[b, i] != kv_seg[b, j]) or the ragged edge forbid it;
//   fwd: online softmax in fp32 (running max m, denominator l); masked
//        entries give exactly 0; P cast to v's type for P.V, accumulated
//        in fp32; out = acc / l (l = 0 -> 1, so a fully masked row gives
//        out = 0 and lse = m), lse = m + log(l) fp32 [b, h, sq];
//   dq:  p = exp(s - lse), dp = dO . v, ds = p * (dp - delta) * scale,
//        dq += ds (cast to k's type) . k;
//   dkv: dv += p_drop^T . dO, dk += ds^T . q, summed over the query
//        heads of the KV head's group and over the query tiles.
// Dropout uses the keep mask of `_dropout_keep` bit for bit: the murmur3
// finalizer of (q_pos * sk + k_pos) ^ (seed * 0x9E3779B1 + b * 0x85EBCA77
// + h * 0xC2B2AE3D) in uint32 arithmetic, kept where >= threshold; kept
// probabilities are scaled by 1 / (1 - p), l stays unscaled.
//
// Bound: operations. At the training shape (s = 4096, d = 128) each
// kernel does O(s^2 d) multiply-adds on O(s d) bytes.
// Design: one 256-thread block per (batch * head, 64-row query tile)
// for fwd and dq, looping over 64-row K/V tiles up to the causal
// diagonal (the loop takes the place of the TPU's sequential grid
// dimension); one block per (batch * KV head, 64-row key tile) for dk/dv,
// looping over the group's query heads and the query tiles, so the group
// sum stays in registers: no atomics, and the result does not depend on
// the order in which blocks run. The masking, softmax and dropout are
// done by threads that each own a 4 x 4 patch of the 64 x 64 score tile
// (rows 4 ty .. 4 ty + 3, columns tx + 16 j). Two versions of the
// products:
//   fp32 (flash_*_kernel): fp32 FMAs from shared memory, real
//     fp32 (no TF32, as the fp32 tolerance needs), tiles staged as fp32
//     with rows padded by one word so the column reads are free of bank
//     conflicts; bound by the FMA rate and by shared-memory reads;
//   bf16 (flash_*_tc_kernel): the products on the tensor cores (WMMA
//     16 x 16 x 16, bf16 operands, fp32 accumulators), which the bf16
//     training shape needs to approach its bound; synchronous loads and
//     the round trips of each product through shared memory bound it
//     well below the card's rate (`wgmma`, TMA and a pipelined ring are
//     later work).
// The tiles exceed 48 KB of shared memory (up to 163 KB at d = 128), so
// each launch raises the kernel's dynamic limit. Ragged sq and sk are
// masked inside, so every length is taken.

#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

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
  void* dq;
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
  int vec;         // q, k, v, dout rows 16-byte aligned: vector copies
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
// bf16: the same three kernels with their products on the tensor cores
// (WMMA 16 x 16 x 16, bf16 operands, fp32 accumulators). The tiles are
// staged in shared memory as bf16; each product's fp32 result goes to a
// shared fp32 tile, where the threads do the masking, the softmax and the
// dropout with the mapping of the fp32 kernels above; P and dS are
// rounded to bf16 (the casts of the TPU kernels) into shared memory as
// the next product's operand. Warp w owns the 16-row band w / 2 of every
// 64-row tile and half of its 16-column tiles.
// ---------------------------------------------------------------------------

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int HD>
struct Tc {
  static constexpr int LDB = HD + 8;    // bf16 [64][HD] operand tiles
  static constexpr int LDS = BK + 4;    // fp32 [64][64] score tiles
  static constexpr int LDPB = BK + 8;   // bf16 [64][64] P / dS tiles
  static constexpr int LDO = HD + 4;    // fp32 [64][HD] output tiles
  static constexpr int OT = HD / 32;    // output 16x16 tiles per warp
  // byte sizes, each a multiple of 128 so every region stays aligned
  static constexpr size_t OPND = 64 * LDB * 2;
  static constexpr size_t SCORE = 64 * LDS * 4;
  static constexpr size_t PB = 64 * LDPB * 2;
  static constexpr size_t OUT = 64 * LDO * 4;
  static constexpr size_t TAIL = 4 * 64 * 4;  // segs, lse, delta
  static constexpr size_t fwd = 3 * OPND + SCORE + PB + OUT + TAIL;
  static constexpr size_t dq = 4 * OPND + 2 * SCORE + PB + OUT + TAIL;
  static constexpr size_t dkv = 4 * OPND + 2 * SCORE + 2 * PB + OUT + TAIL;
};

// rows row0 .. row0 + 63 of a bf16 [rows, HD] slice into dst [64][HD + 8];
// 16-byte copies when the caller has checked the alignment
template <int HD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* base,
                                               long long rs, int row0,
                                               int limit, bool vec) {
  constexpr int LDB = Tc<HD>::LDB;
  if (vec) {
    for (int idx = threadIdx.x; idx < 64 * HD / 8; idx += NT) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
      const int row = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row < limit)
        val = *reinterpret_cast<const uint4*>(
            base + static_cast<long long>(row) * rs + c);
      *reinterpret_cast<uint4*>(dst + r * LDB + c) = val;
    }
  } else {
    for (int idx = threadIdx.x; idx < 64 * HD; idx += NT) {
      const int r = idx / HD, c = idx % HD;
      const int row = row0 + r;
      dst[r * LDB + c] = row < limit
                             ? base[static_cast<long long>(row) * rs + c]
                             : __float2bfloat16(0.f);
    }
  }
}

// S[64][64] (fp32, ld LDS) = A[64][HD] . B[64][HD]^T, both bf16 (ld LDB)
template <int HD>
__device__ __forceinline__ void tc_abt(float* S, const __nv_bfloat16* A,
                                       const __nv_bfloat16* B) {
  constexpr int LDB = Tc<HD>::LDB, LDS = Tc<HD>::LDS;
  const int w = threadIdx.x >> 5, tr = w >> 1, tc0 = (w & 1) * 2;
  FragC c[2];
  wmma::fill_fragment(c[0], 0.f);
  wmma::fill_fragment(c[1], 0.f);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    FragA a;
    wmma::load_matrix_sync(a, A + tr * 16 * LDB + kk * 16, LDB);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      FragBt b;  // B^T: element (k, n) is B[n][k]
      wmma::load_matrix_sync(b, B + (tc0 + t) * 16 * LDB + kk * 16, LDB);
      wmma::mma_sync(c[t], a, b, c[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
    wmma::store_matrix_sync(S + tr * 16 * LDS + (tc0 + t) * 16, c[t], LDS,
                            wmma::mem_row_major);
}

// acc[OT] (this warp's tiles of a [64][HD] result) += P[64][64] . V[64][HD],
// or P^T . V when TRANS (P bf16 with ld LDPB, V bf16 with ld LDB)
template <int HD, bool TRANS>
__device__ __forceinline__ void tc_pv(FragC* acc, const __nv_bfloat16* P,
                                      const __nv_bfloat16* V) {
  constexpr int LDB = Tc<HD>::LDB, LDPB = Tc<HD>::LDPB, OT = Tc<HD>::OT;
  const int w = threadIdx.x >> 5, tr = w >> 1, tc0 = (w & 1) * OT;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    typename std::conditional<TRANS, FragAt, FragA>::type a;
    if (TRANS)  // element (m, k) is P[k][m]
      wmma::load_matrix_sync(a, P + kk * 16 * LDPB + tr * 16, LDPB);
    else
      wmma::load_matrix_sync(a, P + tr * 16 * LDPB + kk * 16, LDPB);
#pragma unroll
    for (int t = 0; t < OT; ++t) {
      FragB b;
      wmma::load_matrix_sync(b, V + kk * 16 * LDB + (tc0 + t) * 16, LDB);
      wmma::mma_sync(acc[t], a, b, acc[t]);
    }
  }
}

template <int HD>
__device__ __forceinline__ void tc_store(float* O, const FragC* acc) {
  constexpr int LDO = Tc<HD>::LDO, OT = Tc<HD>::OT;
  const int w = threadIdx.x >> 5, tr = w >> 1, tc0 = (w & 1) * OT;
#pragma unroll
  for (int t = 0; t < OT; ++t)
    wmma::store_matrix_sync(O + tr * 16 * LDO + (tc0 + t) * 16, acc[t], LDO,
                            wmma::mem_row_major);
}

// rows row0 .. of the fp32 [64][HD] tile O (ld LDO) to the bf16 rows of a
// contiguous [.., HD] output with row stride `rs`; rows >= limit skipped
template <int HD>
__device__ __forceinline__ void write_rows(__nv_bfloat16* out,
                                           long long rs, const float* O,
                                           int row0, int limit) {
  constexpr int LDO = Tc<HD>::LDO;
  for (int idx = threadIdx.x; idx < 64 * HD; idx += NT) {
    const int r = idx / HD, c = idx % HD;
    if (row0 + r < limit)
      out[static_cast<long long>(row0 + r) * rs + c] =
          __float2bfloat16(O[r * LDO + c]);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_fwd_tc_kernel(Args a) {
  using L = Tc<HD>;
  constexpr int JO = HD / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qb = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Kb = Qb + 64 * L::LDB;
  __nv_bfloat16* Vb = Kb + 64 * L::LDB;
  float* Sf = reinterpret_cast<float*>(Vb + 64 * L::LDB);
  __nv_bfloat16* Pb = reinterpret_cast<__nv_bfloat16*>(Sf + 64 * L::LDS);
  float* Of = reinterpret_cast<float*>(Pb + 64 * L::LDPB);
  int* qseg_s = reinterpret_cast<int*>(Of + 64 * L::LDO);
  int* kseg_s = qseg_s + 64;

  const int nq = (a.SQ + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.HK);
  const int offset = a.SK - a.SQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool vec = a.vec != 0;

  using bf = __nv_bfloat16;
  const bf* qb = static_cast<const bf*>(a.q) + b * a.qsb + h * a.qsh;
  const bf* kb = static_cast<const bf*>(a.k) + b * a.ksb + hk * a.ksh;
  const bf* vb = static_cast<const bf*>(a.v) + b * a.vsb + hk * a.vsh;
  load_tile_bf16<HD>(Qb, qb, a.qss, q0, a.SQ, vec);
  if (a.qseg != nullptr) load_seg(qseg_s, a.qseg + b * a.SQ, q0, a.SQ);

  float m[4], l[4], alpha[4], acc[4][JO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < JO; ++jj) acc[i][jj] = 0.f;
  }

  const int k_end = a.causal ? min(a.SK, q0 + BQ + offset) : a.SK;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K, V, P and PV are consumed
    load_tile_bf16<HD>(Kb, kb, a.kss, k0, a.SK, vec);
    load_tile_bf16<HD>(Vb, vb, a.vss, k0, a.SK, vec);
    if (a.qseg != nullptr) load_seg(kseg_s, a.kseg + b * a.SK, k0, a.SK);
    __syncthreads();
    tc_abt<HD>(Sf, Qb, Kb);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qpos = q0 + r;
      float s[4], mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        s[j] = allowed(a, qpos, k0 + c, offset, qseg_s, kseg_s, r, c)
                   ? Sf[r * L::LDS + c] * a.scale
                   : NEG_INF;
        mx = fmaxf(mx, s[j]);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float p = s[j] <= NEG_INF * 0.5f ? 0.f : expf(s[j] - m_new);
        ps += p;
        if (a.dropout)
          p = dropout_keep(a, b, h, qpos, k0 + c) ? p / a.keep_div : 0.f;
        Pb[r * L::LDPB + c] = __float2bfloat16(p);
      }
      ps = row_sum16(ps);
      l[i] = alpha[i] * l[i] + ps;
      m[i] = m_new;
    }
    __syncthreads();
    {
      FragC pv[L::OT];
#pragma unroll
      for (int t = 0; t < L::OT; ++t) wmma::fill_fragment(pv[t], 0.f);
      tc_pv<HD, false>(pv, Pb, Vb);
      tc_store<HD>(Of, pv);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < JO; ++jj)
        acc[i][jj] = acc[i][jj] * alpha[i] +
                     Of[(ty * 4 + i) * L::LDO + tx + 16 * jj];
  }

  bf* out = static_cast<bf*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= a.SQ) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    const long long row = (static_cast<long long>(b) * a.SQ + qpos) * a.H + h;
#pragma unroll
    for (int jj = 0; jj < JO; ++jj)
      out[row * HD + tx + 16 * jj] = __float2bfloat16(acc[i][jj] / safe_l);
    if (tx == 0)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.SQ + qpos] =
          m[i] + logf(safe_l);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dq_tc_kernel(Args a) {
  using L = Tc<HD>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qb = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOb = Qb + 64 * L::LDB;
  __nv_bfloat16* Kb = dOb + 64 * L::LDB;
  __nv_bfloat16* Vb = Kb + 64 * L::LDB;
  float* Sf = reinterpret_cast<float*>(Vb + 64 * L::LDB);
  float* dPf = Sf + 64 * L::LDS;
  __nv_bfloat16* DSb = reinterpret_cast<__nv_bfloat16*>(dPf + 64 * L::LDS);
  float* Of = reinterpret_cast<float*>(DSb + 64 * L::LDPB);
  int* qseg_s = reinterpret_cast<int*>(Of + 64 * L::LDO);
  int* kseg_s = qseg_s + 64;

  const int nq = (a.SQ + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.HK);
  const int offset = a.SK - a.SQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool vec = a.vec != 0;

  using bf = __nv_bfloat16;
  const bf* qb = static_cast<const bf*>(a.q) + b * a.qsb + h * a.qsh;
  const bf* kb = static_cast<const bf*>(a.k) + b * a.ksb + hk * a.ksh;
  const bf* vb = static_cast<const bf*>(a.v) + b * a.vsb + hk * a.vsh;
  const long long dos = static_cast<long long>(a.H) * HD;
  const bf* dob = static_cast<const bf*>(a.dout) +
                  static_cast<long long>(b) * a.SQ * dos + h * HD;
  load_tile_bf16<HD>(Qb, qb, a.qss, q0, a.SQ, vec);
  load_tile_bf16<HD>(dOb, dob, dos, q0, a.SQ, vec);
  if (a.qseg != nullptr) load_seg(qseg_s, a.qseg + b * a.SQ, q0, a.SQ);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    const long long at = (static_cast<long long>(b) * a.H + h) * a.SQ + qpos;
    lse_r[i] = qpos < a.SQ ? a.lse_in[at] : 0.f;
    delta_r[i] = qpos < a.SQ ? a.delta[at] : 0.f;
  }

  FragC dq[L::OT];
#pragma unroll
  for (int t = 0; t < L::OT; ++t) wmma::fill_fragment(dq[t], 0.f);

  const int k_end = a.causal ? min(a.SK, q0 + BQ + offset) : a.SK;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile_bf16<HD>(Kb, kb, a.kss, k0, a.SK, vec);
    load_tile_bf16<HD>(Vb, vb, a.vss, k0, a.SK, vec);
    if (a.qseg != nullptr) load_seg(kseg_s, a.kseg + b * a.SK, k0, a.SK);
    __syncthreads();
    tc_abt<HD>(Sf, Qb, Kb);
    tc_abt<HD>(dPf, dOb, Vb);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        const float sv =
            allowed(a, qpos, kpos, offset, qseg_s, kseg_s, r, c)
                ? Sf[r * L::LDS + c] * a.scale
                : NEG_INF;
        const float p = sv <= NEG_INF * 0.5f ? 0.f : expf(sv - lse_r[i]);
        float dpv = dPf[r * L::LDS + c];
        if (a.dropout)
          dpv = dropout_keep(a, b, h, qpos, kpos) ? dpv / a.keep_div : 0.f;
        DSb[r * L::LDPB + c] =
            __float2bfloat16(p * (dpv - delta_r[i]) * a.scale);
      }
    }
    __syncthreads();
    tc_pv<HD, false>(dq, DSb, Kb);
  }

  tc_store<HD>(Of, dq);
  __syncthreads();
  write_rows<HD>(static_cast<bf*>(a.dq) +
                     static_cast<long long>(b) * a.SQ * dos + h * HD,
                 dos, Of, q0, a.SQ);
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_tc_kernel(Args a) {
  using L = Tc<HD>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Kb = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vb = Kb + 64 * L::LDB;
  __nv_bfloat16* Qb = Vb + 64 * L::LDB;
  __nv_bfloat16* dOb = Qb + 64 * L::LDB;
  float* Sf = reinterpret_cast<float*>(dOb + 64 * L::LDB);
  float* dPf = Sf + 64 * L::LDS;
  __nv_bfloat16* Pb = reinterpret_cast<__nv_bfloat16*>(dPf + 64 * L::LDS);
  __nv_bfloat16* DSb = Pb + 64 * L::LDPB;
  float* Of = reinterpret_cast<float*>(DSb + 64 * L::LDPB);
  float* lse_s = Of + 64 * L::LDO;
  float* delta_s = lse_s + 64;
  int* qseg_s = reinterpret_cast<int*>(delta_s + 64);
  int* kseg_s = qseg_s + 64;

  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / a.HK, hk = bh % a.HK;
  const int group = a.H / a.HK;
  const int nq = (a.SQ + BQ - 1) / BQ;
  const int offset = a.SK - a.SQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool vec = a.vec != 0;

  using bf = __nv_bfloat16;
  const bf* kb = static_cast<const bf*>(a.k) + b * a.ksb + hk * a.ksh;
  const bf* vb = static_cast<const bf*>(a.v) + b * a.vsb + hk * a.vsh;
  load_tile_bf16<HD>(Kb, kb, a.kss, k0, a.SK, vec);
  load_tile_bf16<HD>(Vb, vb, a.vss, k0, a.SK, vec);
  if (a.qseg != nullptr) load_seg(kseg_s, a.kseg + b * a.SK, k0, a.SK);
  const long long dos = static_cast<long long>(a.H) * HD;

  FragC dk[L::OT], dv[L::OT];
#pragma unroll
  for (int t = 0; t < L::OT; ++t) {
    wmma::fill_fragment(dk[t], 0.f);
    wmma::fill_fragment(dv[t], 0.f);
  }

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const bf* qb = static_cast<const bf*>(a.q) + b * a.qsb + h * a.qsh;
    const bf* dob = static_cast<const bf*>(a.dout) +
                    static_cast<long long>(b) * a.SQ * dos + h * HD;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      if (a.causal && q0 + BQ - 1 + offset < k0) continue;
      __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
      load_tile_bf16<HD>(Qb, qb, a.qss, q0, a.SQ, vec);
      load_tile_bf16<HD>(dOb, dob, dos, q0, a.SQ, vec);
      if (a.qseg != nullptr) load_seg(qseg_s, a.qseg + b * a.SQ, q0, a.SQ);
      for (int i = threadIdx.x; i < BQ; i += NT) {
        const int qpos = q0 + i;
        const long long at =
            (static_cast<long long>(b) * a.H + h) * a.SQ + qpos;
        lse_s[i] = qpos < a.SQ ? a.lse_in[at] : 0.f;
        delta_s[i] = qpos < a.SQ ? a.delta[at] : 0.f;
      }
      __syncthreads();
      tc_abt<HD>(Sf, Qb, Kb);
      tc_abt<HD>(dPf, dOb, Vb);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i, qpos = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, kpos = k0 + c;
          const float sv =
              allowed(a, qpos, kpos, offset, qseg_s, kseg_s, r, c)
                  ? Sf[r * L::LDS + c] * a.scale
                  : NEG_INF;
          const float p = sv <= NEG_INF * 0.5f ? 0.f : expf(sv - lse_s[r]);
          float pd = p, dpv = dPf[r * L::LDS + c];
          if (a.dropout) {
            const bool keep = dropout_keep(a, b, h, qpos, kpos);
            pd = keep ? p * a.keep_mul : 0.f;
            dpv = keep ? dpv * a.keep_mul : 0.f;
          }
          Pb[r * L::LDPB + c] = __float2bfloat16(pd);
          DSb[r * L::LDPB + c] =
              __float2bfloat16(p * (dpv - delta_s[r]) * a.scale);
        }
      }
      __syncthreads();
      tc_pv<HD, true>(dv, Pb, dOb);
      tc_pv<HD, true>(dk, DSb, Qb);
    }
  }

  const long long ks = static_cast<long long>(a.HK) * HD;
  bf* dkp = static_cast<bf*>(a.dk) + static_cast<long long>(b) * a.SK * ks +
            hk * HD;
  bf* dvp = static_cast<bf*>(a.dv) + static_cast<long long>(b) * a.SK * ks +
            hk * HD;
  tc_store<HD>(Of, dk);
  __syncthreads();
  write_rows<HD>(dkp, ks, Of, k0, a.SK);
  __syncthreads();
  tc_store<HD>(Of, dv);
  __syncthreads();
  write_rows<HD>(dvp, ks, Of, k0, a.SK);
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

// fp32: the FMA kernels; bf16: the tensor-core kernels
template <int HD>
cudaError_t run(int which, int dtype, const Args& a, cudaStream_t stream) {
  const int nq = (a.SQ + BQ - 1) / BQ, nk = (a.SK + BK - 1) / BK;
  const dim3 gq(nq, a.B * a.H), gk(nk, a.B * a.HK);
  if (dtype == 0) {
    if (which == 0)
      return launch(flash_fwd_kernel<HD>, gq, fwd_smem<HD>(), a,
                    stream);
    if (which == 1)
      return launch(flash_bwd_dq_kernel<HD>, gq, dq_smem<HD>(), a,
                    stream);
    return launch(flash_bwd_dkv_kernel<HD>, gk, dkv_smem<HD>(), a,
                  stream);
  }
  if (which == 0)
    return launch(flash_fwd_tc_kernel<HD>, gq, Tc<HD>::fwd, a, stream);
  if (which == 1)
    return launch(flash_bwd_dq_tc_kernel<HD>, gq, Tc<HD>::dq, a, stream);
  return launch(flash_bwd_dkv_tc_kernel<HD>, gk, Tc<HD>::dkv, a, stream);
}

cudaError_t run_d(int which, int dtype, int D, const Args& a,
                  cudaStream_t stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
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
             float keep_div, float keep_mul, int vec, int dtype,
             void* stream) {
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
  a.vec = vec;
  return static_cast<int>(
      run_d(which, dtype, D, a, static_cast<cudaStream_t>(stream)));
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
      unsigned int threshold, float keep_div, float keep_mul, int vec,      \
      int dtype, void *stream
#define PT_FLASH_ARGS                                                        \
  q, k, v, dout, qseg, kseg, lse_in, delta, out, lse, dq, dk, dv, B, H, HK,  \
      SQ, SK, D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, scale, causal, \
      dropout, seed, threshold, keep_div, keep_mul, vec, dtype, stream

// The three entry points share one argument list (pointers a kernel does
// not use may be null).
extern "C" int pt_flash_fwd(PT_FLASH_PARAMS) {
  return dispatch(0, PT_FLASH_ARGS);
}
extern "C" int pt_flash_bwd_dq(PT_FLASH_PARAMS) {
  return dispatch(1, PT_FLASH_ARGS);
}
extern "C" int pt_flash_bwd_dkv(PT_FLASH_PARAMS) {
  return dispatch(2, PT_FLASH_ARGS);
}
