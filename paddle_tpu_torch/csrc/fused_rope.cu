// Rotary position embedding (neox half-split form) of q and k in one
// launch, for Hopper.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_rope.py
// `_rope_kernel` (called from `fused_rope_pallas`). For each token
// (b, s) at position p = positions[b, s] (or s when no positions are
// given), with x1/x2 the halves of a head's row and c/s the fp32 cos/sin
// rows of the table at p:
//   o1 = x1 * c1 - x2 * s1,   o2 = x2 * c2 + x1 * s2     (fp32)
// The same kernel serves prefill (contiguous positions), decode
// (per-row positions; on the TPU the decode form stayed an XLA
// composite) and the backward (the table -sin: R(theta)^T = R(-theta)).
// q and k are usually strided views of the fused qkv projection, so the
// kernel takes each tensor's batch, sequence and head strides and reads
// them in place; outputs are contiguous [b, s, heads, d]. Positions
// outside the table are clamped, as a JAX gather clamps.
//
// What bounds it, at the shapes the models launch (32 q / 8 k heads for
// Llama, 16 / 16 for DeepSeekMoE, d = 128): at decode (8 tokens) latency:
// 160 KB of q and k take 0.05 us of the card's bandwidth, so the time is
// the launch and one trip to memory; at prefill (128..1536 tokens) and
// in training (2 x 4096 tokens, forward and backward) bytes: q and k are
// read and written once, three operations an element. The design
// (`rope_vec_kernel`, the "vec" route):
// - a thread owns a fixed 8-column slice of the half width; it loads
//   that slice's cos and sin (both halves, fp32) once into registers,
//   then a group of HG heads with one 16-byte load of x1 and one of x2
//   each, all the group's loads issued before any arithmetic, and no
//   integer division in the loop over the heads;
// - the wrapper's plan (ops/kernels/fused_rope.py `plan`) picks HG from
//   the shape: one head a thread at decode, so that every load of the
//   step is in flight at once (8 tokens x 40 heads x 8 slices = 2,560
//   threads), up to 4 (bf16) or 2 (fp32) when there are threads enough
//   to fill the card, which also cuts the re-reads of the table (more
//   heads would cost registers: fused_rope.py MAX_HEADS); blocks walk
//   (token, head group) units a grid apart;
// - d not a multiple of 16, or views not 16-byte aligned, take the
//   "scalar" route (`rope_scalar_kernel`: one block a token, one element
//   pair a thread).
// No atomics: the same bits each run.

#include "common.cuh"

namespace {

template <typename T>
__global__ void rope_scalar_kernel(const T* __restrict__ q,
                                   const T* __restrict__ k,
                                   T* __restrict__ qo, T* __restrict__ ko,
                                   const float* __restrict__ cos_t,
                                   const float* __restrict__ sin_t,
                                   const long long* __restrict__ positions,
                                   int S, int H, int HK, int D, long long qsb,
                                   long long qss, long long qsh,
                                   long long ksb, long long kss,
                                   long long ksh, int max_pos) {
  const long long token = blockIdx.x;
  const long long b = token / S, s = token % S;
  long long p = positions != nullptr ? positions[token] : s;
  p = p < 0 ? 0 : (p >= max_pos ? max_pos - 1 : p);
  const float* c = cos_t + p * D;
  const float* sn = sin_t + p * D;
  const int half = D / 2;
  const int total = (H + HK) * half;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int head = i / half, j = i - head * half;
    const T* x;
    T* o;
    if (head < H) {
      x = q + b * qsb + s * qss + head * qsh;
      o = qo + (token * H + head) * D;
    } else {
      const int hh = head - H;
      x = k + b * ksb + s * kss + hh * ksh;
      o = ko + (token * HK + hh) * D;
    }
    const float x1 = pt::to_f(x[j]), x2 = pt::to_f(x[j + half]);
    o[j] = pt::from_f<T>(x1 * c[j] - x2 * sn[j]);
    o[j + half] = pt::from_f<T>(x2 * c[j + half] + x1 * sn[j + half]);
  }
}

// The vec route. A unit is (token, group of HG heads) of the H + HK
// heads taken in order (q first); `slices` = D / 16 threads share a unit,
// thread `sl` owning columns [8 sl, 8 sl + 8) of each half. The block's
// threads are units_per_block x slices; blocks walk units a grid apart.
template <typename T, int HG>
__global__ void __launch_bounds__(256)
    rope_vec_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    T* __restrict__ qo, T* __restrict__ ko,
                    const float* __restrict__ cos_t,
                    const float* __restrict__ sin_t,
                    const long long* __restrict__ positions, int units,
                    int groups, int S, int H, int HK, int D, int slices,
                    long long qsb, long long qss, long long qsh,
                    long long ksb, long long kss, long long ksh,
                    int max_pos) {
  const int upb = blockDim.x / slices;
  const int ub = threadIdx.x / slices;
  const int col = (threadIdx.x - ub * slices) * 8;
  const int half = D / 2;
  const int nh = H + HK;
  for (int u = blockIdx.x * upb + ub; u < units; u += gridDim.x * upb) {
    const int token = u / groups;
    const int h0 = (u - token * groups) * HG;
    const int b = token / S, s = token - b * S;
    long long p = positions != nullptr ? positions[token] : s;
    p = p < 0 ? 0 : (p >= max_pos ? max_pos - 1 : p);
    const float* c = cos_t + p * D + col;
    const float* sn = sin_t + p * D + col;
    const T* qx = q + b * qsb + s * qss + col;
    const T* kx = k + b * ksb + s * kss + col;
    pt::Vec8<T> x1[HG], x2[HG];
#pragma unroll
    for (int i = 0; i < HG; ++i) {
      const int hh = h0 + i;
      if (hh < nh) {
        const T* xp = hh < H ? qx + hh * qsh : kx + (hh - H) * ksh;
        x1[i].load(xp);
        x2[i].load(xp + half);
      }
    }
    float c1[8], c2[8], s1[8], s2[8];
    pt::load8(c, c1);
    pt::load8(c + half, c2);
    pt::load8(sn, s1);
    pt::load8(sn + half, s2);
    T* qy = qo + static_cast<long long>(token) * H * D + col;
    T* ky = ko + static_cast<long long>(token) * HK * D + col;
#pragma unroll
    for (int i = 0; i < HG; ++i) {
      const int hh = h0 + i;
      if (hh < nh) {
        float a[8], bb[8], o1[8], o2[8];
        x1[i].get(a);
        x2[i].get(bb);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          o1[e] = a[e] * c1[e] - bb[e] * s1[e];
          o2[e] = bb[e] * c2[e] + a[e] * s2[e];
        }
        T* op = hh < H ? qy + hh * D : ky + (hh - H) * D;
        pt::store8(op, o1);
        pt::store8(op + half, o2);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, void* qo, void* ko,
                   const float* c, const float* s, const long long* pos,
                   int B, int S, int H, int HK, int D, long long qsb,
                   long long qss, long long qsh, long long ksb, long long kss,
                   long long ksh, int max_pos, int route, int hg, int blocks,
                   int threads, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  T* qop = static_cast<T*>(qo);
  T* kop = static_cast<T*>(ko);
  if (route == 0) {
    if (blocks != B * S || threads < 32 || threads > 1024)
      return cudaErrorInvalidValue;
    rope_scalar_kernel<T><<<blocks, threads, 0, stream>>>(
        qp, kp, qop, kop, c, s, pos, S, H, HK, D, qsb, qss, qsh, ksb, kss,
        ksh, max_pos);
    return cudaGetLastError();
  }
  const int slices = D / 16;
  if (route != 1 || D % 16 != 0 || threads > 256 || threads % slices)
    return cudaErrorInvalidValue;
  const int groups = (H + HK + hg - 1) / hg;
  const int units = B * S * groups;
#define PT_ROPE_VEC(G)                                                     \
  rope_vec_kernel<T, G><<<blocks, threads, 0, stream>>>(                  \
      qp, kp, qop, kop, c, s, pos, units, groups, S, H, HK, D, slices, qsb, \
      qss, qsh, ksb, kss, ksh, max_pos)
  // the group sizes the plan can pick (fused_rope.py MAX_HEADS: 4 bf16
  // heads, 2 fp32)
  switch (hg) {
    case 1: PT_ROPE_VEC(1); break;
    case 2: PT_ROPE_VEC(2); break;
    case 4:
      if constexpr (sizeof(T) == 2) {
        PT_ROPE_VEC(4);
        break;
      }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
#undef PT_ROPE_VEC
  return cudaGetLastError();
}

}  // namespace

// route: 0 scalar, 1 vec; hg (heads a thread), blocks and threads are
// the wrapper's plan (ops/kernels/fused_rope.py `plan`)
extern "C" int pt_fused_rope(const void* q, const void* k, void* qo,
                             void* ko, const void* cos_t, const void* sin_t,
                             const void* positions, int B, int S, int H,
                             int HK, int D, long long qsb, long long qss,
                             long long qsh, long long ksb, long long kss,
                             long long ksh, int max_pos, int dtype, int route,
                             int hg, int blocks, int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  const long long* pos = static_cast<const long long*>(positions);
  if (dtype == 0)
    return launch<float>(q, k, qo, ko, c, s, pos, B, S, H, HK, D, qsb, qss,
                         qsh, ksb, kss, ksh, max_pos, route, hg, blocks,
                         threads, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, qo, ko, c, s, pos, B, S, H, HK, D,
                                 qsb, qss, qsh, ksb, kss, ksh, max_pos, route,
                                 hg, blocks, threads, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
