// Rotary position embedding (neox half-split form) of q and k in one
// launch, for Hopper.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_rope.py
// `_rope_kernel` (called from `fused_rope_pallas`). For each token
// (b, s) at position p = positions[b, s] (or s when no positions are
// given), with x1/x2 the halves of a head's row and c/s the fp32 cos/sin
// rows of the table at p:
//   o1 = x1 * c1 - x2 * s1,   o2 = x2 * c2 + x1 * s2     (fp32)
// The same kernel serves prefill (contiguous positions) and decode
// (per-row positions); on the TPU the decode form stayed an XLA
// composite.
//
// Bound: bytes. q and k are read once and written once; cos/sin rows are
// read once per token for all its heads. Design: one block per token;
// its threads walk the (heads x half-width) pairs with neighbouring
// threads on neighbouring elements. q and k are usually strided views of
// the fused qkv projection, so the kernel takes each tensor's batch,
// sequence and head strides and reads them in place; outputs are
// contiguous [b, s, heads, d]. Positions outside the table are clamped,
// as a JAX gather clamps.

#include "common.cuh"

namespace {

template <typename T>
__global__ void rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            T* __restrict__ qo, T* __restrict__ ko,
                            const float* __restrict__ cos_t,
                            const float* __restrict__ sin_t,
                            const long long* __restrict__ positions, int S,
                            int H, int HK, int D, long long qsb,
                            long long qss, long long qsh, long long ksb,
                            long long kss, long long ksh, int max_pos) {
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

template <typename T>
cudaError_t launch(const void* q, const void* k, void* qo, void* ko,
                   const float* c, const float* s, const long long* pos,
                   int B, int S, int H, int HK, int D, long long qsb,
                   long long qss, long long qsh, long long ksb, long long kss,
                   long long ksh, int max_pos, cudaStream_t stream) {
  const int pairs = (H + HK) * (D / 2);
  int threads = ((pairs + 31) / 32) * 32;
  threads = threads > 256 ? 256 : threads;
  rope_kernel<T><<<B * S, threads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<T*>(qo),
      static_cast<T*>(ko), c, s, pos, S, H, HK, D, qsb, qss, qsh, ksb, kss,
      ksh, max_pos);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pt_fused_rope(const void* q, const void* k, void* qo,
                             void* ko, const void* cos_t, const void* sin_t,
                             const void* positions, int B, int S, int H,
                             int HK, int D, long long qsb, long long qss,
                             long long qsh, long long ksb, long long kss,
                             long long ksh, int max_pos, int dtype,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  const long long* pos = static_cast<const long long*>(positions);
  if (dtype == 0)
    return launch<float>(q, k, qo, ko, c, s, pos, B, S, H, HK, D, qsb, qss,
                         qsh, ksb, kss, ksh, max_pos, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, qo, ko, c, s, pos, B, S, H, HK, D,
                                 qsb, qss, qsh, ksb, kss, ksh, max_pos, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
